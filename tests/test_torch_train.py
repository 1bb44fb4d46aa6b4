"""The port's training path against the JAX package's, on the CPU.

Weights and states are drawn by the reference, flattened to numpy by
path and carried across with :mod:`repro_torch.models.interop`; batches
come from numpy seeds.  The reference's steps run jitted, its attention
through its custom VJP (``layers._flash_train``); the port's attention
runs ``FlashAttentionFn``'s CPU route (the plain forward with ``lse``,
then the plain backward).

Tolerances, all float32:

* attention: out and ``lse`` ``rtol=1e-5, atol=1e-6``; dq, dk, dv
  ``rtol=1e-4, atol=1e-5`` (blockwise sums in another order);
* a train step's loss and gradient norm ``rtol=1e-5``.  With int8
  gradient compression the gradient norm is held to ``rtol=1e-4``: an
  element whose scaled gradient sits within an ulp of a rounding
  boundary can land one int8 level apart (of ~127), which moves the norm
  by ~1e-5;
* params after 3 steps: AdamW moves an element by at most about
  ``lr_t`` a step (``m / sqrt(v)`` is at most ~1 in magnitude), so the
  test derives its bound from the schedule: ``1e-3 * sum(lr_t)`` for
  the uncompressed steps;
* a GNN's forward and its losses ``rtol=1e-5, atol=1e-6``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.utils._python_dispatch
import torch.utils.checkpoint

from repro.configs import registry as jregistry
from repro.data import graphs as jgraphs
from repro.models import gnn as jgnn
from repro.models import layers as jlayers
from repro.models import sasrec as jsasrec
from repro.models import transformer as jtransformer
from repro.train import checkpoint as jcheckpoint
from repro.train import optimizer as jopt
from repro.train import steps as jsteps
from repro_torch.configs import registry
from repro_torch.data import graphs
from repro_torch.kernels import flash_attention as FA
from repro_torch.models import gnn, interop, sasrec, transformer
from repro_torch.train import checkpoint
from repro_torch.train import optimizer as opt
from repro_torch.train import steps


def _flatten(tree) -> dict:
    leaves, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {"/".join(k.key for k in path): np.asarray(a) for path, a in leaves}


def _leaf(tree, path):
    for k in path.split("/"):
        tree = tree[k]
    return tree


def _max_param_diff(params, jparams) -> float:
    return max(float(np.abs(_leaf(params, p).float().numpy() - a).max())
               for p, a in _flatten(jparams).items())


# ---------------------------------------------------------------------------
# attention: FlashAttentionFn against jax.vjp of the reference
# ---------------------------------------------------------------------------

# (B, Tq, H, KV, D, causal, block_q, block_kv): GQA, ragged blocks
ATTN_CASES = [
    (2, 37, 4, 2, 16, True, 16, 8),
    (1, 20, 2, 1, 50, False, 8, 16),
    (2, 33, 6, 3, 50, True, 64, 64),
    (1, 29, 4, 4, 16, False, 8, 8),
]


@pytest.mark.parametrize("case", ATTN_CASES)
def test_flash_attention_fn_matches_reference_vjp(case):
    B, T, H, KV, D, causal, bq, bkv = case
    rng = np.random.default_rng(T + D)
    q, do = (rng.standard_normal((B, T, H, D)).astype(np.float32) for _ in range(2))
    k, v = (rng.standard_normal((B, T, KV, D)).astype(np.float32) for _ in range(2))

    def f(a, b, c):
        return jlayers.flash_attention(a, b, c, causal=causal, block_q=bq, block_kv=bkv)

    want, vjp = jax.vjp(f, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    wants = vjp(jnp.asarray(do))
    _, want_lse = jlayers._flash_impl(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal,
                                      0, None, bq, bkv, return_lse=True)
    leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    out = FA.flash_attention(*leaves, causal=causal, block_q=bq, block_kv=bkv)
    assert out.grad_fn is not None and type(out.grad_fn).__name__ == "FlashAttentionFnBackward"
    out.backward(torch.from_numpy(do))
    _, lse = FA.flash_attention_plain(*(t.detach() for t in leaves), causal=causal,
                                      block_q=bq, block_kv=bkv, return_lse=True)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse).reshape(B, T, H),
                               rtol=1e-5, atol=1e-6)
    for t, w in zip(leaves, wants):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), rtol=1e-4, atol=1e-5)


def test_lse_is_inf_on_fully_masked_rows():
    rng = np.random.default_rng(0)
    q = torch.from_numpy(rng.standard_normal((2, 3, 2, 8)).astype(np.float32))
    k = torch.from_numpy(rng.standard_normal((2, 5, 1, 8)).astype(np.float32))
    out, lse = FA.flash_attention_plain(q, k, k, causal=False,
                                        kv_length=torch.tensor([0, 5]), return_lse=True)
    assert torch.isinf(lse[0]).all() and bool((lse[0] > 0).all())
    assert torch.isfinite(lse[1]).all() and float(out[0].abs().max()) == 0.0


def test_requires_grad_cache_call_raises():
    q = torch.zeros((1, 2, 2, 8), requires_grad=True)
    k = torch.zeros((1, 6, 1, 8))
    with pytest.raises(ValueError, match="no backward"):
        FA.flash_attention(q, k, k, q_offset=4)
    with pytest.raises(ValueError, match="no backward"):
        FA.flash_attention(q, k, k, kv_length=torch.tensor([6]))
    with torch.no_grad():   # serving: the cache path, no autograd
        assert FA.flash_attention(q, k, k, q_offset=4).grad_fn is None


# ---------------------------------------------------------------------------
# LM train step
# ---------------------------------------------------------------------------

LR = (3e-3, 1, 100)   # cosine_schedule(base, warmup, total): lr_0 = 0


def _lm_cfgs(**kw):
    kw = dict(dtype="float32", attn_block_q=8, attn_block_kv=16, **kw)
    return (dataclasses.replace(jregistry.get_arch("glm4-9b").SMOKE, **kw),
            dataclasses.replace(registry.get_arch("glm4-9b").SMOKE, **kw))


def _lm_batches(vocab, n=3, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        toks = rng.integers(0, vocab, (4, 33))
        out.append({"tokens": toks[:, :-1].astype(np.int32),
                    "labels": toks[:, 1:].astype(np.int32)})
    return out


@pytest.fixture(scope="module")
def lm_reference():
    """The reference's params and 3 steps per variant, once."""
    runs = {}
    for mb, remat, compress in [(1, "none", False), (2, "full", False), (2, "none", False),
                                (1, "none", True)]:
        jcfg, cfg = _lm_cfgs(microbatches=mb, remat_policy=remat)
        jparams = jtransformer.init_params(jax.random.PRNGKey(0), jcfg)
        arrays = _flatten(jparams)
        jo = jopt.adamw(jopt.cosine_schedule(*LR))
        jstate = jsteps.init_train_state(jparams, jo)
        jstep = jax.jit(jsteps.build_lm_train_step(jcfg, jo, compress_grads=compress))
        metrics = []
        for b in _lm_batches(cfg.vocab_size):
            jstate, m = jstep(jstate, {k: jnp.asarray(v) for k, v in b.items()})
            metrics.append((float(m["loss"]), float(m["grad_norm"])))
        runs[(mb, remat, compress)] = (arrays, metrics, jstate["params"])
    return runs


@pytest.mark.parametrize("mb,remat,compress", [(1, "none", False), (2, "full", False),
                                               (2, "none", False), (1, "none", True)],
                         ids=["plain", "microbatches2_remat", "microbatches2", "compress"])
def test_lm_train_step_matches_reference(lm_reference, mb, remat, compress):
    arrays, want, jparams = lm_reference[(mb, remat, compress)]
    _, cfg = _lm_cfgs(microbatches=mb, remat_policy=remat)
    o = opt.adamw(opt.cosine_schedule(*LR))
    params = interop.transformer_params_from_arrays(arrays, cfg, "cpu", torch.float32)
    state = steps.init_train_state(params, o)
    step = steps.build_lm_train_step(cfg, o, compress_grads=compress)
    got = []
    for b in _lm_batches(cfg.vocab_size):
        state, m = step(state, {k: torch.from_numpy(v) for k, v in b.items()})
        got.append((float(m["loss"]), float(m["grad_norm"])))
    assert int(state["step"]) == 3
    for (loss, gn), (jloss, jgn) in zip(got, want):
        assert loss == pytest.approx(jloss, rel=1e-5)
        assert gn == pytest.approx(jgn, rel=1e-4 if compress else 1e-5)
    lr_sum = sum(float(jopt.cosine_schedule(*LR)(s)) for s in range(3))
    bound = (2.0 if compress else 1e-3) * lr_sum
    assert _max_param_diff(state["params"], jparams) <= bound
    if compress:
        assert set(state["grad_err"]) == set(state["params"])


def test_lm_remat_equals_no_remat(lm_reference):
    """Recomputing each layer in the backward changes nothing: the same
    losses, norms and params bit for bit, with microbatches=2."""
    results = []
    for remat in ("none", "full"):
        arrays = lm_reference[(2, remat, False)][0]
        _, cfg = _lm_cfgs(microbatches=2, remat_policy=remat)
        o = opt.adamw(opt.cosine_schedule(*LR))
        state = steps.init_train_state(
            interop.transformer_params_from_arrays(arrays, cfg, "cpu", torch.float32), o)
        step = steps.build_lm_train_step(cfg, o)
        ms = []
        for b in _lm_batches(cfg.vocab_size):
            state, m = step(state, {k: torch.from_numpy(v) for k, v in b.items()})
            ms.append((float(m["loss"]), float(m["grad_norm"])))
        results.append((ms, state["params"]))
    assert results[0][0] == results[1][0]
    for p, a in _flatten(lm_reference[(2, "none", False)][2]).items():
        assert torch.equal(_leaf(results[0][1], p), _leaf(results[1][1], p)), p


def test_attention_weights_get_the_reference_gradients():
    """K4's training route carries the gradient to wq, wk and wv: the
    port's gradients of every weight equal ``jax.grad`` of the reference's
    ``lm_loss``."""
    jcfg, cfg = _lm_cfgs()
    jparams = jtransformer.init_params(jax.random.PRNGKey(1), jcfg)
    b = _lm_batches(cfg.vocab_size, 1, seed=5)[0]
    jgrads = jax.grad(lambda p: jsteps.lm_loss(p, {k: jnp.asarray(v) for k, v in b.items()},
                                               jcfg)[0])(jparams)
    params = interop.transformer_params_from_arrays(_flatten(jparams), cfg, "cpu",
                                                    torch.float32)
    leaves = {p: _leaf(params, p).requires_grad_() for p in _flatten(jparams)}
    loss, _ = steps.lm_loss(params, {k: torch.from_numpy(v) for k, v in b.items()}, cfg)
    loss.backward()
    for p, want in _flatten(jgrads).items():
        got = leaves[p].grad
        assert got is not None and float(got.abs().max()) > 0, p
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-4,
                                   atol=1e-5 * float(np.abs(want).max()), err_msg=p)


# ---------------------------------------------------------------------------
# SASRec
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def rec():
    jcfg = dataclasses.replace(jregistry.get_arch("sasrec").SMOKE, dtype="float32")
    cfg = dataclasses.replace(registry.get_arch("sasrec").SMOKE, dtype="float32")
    jparams = jsasrec.init_params(jax.random.PRNGKey(0), jcfg)
    return jcfg, cfg, jparams, _flatten(jparams)


def test_sasrec_train_loss_over_3_steps(rec):
    from repro.data.pipeline import sasrec_batches

    jcfg, cfg, jparams, arrays = rec
    jo, o = jopt.adamw(1e-3), opt.adamw(1e-3)
    jstate = jsteps.init_train_state(jparams, jo)
    jstep = jax.jit(jsteps.build_sasrec_train_step(jcfg, jo))
    state = steps.init_train_state(interop.sasrec_params_from_arrays(arrays, cfg, "cpu"), o)
    step = steps.build_sasrec_train_step(cfg, o)
    it = sasrec_batches(cfg.n_items, cfg.seq_len, 8, seed=3)
    for _ in range(3):
        b = next(it)
        jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in b.items()})
        state, m = step(state, {k: torch.from_numpy(v) for k, v in b.items()})
        assert float(m["loss"]) == pytest.approx(float(jm["loss"]), rel=1e-5)
        assert float(m["grad_norm"]) == pytest.approx(float(jm["grad_norm"]), rel=1e-5)
    assert _max_param_diff(state["params"], jstate["params"]) <= 1e-3 * 3e-3


def test_sasrec_scoring_matches_reference(rec):
    jcfg, cfg, jparams, arrays = rec
    params = interop.sasrec_params_from_arrays(arrays, cfg, "cpu")
    rng = np.random.default_rng(7)
    seqs = rng.integers(0, cfg.n_items, (12, cfg.seq_len)).astype(np.int32)
    seqs[:3, :5] = 0  # padded prefixes
    want = jsasrec.user_embedding(jparams, jnp.asarray(seqs), jcfg)
    got = sasrec.user_embedding(params, torch.from_numpy(seqs), cfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    for batch_chunk in (None, 4):
        js, ji = jsasrec.score_all(jparams, jnp.asarray(seqs), jcfg, top_k=7,
                                   batch_chunk=batch_chunk)
        s, i = sasrec.score_all(params, torch.from_numpy(seqs), cfg, top_k=7,
                                batch_chunk=batch_chunk)
        js, ji = np.asarray(js), np.asarray(ji)
        np.testing.assert_allclose(s.numpy(), js, rtol=1e-5, atol=1e-6)
        # ids agree wherever the scores around them are separated
        gap = np.minimum(np.abs(np.diff(js, axis=1, prepend=np.inf)),
                         np.abs(np.diff(js, axis=1, append=-np.inf)))
        sep = gap > 1e-5 * np.abs(js).max()
        assert sep.mean() > 0.9
        np.testing.assert_array_equal(i.numpy()[sep], ji[sep])
    cands = rng.integers(1, cfg.n_items, (12, 40))
    np.testing.assert_allclose(
        sasrec.score_candidates(params, torch.from_numpy(seqs), torch.from_numpy(cands),
                                cfg).numpy(),
        np.asarray(jsasrec.score_candidates(jparams, jnp.asarray(seqs), jnp.asarray(cands),
                                            jcfg)),
        rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# GNNs
# ---------------------------------------------------------------------------

def _gnn_inputs(kind, d_out):
    if kind in ("schnet", "dimenet"):
        jg = jgraphs.batch_molecules(4, 8, 20, d_feat=6, seed=1)
        g = graphs.batch_molecules(4, 8, 20, d_feat=6, seed=1, device="cpu")
        target = np.random.default_rng(2).standard_normal((4, d_out)).astype(np.float32)
    else:
        src, dst, feats, pos = jgraphs.random_graph(64, 200, 6, seed=1, with_positions=True)
        jg = jgraphs.graph_batch_from_numpy(src, dst, feats, positions=pos)
        g = graphs.graph_batch_from_numpy(src, dst, feats, positions=pos, device="cpu")
        target = np.random.default_rng(2).standard_normal((64, d_out)).astype(np.float32)
    return jg, g, target


@pytest.mark.parametrize("kind", ["meshgraphnet", "graphcast", "schnet", "dimenet"])
def test_gnn_forward_and_2_train_steps_match_reference(kind):
    jcfg = dataclasses.replace(jregistry.get_arch(kind).SMOKE, dtype="float32")
    cfg = dataclasses.replace(registry.get_arch(kind).SMOKE, dtype="float32")
    jg, g, target = _gnn_inputs(kind, cfg.d_out)
    jparams = jgnn.init_params(jax.random.PRNGKey(0), jcfg, d_in=6)
    params = interop.gnn_params_from_arrays(_flatten(jparams), cfg, 6, device="cpu")
    want = np.asarray(jgnn.forward(jparams, jg, jcfg))
    with torch.no_grad():
        got = gnn.forward(params, g, cfg)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6 * np.abs(want).max())
    jo, o = jopt.adamw(1e-3), opt.adamw(1e-3)
    jstate = jsteps.init_train_state(jparams, jo)
    jstep = jax.jit(jsteps.build_gnn_train_step(jcfg, jo))
    state = steps.init_train_state(params, o)
    step = steps.build_gnn_train_step(cfg, o)
    for _ in range(2):
        jstate, jm = jstep(jstate, {"graph": jg, "target": jnp.asarray(target)})
        state, m = step(state, {"graph": g, "target": torch.from_numpy(target)})
        assert float(m["loss"]) == pytest.approx(float(jm["loss"]), rel=1e-5, abs=1e-6)
        assert float(m["grad_norm"]) == pytest.approx(float(jm["grad_norm"]), rel=1e-5)


def test_gnn_remat_equals_no_remat():
    cfg = dataclasses.replace(registry.get_arch("schnet").SMOKE, dtype="float32")
    _, g, target = _gnn_inputs("schnet", cfg.d_out)
    out = []
    for remat in ("none", "full"):
        c = dataclasses.replace(cfg, remat_policy=remat)
        params = gnn.init_params(c, torch.Generator().manual_seed(0), 6, device="cpu")
        o = opt.adamw(1e-3)
        state, m = steps.build_gnn_train_step(c, o)(
            steps.init_train_state(params, o), {"graph": g, "target": torch.from_numpy(target)})
        out.append((float(m["loss"]), float(m["grad_norm"])))
    assert out[0] == out[1]


# ---------------------------------------------------------------------------
# remat keeps what the reference's policies keep
# ---------------------------------------------------------------------------

class _CountMatmuls(torch.utils._python_dispatch.TorchDispatchMode):
    """Counts ``mm`` / ``addmm`` calls (the reference's dots without batch
    dims) while active."""

    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
            self.n += 1
        return func(*args, **(kwargs or {}))


def _matmul_counts(loss_fn, params):
    """``(forward mm count, backward mm count, grads)`` of ``loss_fn``."""
    leaves = {"/".join(k): v.detach().requires_grad_() for k, v in opt.tree_paths(params)}
    tree = _nest(leaves)
    # without early stop a recompute runs its whole region, so a count
    # sees every mm that the policy does not keep
    with torch.utils.checkpoint.set_checkpoint_early_stop(False):
        with _CountMatmuls() as fwd:
            loss = loss_fn(tree)
        with _CountMatmuls() as bwd:
            grads = torch.autograd.grad(loss, list(leaves.values()), allow_unused=True)
    return fwd.n, bwd.n, dict(zip(leaves, grads))


def _nest(flat):
    out = {}
    for path, v in flat.items():
        node = out
        *head, last = path.split("/")
        for k in head:
            node = node.setdefault(k, {})
        node[last] = v
    return out


def _lm_matmul_counts(remat):
    _, cfg = _lm_cfgs(remat_policy=remat)
    params = transformer.init_params(cfg, torch.Generator().manual_seed(0), "cpu",
                                     dtype=torch.float32)
    b = {k: torch.from_numpy(v) for k, v in _lm_batches(cfg.vocab_size, n=1)[0].items()}
    return _matmul_counts(lambda p: steps.lm_loss(p, b, cfg)[0], params)


def _gnn_matmul_counts(kind, remat):
    cfg = dataclasses.replace(registry.get_arch(kind).SMOKE, dtype="float32",
                              remat_policy=remat)
    _, g, target = _gnn_inputs(kind, cfg.d_out)
    params = gnn.init_params(cfg, torch.Generator().manual_seed(0), 6, device="cpu")
    batch = {"graph": g, "target": torch.from_numpy(target)}
    return _matmul_counts(lambda p: steps.gnn_loss(p, batch, cfg)[0], params)


@pytest.mark.parametrize("policy", ["minimal", "full"])
def test_lm_remat_policies_keep_what_the_reference_keeps(policy):
    """The reference's ``minimal`` (``dots_with_no_batch_dims_saveable``)
    keeps every matmul output: its backward runs no more ``mm`` than the
    backward without remat; ``full`` (``nothing_saveable``) recomputes
    every one.  The gradients are those without remat, bit for bit."""
    n_fwd, n_bwd, want = _lm_matmul_counts("none")
    f, b, got = _lm_matmul_counts(policy)
    assert f == n_fwd > 0
    in_layers = n_fwd - 1                   # the lm_head's runs outside the layers
    assert b == (n_bwd if policy == "minimal" else n_bwd + in_layers)
    for k in want:
        assert (got[k] is None and want[k] is None) or torch.equal(got[k], want[k]), k


@pytest.mark.parametrize("kind", ["meshgraphnet", "schnet", "dimenet"])
def test_gnn_remat_keeps_matmul_outputs_as_the_reference(kind):
    """Every GNN policy but ``none`` is the reference's
    ``dots_with_no_batch_dims_saveable``: no ``mm`` recomputed."""
    n_fwd, n_bwd, want = _gnn_matmul_counts(kind, "none")
    f, b, got = _gnn_matmul_counts(kind, "full")
    assert f == n_fwd > 0 and b == n_bwd
    for k in want:
        assert (got[k] is None and want[k] is None) or torch.equal(got[k], want[k]), k


@pytest.mark.parametrize("kind", ["meshgraphnet", "dimenet"])
def test_gnn_segment_sums_repeat_their_bits_and_match_the_reference(kind):
    """The GNN segment sums add in a fixed order (a sort per graph, kept
    on it): two runs of a step, each on a fresh graph, are equal bit for
    bit, and the forward is within float32 rounding of the JAX package's."""
    jcfg = dataclasses.replace(jregistry.get_arch(kind).SMOKE, dtype="float32")
    cfg = dataclasses.replace(registry.get_arch(kind).SMOKE, dtype="float32")
    jg, _, target = _gnn_inputs(kind, cfg.d_out)
    jparams = jgnn.init_params(jax.random.PRNGKey(0), jcfg, d_in=6)
    want = np.asarray(jgnn.forward(jparams, jg, jcfg))
    runs = []
    for _ in range(2):
        _, g, _ = _gnn_inputs(kind, cfg.d_out)
        params = interop.gnn_params_from_arrays(_flatten(jparams), cfg, 6, device="cpu")
        with torch.no_grad():
            out = gnn.forward(params, g, cfg)
        assert g._segment_orders                    # built once, kept on the graph
        o = opt.adamw(1e-3)
        state, m = steps.build_gnn_train_step(cfg, o)(
            steps.init_train_state(params, o), {"graph": g, "target": torch.from_numpy(target)})
        runs.append((out, float(m["loss"]), float(m["grad_norm"]), _flatten(state["params"])))
    np.testing.assert_allclose(runs[0][0].numpy(), want, rtol=1e-5,
                               atol=1e-6 * np.abs(want).max())
    assert torch.equal(runs[0][0], runs[1][0]) and runs[0][1:3] == runs[1][1:3]
    for k, v in runs[0][3].items():
        assert np.array_equal(v, runs[1][3][k]), k


# ---------------------------------------------------------------------------
# a JAX checkpoint restores into the port and trains on
# ---------------------------------------------------------------------------

def test_reference_checkpoint_restores_and_trains_on(tmp_path):
    jcfg, cfg = _lm_cfgs()
    jo = jopt.adamw(jopt.cosine_schedule(*LR))
    jstate = jsteps.init_train_state(jtransformer.init_params(jax.random.PRNGKey(2), jcfg), jo)
    jstep = jax.jit(jsteps.build_lm_train_step(jcfg, jo))
    batches = _lm_batches(cfg.vocab_size, 3, seed=9)
    jstate, _ = jstep(jstate, {k: jnp.asarray(v) for k, v in batches[0].items()})
    jcheckpoint.save_checkpoint(str(tmp_path), 1, jstate)

    state, step_no = checkpoint.restore_checkpoint(str(tmp_path))
    assert step_no == 1 and int(state["step"]) == 1
    state = interop.train_state_from_arrays(
        {p: t.numpy() for p, t in checkpoint._flatten(state)}, "cpu")
    o = opt.adamw(opt.cosine_schedule(*LR))
    step = steps.build_lm_train_step(cfg, o)
    for b in batches[1:]:
        jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in b.items()})
        state, m = step(state, {k: torch.from_numpy(v) for k, v in b.items()})
        assert float(m["loss"]) == pytest.approx(float(jm["loss"]), rel=1e-5)
    assert int(state["step"]) == 3
    lr_sum = sum(float(jopt.cosine_schedule(*LR)(s)) for s in range(3))
    assert _max_param_diff(state["params"], jstate["params"]) <= 1e-3 * lr_sum
    for key in ("m", "v"):
        assert _max_param_diff(state["opt"][key], jstate["opt"][key]) <= 1e-5
