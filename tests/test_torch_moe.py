"""The port's MoE layer (``repro_torch.models.moe``) against the JAX
package's, on the CPU.

Weights and tokens are made with numpy from a seed and handed to both
packages.  Tolerances: float32 ``rtol=1e-5, atol=1e-6`` (the products add
in another order; the routing, the capacities and the dropped slots are
equal exactly), bf16 the reference's ``2e-2`` (``tests/test_archs.py``;
measured: on the CPU the two packages' bf16 layers agree bit for bit).
The all-to-all dispatch over more than one rank is held against the JAX
package in ``tests/test_torch_model_sharding.py``; here it runs on a
one-rank mesh, which needs no process group.
"""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import MoEConfig as JMoEConfig
from repro.distributed import sharding as jsharding
from repro.models import moe as jmoe
from repro_torch.configs.base import MoEConfig
from repro_torch.distributed.sharding import use_mesh_rules
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import moe

D = 16
# (tokens, capacity factor): the sort path's capacity floor is min(T, 128),
# so only past 128 tokens can an expert overflow
AMPLE = (64, 8.0)
BINDING = (512, 0.25)
RULES = {"experts": "model", "expert_ff": None, "expert_capacity": None,
         "embed": None, "batch": "data"}


def _cfgs(capacity_factor, dispatch="sort", n_experts=8, top_k=2):
    kw = dict(n_experts=n_experts, top_k=top_k, d_expert=32,
              capacity_factor=capacity_factor, dispatch=dispatch)
    return JMoEConfig(**kw), MoEConfig(**kw)


def _weights(cfg, seed):
    rng = np.random.default_rng(seed)
    E, F = cfg.n_experts, cfg.d_expert
    return {
        "router": rng.standard_normal((D, E)) / math.sqrt(D),
        "w_gate": rng.standard_normal((E, D, F)) / math.sqrt(D),
        "w_up": rng.standard_normal((E, D, F)) / math.sqrt(D),
        "w_down": rng.standard_normal((E, F, D)) / math.sqrt(F),
    }


def _tokens(T, seed):
    return np.random.default_rng(seed).standard_normal((T, D))


def _both(weights, x, dtype="float32"):
    jdt = jnp.dtype(dtype)
    tdt = getattr(torch, dtype)
    jp = {k: jnp.asarray(v, jnp.float32) for k, v in weights.items()}
    tp = {k: torch.from_numpy(np.asarray(v, np.float32)) for k, v in weights.items()}
    return (jp, jnp.asarray(x, jnp.float32).astype(jdt),
            tp, torch.from_numpy(np.asarray(x, np.float32)).to(tdt))


def _dropped(mod, params, x, cfg, C):
    """The set of dropped (token, expert) slots of the sort path."""
    eids, gates, _, _ = mod._route(params, x, cfg)
    out = mod._sort_positions(eids, gates, cfg.n_experts, C, lambda e: e)
    se, st, keep = (np.asarray(a) for a in (out[1], out[2], out[5]))
    return {(int(t), int(e)) for t, e, k in zip(st, se, keep) if not k}


def _metrics_close(got, want, rtol=1e-5):
    assert set(got) == set(want) == {"moe_aux_loss", "moe_z_loss", "moe_drop_fraction"}
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=rtol, atol=1e-7,
                                   err_msg=k)


@pytest.mark.parametrize("tokens,capacity_factor", [AMPLE, BINDING],
                         ids=["ample", "binding"])
def test_moe_sort_matches_jax_in_float32(tokens, capacity_factor):
    jcfg, cfg = _cfgs(capacity_factor)
    jp, jx, tp, tx = _both(_weights(cfg, 0), _tokens(tokens, 1))
    want, wm = jmoe.moe_apply(jp, jx, jcfg)
    got, gm = moe.moe_apply(tp, tx, cfg)
    assert got.shape == (tokens, D) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)
    _metrics_close(gm, wm)
    assert float(gm["moe_drop_fraction"]) == float(wm["moe_drop_fraction"])
    C = max(int(tokens * cfg.top_k / cfg.n_experts * capacity_factor), min(tokens, 128), 1)
    dropped = _dropped(moe, tp, tx, cfg, C)
    assert dropped == _dropped(jmoe, jp, jx, jcfg, C)
    if (tokens, capacity_factor) == BINDING:
        assert len(dropped) == round(float(wm["moe_drop_fraction"]) * tokens * cfg.top_k) > 0
    else:
        assert not dropped


def test_tied_router_scores_pick_the_reference_experts():
    """A router whose columns come in equal pairs ties every pair's
    probability exactly (integer tokens, router entries in eighths: the
    logits are exact): both packages pick the lower expert id first."""
    jcfg, cfg = _cfgs(8.0, top_k=3)
    w = _weights(cfg, 2)
    router = np.round(np.random.default_rng(3).standard_normal((D, 4)) * 8) / 8
    w["router"] = np.repeat(router, 2, axis=1)               # columns 2i == 2i + 1
    x = np.random.default_rng(4).integers(-3, 4, (64, D)).astype(np.float64)
    jp, jx, tp, tx = _both(w, x)
    want_e, want_g, _, _ = jmoe._route(jp, jx, jcfg)
    got_e, got_g, _, _ = moe._route(tp, tx, cfg)
    np.testing.assert_array_equal(got_e.numpy(), np.asarray(want_e))
    np.testing.assert_allclose(got_g.numpy(), np.asarray(want_g), rtol=1e-6)
    # every token's first pick ties with its partner, the even id wins
    assert (got_e[:, 0] % 2 == 0).all() and (got_e[:, 1] == got_e[:, 0] + 1).all()
    want, _ = jmoe.moe_apply(jp, jx, jcfg)
    got, _ = moe.moe_apply(tp, tx, cfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("tokens,capacity_factor", [AMPLE, BINDING],
                         ids=["ample", "binding"])
def test_moe_sort_matches_jax_in_bf16(tokens, capacity_factor):
    jcfg, cfg = _cfgs(capacity_factor)
    jp, jx, tp, tx = _both(_weights(cfg, 5), _tokens(tokens, 6), "bfloat16")
    want, wm = jmoe.moe_apply(jp, jx, jcfg)
    got, gm = moe.moe_apply(tp, tx, cfg)
    assert got.dtype == torch.bfloat16
    diff = np.abs(got.float().numpy() - np.asarray(want.astype(jnp.float32)))
    assert float(diff.max()) < 2e-2
    _metrics_close(gm, wm, rtol=2e-2)


def test_sort_path_repeats_its_bits_and_has_router_and_expert_grads():
    jcfg, cfg = _cfgs(BINDING[1])
    _, _, tp, tx = _both(_weights(cfg, 7), _tokens(BINDING[0], 8))
    first, _ = moe.moe_apply(tp, tx, cfg)
    again, _ = moe.moe_apply(tp, tx, cfg)
    assert torch.equal(first, again)
    leaves = {k: v.clone().requires_grad_() for k, v in tp.items()}
    y, m = moe.moe_apply(leaves, tx, cfg)
    loss = (y * torch.linspace(-1, 1, D)).sum() + m["moe_aux_loss"] + m["moe_z_loss"]
    grads = torch.autograd.grad(loss, list(leaves.values()))
    assert all(bool(g.abs().sum() > 0) for g in grads)


@pytest.mark.parametrize("tokens,capacity_factor", [AMPLE, BINDING],
                         ids=["ample", "binding"])
def test_a2a_on_a_one_rank_mesh_matches_jax(tokens, capacity_factor):
    """``dispatch='a2a'`` under a one-rank host mesh (no process group, no
    collective) keeps the a2a path's own capacities ``C`` / ``C2``: it
    equals the JAX package's ``_moe_a2a`` on a (1, 1) mesh of the one CPU
    device, dropped share included, and differs from the sort path where
    capacity binds."""
    jcfg, cfg = _cfgs(capacity_factor, "a2a")
    jp, jx, tp, tx = _both(_weights(cfg, 9), _tokens(tokens, 10))
    jmesh = jax.sharding.Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("data", "model"))
    with jsharding.use_mesh_rules(jmesh, RULES):
        want, wm = jax.jit(lambda p, x: jmoe.moe_apply(p, x, jcfg))(jp, jx)
    mesh = make_host_mesh("cpu")
    assert mesh.size() == 1 and mesh.mesh_dim_names == ("data", "model")
    with use_mesh_rules(mesh, RULES):
        got, gm = moe.moe_apply(tp, tx, cfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)
    _metrics_close(gm, wm)
    sort, sm = moe.moe_apply(tp, tx, dataclasses.replace(cfg, dispatch="sort"))
    if (tokens, capacity_factor) == BINDING:
        assert float(gm["moe_drop_fraction"]) != float(sm["moe_drop_fraction"])
    else:
        np.testing.assert_allclose(got.numpy(), sort.numpy(), rtol=1e-5, atol=1e-6)
        assert float(gm["moe_drop_fraction"]) == 0.0


def test_moe_init_shapes_scales_and_dtype():
    cfg = MoEConfig(n_experts=4, top_k=2, d_expert=64)
    p = moe.moe_init(torch.Generator().manual_seed(0), 256, cfg, "cpu", torch.bfloat16)
    assert {k: tuple(v.shape) for k, v in p.items()} == {
        "router": (256, 4), "w_gate": (4, 256, 64), "w_up": (4, 256, 64),
        "w_down": (4, 64, 256)}
    assert all(v.dtype == torch.bfloat16 for v in p.values())
    assert abs(float(p["w_gate"].float().std()) - 1 / 16) < 3e-3
    assert abs(float(p["w_down"].float().std()) - 1 / 8) < 5e-3
    assert moe.moe_logical_axes() == jmoe.moe_logical_axes()


def test_drop_fractions_at_granite_widths_equal_the_reference():
    """granite-moe-3b-a800m's widths (d_model 1536, 40 experts, top 8,
    capacity factor 1.25) at 2 layers, float32, one 1024-token prompt
    (C = 256 a expert): with random weights many tokens route alike, so
    many slots drop (about a fifth here); every layer's drop fraction, aux
    and z losses equal the JAX package's, and so do the logits."""
    from repro.configs import registry as jregistry
    from repro.models import transformer as jtransformer
    from repro_torch.configs import registry
    from repro_torch.models import transformer
    from repro_torch.models.interop import transformer_params_from_arrays

    jcfg = dataclasses.replace(jregistry.get_arch("granite-moe-3b-a800m").CONFIG,
                               n_layers=2, dtype="float32", scan_layers=False,
                               remat_policy="none")
    cfg = dataclasses.replace(registry.get_arch("granite-moe-3b-a800m").CONFIG,
                              n_layers=2, dtype="float32", remat_policy="none")
    jparams = jtransformer.init_params(jax.random.PRNGKey(0), jcfg)
    leaves, _ = jax.tree_util.tree_flatten_with_path(jparams)
    params = transformer_params_from_arrays(
        {"/".join(k.key for k in p): np.asarray(a) for p, a in leaves}, cfg, "cpu")
    toks = np.random.default_rng(13).integers(0, cfg.vocab_size, (1, 1024))

    def recorded(mod, into):
        apply = mod.moe_apply

        def wrapper(p, x, c):
            y, m = apply(p, x, c)
            into.append({k: float(v) for k, v in m.items()})
            return y, m
        return wrapper

    want_m, got_m = [], []
    orig_j, orig_t = jmoe.moe_apply, moe.moe_apply
    jmoe.moe_apply, moe.moe_apply = recorded(jmoe, want_m), recorded(moe, got_m)
    try:
        want, _, _ = jtransformer.forward(jparams, jnp.asarray(toks, jnp.int32), jcfg)
        got, _, _ = transformer.forward(params, torch.from_numpy(toks), cfg)
    finally:
        jmoe.moe_apply, moe.moe_apply = orig_j, orig_t
    assert len(got_m) == len(want_m) == 2
    for g, w in zip(got_m, want_m):
        assert g["moe_drop_fraction"] == w["moe_drop_fraction"] > 0.1
        _metrics_close(g, w)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)
