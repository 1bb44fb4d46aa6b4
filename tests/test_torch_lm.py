"""The port's LM serving path against the JAX package, on the CPU.

Weights are drawn once by the reference (``init_params`` from a PRNG key),
flattened to numpy by path and carried across with
``transformer_params_from_arrays``; tokens come from numpy seeds.

Tolerances: float32 configs (``dataclasses.replace(cfg, dtype="float32")``)
agree to ``rtol=1e-4, atol=1e-4`` (summation order only); bf16 configs to
the ``2e-2`` of ``tests/test_archs.py`` (both sides round at the same
points, and bf16 matmuls accumulate in another order), the MoE archs in
bf16 to that file's ``0.2`` (a bf16 difference upstream can flip a top-k
pick, which moves a token's output by a whole expert's share).  The
servers must produce identical tokens in float32.
"""
import dataclasses
import itertools
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jregistry
from repro.models import layers as jlayers
from repro.models import transformer as jtransformer
from repro.serve.server import BatchedServer as JBatchedServer
from repro.serve.server import Request as JRequest
from repro_torch.configs import registry
from repro_torch.configs.base import TransformerConfig
from repro_torch.models import layers, transformer
from repro_torch.models.interop import transformer_params_from_arrays
from repro_torch.serve.server import BatchedServer, Request

ROOT = Path(__file__).resolve().parents[1]
ARCHS = ["glm4-9b", "yi-9b", "granite-moe-3b-a800m", "moonshot-v1-16b-a3b", "llama3-405b"]
MOE_ARCHS = ["granite-moe-3b-a800m", "moonshot-v1-16b-a3b"]


def _flatten(params) -> dict:
    leaves, _ = jax.tree_util.tree_flatten_with_path(params)
    return {"/".join(k.key for k in path): a if isinstance(a, jax.ShapeDtypeStruct)
            else np.asarray(a) for path, a in leaves}


def _flatten_torch(tree, prefix="") -> dict:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flatten_torch(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


def _flatten_axes(tree, prefix="") -> dict:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flatten_axes(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = tuple(v)
    return out


def _jax_cfg(arch, dtype):
    return dataclasses.replace(jregistry.get_arch(arch).SMOKE, dtype=dtype)


def _port_cfg(arch, dtype):
    return dataclasses.replace(registry.get_arch(arch).SMOKE, dtype=dtype)


def _models(arch, dtype, seed=0):
    jcfg = _jax_cfg(arch, dtype)
    jparams = jtransformer.init_params(jax.random.PRNGKey(seed), jcfg)
    cfg = _port_cfg(arch, dtype)
    params = transformer_params_from_arrays(_flatten(jparams), cfg, device="cpu")
    return jcfg, jparams, cfg, params


def _close(got: torch.Tensor, want, dtype, moe=False):
    got = got.float().numpy()
    want = np.asarray(jnp.asarray(want, jnp.float32))
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    else:
        assert float(np.abs(got - want).max()) < (0.2 if moe else 2e-2)


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_configs_carry_the_reference_numbers(arch):
    ref_mod, mod = jregistry.get_arch(arch), registry.get_arch(arch)
    for name in ("CONFIG", "SMOKE"):
        ref = dataclasses.asdict(getattr(ref_mod, name))
        got = dataclasses.asdict(getattr(mod, name))
        assert got == ref
    assert mod.SHAPE_FAMILY == ref_mod.SHAPE_FAMILY
    assert getattr(mod, "OPTIMIZER", None) == getattr(ref_mod, "OPTIMIZER", None)
    cfg = registry.get_arch(arch).CONFIG
    assert cfg.n_params() == jregistry.get_arch(arch).CONFIG.n_params()


def test_registry_rejects_unported_arch():
    """Kept under its old name (graphgen-paper was refused before the
    dry-run cells were ported): the registry now lists the reference's
    archs in its order, graphgen-paper among them with its config and its
    one shape, and refuses an unknown arch."""
    assert registry.list_archs() == jregistry.list_archs()
    assert registry.list_archs(assigned_only=True) == jregistry.list_archs(assigned_only=True)
    assert "graphgen-paper" not in registry.list_archs(assigned_only=True)
    mod, ref = registry.get_arch("graphgen-paper"), jregistry.get_arch("graphgen-paper")
    for name in ("CONFIG", "SMOKE"):
        assert dataclasses.asdict(getattr(mod, name)) == dataclasses.asdict(getattr(ref, name))
    assert mod.SHAPE_FAMILY == ref.SHAPE_FAMILY == "graphgen"
    for arch in registry.list_archs():
        assert registry.shapes_for(arch) == jregistry.shapes_for(arch)
    assert registry.shapes_for("graphgen-paper") == ["pagerank"]
    with pytest.raises(KeyError, match="unknown arch"):
        registry.get_arch("no-such-arch")


def test_moe_config_is_not_ported():
    """Kept under its old name (the MoE archs were refused before they
    were ported): each MoE config's params have the reference's paths,
    shapes and logical axes, at ``SMOKE`` and, on the meta device, at
    ``CONFIG``."""
    for arch, name in itertools.product(MOE_ARCHS, ("SMOKE", "CONFIG")):
        jcfg = getattr(jregistry.get_arch(arch), name)
        want = _flatten(jax.eval_shape(lambda: jtransformer.init_params(
            jax.random.PRNGKey(0), jcfg)))
        cfg = getattr(registry.get_arch(arch), name)
        got = _flatten_torch(transformer.init_params(cfg, None, device="meta"))
        assert {p: tuple(a.shape) for p, a in got.items()} == {
            p: tuple(a.shape) for p, a in want.items()}
        assert "layers/moe/router" in got and "layers/mlp/w_gate" not in got
        axes = _flatten_axes(transformer.logical_axes(cfg))
        assert axes == _flatten_axes(jtransformer.logical_axes(jcfg))
        assert set(axes) == set(got)
        assert all(len(axes[p]) == got[p].ndim for p in got)


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rms_norm_and_rope_match_jax(dtype):
    rng = np.random.default_rng(1)
    jdt = jnp.dtype(dtype)
    tdt = transformer.torch_dtype(dtype)
    x = jnp.asarray(rng.standard_normal((2, 5, 4, 16)) * 3.0, dtype=jdt)
    w = jnp.asarray(rng.standard_normal(16), dtype=jnp.float32)
    tx = torch.from_numpy(np.array(x.astype(jnp.float32))).to(tdt)
    tw = torch.from_numpy(np.array(w))
    got = layers.rms_norm(tx, tw, 1e-5)
    assert got.dtype == tdt
    # rsqrt differs in the last float32 bit, which can move a bf16 rounding
    np.testing.assert_allclose(
        got.float().numpy(), np.asarray(jlayers.rms_norm(x, w, 1e-5).astype(jnp.float32)),
        rtol=1e-6 if dtype == "float32" else 8e-3, atol=1e-6)
    pos = np.arange(5, dtype=np.int32) + 7
    want = jlayers.rope(x, jnp.asarray(pos), 500_000.0)
    got = layers.rope(tx, torch.from_numpy(pos), 500_000.0)
    assert got.dtype == tdt
    diff = np.abs(got.float().numpy() - np.asarray(want.astype(jnp.float32)))
    # float32: transcendental round-off; bf16: at most one bf16 step of |x| < 16
    assert float(diff.max()) < (1e-5 if dtype == "float32" else 0.07)


def test_dense_init_scale_and_dtype():
    g = torch.Generator().manual_seed(0)
    w = layers.dense_init(g, 256, 64, torch.bfloat16)
    assert w.dtype == torch.bfloat16 and w.shape == (256, 64)
    assert abs(float(w.float().std()) - 1 / 16) < 5e-3


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_matches_jax_without_cache(arch, dtype):
    jcfg, jparams, cfg, params = _models(arch, dtype)
    toks = np.random.default_rng(2).integers(0, cfg.vocab_size, (2, 12))
    want, _, want_aux = jtransformer.forward(jparams, jnp.asarray(toks, jnp.int32), jcfg)
    got, cache, aux = transformer.forward(params, torch.from_numpy(toks), cfg)
    assert cache is None and got.dtype == torch.float32 and aux.dtype == torch.float32
    if cfg.moe is None:
        assert float(aux) == 0.0 == float(want_aux)
    else:  # the layers' moe_aux_loss + moe_z_loss, from float32 router logits
        np.testing.assert_allclose(float(aux), float(want_aux),
                                   rtol=1e-5 if dtype == "float32" else 2e-2)
    assert got.shape == (2, 12, cfg.vocab_size)
    _close(got, want, dtype, cfg.moe is not None)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_matches_jax_with_cache(arch, dtype):
    """Prefill 8 tokens into a 16-slot cache, then decode one: both the
    prefill's and the decode's logits agree with the reference's."""
    jcfg, jparams, cfg, params = _models(arch, dtype)
    toks = np.random.default_rng(3).integers(0, cfg.vocab_size, (2, 9))
    jcache = jtransformer.init_cache(jcfg, 2, 16)
    want_pre, jcache, _ = jtransformer.forward(
        jparams, jnp.asarray(toks[:, :8], jnp.int32), jcfg, jcache)
    want_dec, jcache, _ = jtransformer.forward(
        jparams, jnp.asarray(toks[:, 8:], jnp.int32), jcfg, jcache)
    cache = transformer.init_cache(cfg, 2, 16, "cpu")
    got_pre, cache, _ = transformer.forward(params, torch.from_numpy(toks[:, :8]), cfg, cache)
    assert cache.length == 8
    got_dec, cache, _ = transformer.forward(params, torch.from_numpy(toks[:, 8:]), cfg, cache)
    assert cache.length == int(jcache.length) == 9
    moe = cfg.moe is not None
    _close(got_pre, want_pre, dtype, moe)
    _close(got_dec, want_dec, dtype, moe)
    _close(cache.k, jcache.k, dtype, moe)
    _close(cache.v, jcache.v, dtype, moe)


@pytest.mark.parametrize("arch", ARCHS)
def test_lm_smoke_decode_matches_full(arch):
    """The port's own ``test_lm_smoke_decode_matches_full``: decoding the
    ninth token over an 8-token cache equals the full forward's ninth
    position (bf16 SMOKE config, the reference's 2e-2; 0.2 for MoE, whose
    top-k can flip under tiny numeric differences)."""
    cfg = registry.get_arch(arch).SMOKE
    params = transformer.init_params(cfg, torch.Generator().manual_seed(1), "cpu")
    toks = torch.from_numpy(np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 9)))
    cache = transformer.init_cache(cfg, 2, 16, "cpu")
    _, cache, _ = transformer.forward(params, toks[:, :8], cfg, cache)
    dec, _, _ = transformer.forward(params, toks[:, 8:9], cfg, cache)
    full, _, _ = transformer.forward(params, toks, cfg)
    tol = 0.2 if cfg.moe is not None else 2e-2
    assert float((dec[:, 0] - full[:, 8]).abs().max()) < tol


def test_cache_overflow_raises():
    cfg = registry.get_arch("glm4-9b").SMOKE
    params = transformer.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    cache = transformer.init_cache(cfg, 1, 4, "cpu")
    with pytest.raises(ValueError, match="overflow"):
        transformer.forward(params, torch.zeros((1, 5), dtype=torch.int64), cfg, cache)


# ---------------------------------------------------------------------------
# BatchedServer
# ---------------------------------------------------------------------------

def _serve_lm_requests(cls, vocab):
    """``examples/serve_lm.py``'s request set: 7 ragged prompts."""
    rng = np.random.default_rng(0)
    return [cls(rid=i, prompt=rng.integers(0, vocab, size=int(rng.integers(4, 12))),
                max_new_tokens=8)
            for i in range(7)]


@pytest.mark.parametrize("arch", ARCHS)
def test_batched_server_matches_reference_tokens(arch):
    jcfg, jparams, cfg, params = _models(arch, "float32")
    want = JBatchedServer(jparams, jcfg, batch_slots=3, max_len=64).run(
        _serve_lm_requests(JRequest, cfg.vocab_size))
    got = BatchedServer(params, cfg, batch_slots=3, max_len=64).run(
        _serve_lm_requests(Request, cfg.vocab_size))
    assert sorted(got) == sorted(want) == list(range(7))
    for rid in want:
        assert got[rid] == [int(t) for t in want[rid]], rid


@pytest.fixture(scope="module")
def lm():
    cfg = TransformerConfig(
        name="t", n_layers=2, d_model=32, n_heads=4, n_kv_heads=2, d_ff=64,
        vocab_size=64, microbatches=1, remat_policy="none",
    )
    return transformer.init_params(cfg, torch.Generator().manual_seed(0), "cpu"), cfg


def _req(rid, length, max_new=4, seed=0):
    rng = np.random.default_rng(seed + rid)
    return Request(rid=rid, prompt=rng.integers(0, 64, size=length),
                   max_new_tokens=max_new)


def test_ragged_admission_rejected(lm):
    params, cfg = lm
    server = BatchedServer(params, cfg, batch_slots=3, max_len=32)
    assert server.admit(_req(0, 6))
    assert server.can_admit(_req(1, 6))
    assert not server.can_admit(_req(2, 4))
    with pytest.raises(ValueError, match="ragged"):
        server.admit(_req(3, 4))
    assert sum(s is not None for s in server.slots) == 1
    assert server.admit(_req(4, 6))


def test_step_uses_common_active_length_not_stale_max(lm):
    params, cfg = lm
    server = BatchedServer(params, cfg, batch_slots=2, max_len=32)
    long_out = server.run([_req(0, 12, max_new=4)])
    assert all(s is None for s in server.slots)
    got = server.run([_req(1, 5, max_new=4)])
    fresh = BatchedServer(params, cfg, batch_slots=2, max_len=32)
    want = fresh.run([_req(1, 5, max_new=4)])
    assert got[1] == want[1]
    assert len(long_out[0]) >= 4


def test_run_defers_ragged_requests_and_serves_all(lm):
    params, cfg = lm
    server = BatchedServer(params, cfg, batch_slots=3, max_len=32)
    lengths = [6, 6, 4, 6, 9, 4]
    out = server.run([_req(i, n, max_new=3) for i, n in enumerate(lengths)])
    assert set(out) == set(range(6))
    assert all(len(v) >= 3 for v in out.values())
    for i, n in enumerate(lengths):
        fresh = BatchedServer(params, cfg, batch_slots=3, max_len=32)
        assert fresh.run([_req(i, n, max_new=3)])[i] == out[i], i


# ---------------------------------------------------------------------------
# launcher
# ---------------------------------------------------------------------------

def test_launcher_serves_on_cpu():
    _serves_on_cpu("glm4-9b")


def test_launcher_serves_an_moe_arch_on_cpu():
    _serves_on_cpu("granite-moe-3b-a800m")


def _serves_on_cpu(arch):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", arch,
         "--device", "cpu"],
        env=env, cwd=str(ROOT), capture_output=True, text=True, timeout=300,
    )
    assert out.returncode == 0, out.stderr
    assert "served 6 requests" in out.stdout
