"""The port's optimizers and schedules against the JAX package's, on the CPU.

Both run 5 steps on the same numpy gradient trees from the same params.
Tolerances: float32 state and params ``rtol=1e-6, atol=1e-7`` (the same
float32 operations; XLA and PyTorch may round ``pow`` / ``rsqrt`` / a
mean's sum in another order); a bf16 moment within one bf16 step of the
reference's (a float32 difference of one ulp can move a bf16 rounding).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.train import optimizer as jopt
from repro_torch.train import optimizer as opt

SHAPES = {"a": (4, 8), "b": {"c": (3,), "d": (2, 3, 5)}, "e": (6, 1)}


def _tree(shapes, rng, scale=1.0):
    if isinstance(shapes, dict):
        return {k: _tree(v, rng, scale) for k, v in shapes.items()}
    return (rng.standard_normal(shapes) * scale).astype(np.float32)


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _pairs(got, want, path=""):
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            yield from _pairs(got[k], want[k], f"{path}/{k}")
    else:
        yield path, got, want


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _close(got, want, bf16=False):
    for path, g, w in _pairs(got, want):
        g, w = _np(g), _np(w)
        if bf16:
            # one bf16 step (2^-7 relative) of the larger magnitude
            bound = 2.0 ** -7 * np.maximum(np.abs(g), np.abs(w)) + 1e-30
            assert np.all(np.abs(g - w) <= bound), path
        else:
            np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-7, err_msg=path)


OPTIMIZERS = {
    "adamw": lambda m: m.adamw(m.cosine_schedule(1e-2, 2, 10)),
    "adamw_bf16_moments": lambda m: m.adamw(1e-2, moment_dtype="bfloat16"),
    "adamw_decay_mask": lambda m: m.adamw(
        m.linear_warmup(1e-2, 3), weight_decay=0.3,
        decay_mask=lambda p: {"a": True, "b": {"c": False, "d": True}, "e": False}),
    "sgdm": lambda m: m.sgdm(m.cosine_schedule(5e-2, 1, 6), momentum=0.8),
    "adafactor": lambda m: m.adafactor(1e-2),
}


@pytest.mark.parametrize("name", list(OPTIMIZERS))
def test_optimizer_matches_reference_over_5_steps(name):
    rng = np.random.default_rng(3)
    params0 = _tree(SHAPES, rng)
    jo, o = OPTIMIZERS[name](jopt), OPTIMIZERS[name](opt)
    jparams = _map(jnp.asarray, params0)
    params = _map(torch.from_numpy, params0)
    jstate, state = jo.init(jparams), o.init(params)
    _close(state, jstate)
    for step in range(5):
        grads0 = _tree(SHAPES, rng, scale=10.0 ** (step - 2))
        ju, jstate = jo.update(_map(jnp.asarray, grads0), jstate, jparams,
                               jnp.asarray(step, jnp.int32))
        u, state = o.update(_map(torch.from_numpy, grads0), state, params,
                            torch.tensor(step, dtype=torch.int32))
        _close(u, ju, bf16=name.endswith("bf16_moments"))
        _close(state, jstate, bf16=name.endswith("bf16_moments"))
        jparams = jopt.apply_updates(jparams, ju)
        params = opt.apply_updates(params, u)
        _close(params, jparams, bf16=name.endswith("bf16_moments"))
    if name.endswith("bf16_moments"):
        assert all(t.dtype == torch.bfloat16 for _, t, _ in _pairs(state, jstate))


@pytest.mark.parametrize("schedule", [
    lambda m: m.cosine_schedule(3e-4, 20, 1000),
    lambda m: m.cosine_schedule(1.0, 0, 10, floor=0.0),
    lambda m: m.linear_warmup(2e-3, 7),
], ids=["cosine", "cosine_no_warmup", "linear_warmup"])
def test_schedules_match_reference(schedule):
    for step in [0, 1, 5, 19, 20, 21, 500, 999, 1000, 5000]:
        want = float(schedule(jopt)(jnp.asarray(step, jnp.int32)))
        got = float(schedule(opt)(torch.tensor(step, dtype=torch.int32)))
        assert got == pytest.approx(want, rel=1e-6, abs=1e-12), step


def test_clip_by_global_norm_and_apply_updates_casts():
    rng = np.random.default_rng(4)
    grads0 = _tree(SHAPES, rng, scale=3.0)
    for max_norm in (1.0, 1e3):
        jg, jn = jopt.clip_by_global_norm(_map(jnp.asarray, grads0), max_norm)
        g, n = opt.clip_by_global_norm(_map(torch.from_numpy, grads0), max_norm)
        assert float(n) == pytest.approx(float(jn), rel=1e-6)
        _close(g, jg)
    # bf16 params take a float32 update in float32 and keep their dtype
    p0 = _tree(SHAPES, rng)
    u0 = _tree(SHAPES, rng, scale=1e-2)
    jp = jopt.apply_updates(_map(lambda a: jnp.asarray(a, jnp.bfloat16), p0),
                            _map(jnp.asarray, u0))
    p = opt.apply_updates(_map(lambda a: torch.from_numpy(a).to(torch.bfloat16), p0),
                          _map(torch.from_numpy, u0))
    for path, got, want in _pairs(p, jp):
        assert got.dtype == torch.bfloat16, path
        np.testing.assert_array_equal(_np(got), _np(want), err_msg=path)
