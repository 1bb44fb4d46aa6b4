"""The port's attention (K4's plain path on CPU tensors) against the JAX
package: ``flash_attention_pallas`` in interpret mode on the kernel sweep,
and ``repro.models.layers.flash_attention`` on the serving path's
``q_offset`` / ``kv_length`` cases (prefill into a longer cache, prefill
after a cached prefix, decode over a ragged key tail, a row with no valid
key).

Inputs come from numpy seeds; bf16 inputs are rounded once in JAX and
carried across exactly.  Tolerances are the reference's own
(``tests/test_kernels.py``): 2e-5 in float32 (summation order only) and
0.05 in bf16 (``p`` is rounded to bf16 before P·V, and the output too).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention_pallas
from repro.models import layers as jlayers
from repro_torch.kernels import flash_attention as K
from repro_torch.models import layers as tlayers

FLASH_SWEEP = [
    # (B, T, H, KV, D, bq, bkv, causal), as in tests/test_kernels.py
    (1, 64, 2, 1, 8, 16, 16, True),
    (2, 128, 4, 2, 16, 32, 64, True),
    (1, 96, 4, 4, 8, 32, 32, False),
    (2, 100, 2, 1, 8, 16, 16, True),
    (1, 256, 8, 2, 32, 128, 128, True),
]

DTYPES = {"float32": (jnp.float32, torch.float32, 2e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 0.05)}


def _pair(rng, shape, jdt, tdt):
    a = jnp.asarray(rng.standard_normal(shape), dtype=jdt)
    t = torch.from_numpy(np.array(a.astype(jnp.float32))).to(tdt)
    return a, t


def _err(got: torch.Tensor, want) -> float:
    return float(np.abs(got.float().numpy() - np.asarray(want.astype(jnp.float32))).max())


@pytest.mark.parametrize("shape", FLASH_SWEEP)
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_attention_matches_pallas_sweep(shape, dtype):
    B, T, H, KV, D, bq, bkv, causal = shape
    jdt, tdt, tol = DTYPES[dtype]
    rng = np.random.default_rng(abs(hash(shape)) % 2**31)
    q, tq = _pair(rng, (B, T, H, D), jdt, tdt)
    k, tk = _pair(rng, (B, T, KV, D), jdt, tdt)
    v, tv = _pair(rng, (B, T, KV, D), jdt, tdt)
    want = flash_attention_pallas(q, k, v, causal=causal, block_q=bq, block_kv=bkv,
                                  interpret=True)
    got = tlayers.flash_attention(tq, tk, tv, causal=causal, block_q=bq, block_kv=bkv)
    assert got.dtype == tdt and got.shape == (B, T, H, D)
    assert _err(got, want) < tol


# (name, B, Tq, Tk (cache length), H, KV, D, causal, q_offset, kv_length, bq, bkv)
CACHE_CASES = [
    ("prefill_into_cache", 1, 24, 40, 8, 2, 16, True, 0, [24], 8, 16),
    ("prefill_after_prefix", 2, 12, 48, 4, 2, 8, True, 20, [32, 32], 16, 16),
    ("decode_ragged", 3, 1, 64, 8, 2, 16, False, 0, [5, 17, 33], 512, 1024),
    ("decode_gqa8", 2, 1, 70, 16, 2, 32, False, 0, [70, 41], 512, 1024),
    ("masked_row", 2, 1, 32, 4, 1, 8, False, 0, [0, 9], 1, 16),
]


@pytest.mark.parametrize("case", CACHE_CASES, ids=[c[0] for c in CACHE_CASES])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_attention_matches_layers_cache_path(case, dtype):
    _, B, Tq, Tk, H, KV, D, causal, q_offset, kv_length, bq, bkv = case
    jdt, tdt, tol = DTYPES[dtype]
    rng = np.random.default_rng(len(case[0]) + Tk)
    q, tq = _pair(rng, (B, Tq, H, D), jdt, tdt)
    # keys past kv_length hold garbage: both sides must mask them
    k, tk = _pair(rng, (B, Tk, KV, D), jdt, tdt)
    v, tv = _pair(rng, (B, Tk, KV, D), jdt, tdt)
    lengths = np.asarray(kv_length, dtype=np.int32)
    want = jlayers.flash_attention(
        q, k, v, causal=causal, q_offset=jnp.asarray(q_offset, jnp.int32),
        kv_length=jnp.asarray(lengths), block_q=bq, block_kv=bkv,
    )
    got = tlayers.flash_attention(
        tq, tk, tv, causal=causal, q_offset=q_offset,
        kv_length=torch.from_numpy(lengths), block_q=bq, block_kv=bkv,
    )
    assert _err(got, want) < tol
    if 0 in kv_length:
        assert float(got[kv_length.index(0)].abs().max()) == 0.0


def test_gqa_reads_kv_head_h_over_g():
    """Query head h attends with kv head h // G (repeat_interleave, not
    repeat): a dense softmax written out by hand agrees."""
    rng = np.random.default_rng(3)
    B, T, H, KV, D = 1, 10, 6, 2, 8
    q = torch.from_numpy(rng.standard_normal((B, T, H, D)).astype(np.float32))
    k = torch.from_numpy(rng.standard_normal((B, T, KV, D)).astype(np.float32))
    v = torch.from_numpy(rng.standard_normal((B, T, KV, D)).astype(np.float32))
    kr = k.repeat_interleave(H // KV, dim=2)
    vr = v.repeat_interleave(H // KV, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q, kr) / np.sqrt(D)
    s = s.masked_fill(torch.ones(T, T, dtype=torch.bool).triu(1), float("-inf"))
    want = torch.einsum("bhqk,bkhd->bqhd", s.softmax(-1), vr)
    got = tlayers.flash_attention(q, k, v, causal=True, block_q=4, block_kv=4)
    assert float((got - want).abs().max()) < 2e-5


def test_wrapper_counts_no_launch_on_cpu_and_checks_shapes():
    K.reset_launch_counts()
    x = torch.zeros((1, 4, 4, 8))
    kv = torch.zeros((1, 4, 2, 8))
    K.flash_attention(x, kv, kv)
    assert K.LAUNCHES["flash_attention"] == 0
    assert K.PLAIN_CUDA_CALLS["flash_attention"] == 0
    with pytest.raises(ValueError, match="multiple"):
        K.flash_attention(x, torch.zeros((1, 4, 3, 8)), torch.zeros((1, 4, 3, 8)))
    with pytest.raises(ValueError, match="dtype"):
        K.flash_attention(x, kv.to(torch.bfloat16), kv)
    with pytest.raises(ValueError, match="kv_length"):
        K.flash_attention(x, kv, kv, kv_length=torch.zeros(2, dtype=torch.int32))
