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


# ---------------------------------------------------------------------------
# The split-KV decode arithmetic (flash_attention_split_plain)
# ---------------------------------------------------------------------------

# (name, B, Tk, H, KV, D, causal, q_offset, kv_length, split_keys)
SPLIT_CASES = [
    ("empty_row", 2, 200, 4, 1, 16, False, 0, [0, 150], 64),
    ("shorter_than_split", 1, 300, 2, 2, 8, False, 0, [50], 128),
    ("not_a_multiple", 1, 300, 32, 2, 32, False, 0, [200], 128),
    ("ragged_rows", 4, 260, 8, 2, 16, False, 0, [1, 64, 129, 260], 64),
    ("default_split", 2, 130, 32, 2, 16, False, 0, [130, 77], None),
    ("causal_one_query", 1, 200, 4, 1, 16, True, 90, [200], 64),
]

# element-wise in bf16: one output ulp relative, plus p rounded to bf16
# against a running max other than the reference's (chip_smoke.py's K4 bound)
BF16_ATOL, BF16_RTOL = 2e-3, 2.0 ** -7


@pytest.mark.parametrize("case", SPLIT_CASES, ids=[c[0] for c in SPLIT_CASES])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_split_plain_matches_layers_decode(case, dtype):
    """Partials per key range and the combine give the reference's decode
    attention: float32 to 2e-5, bf16 element by element."""
    _, B, Tk, H, KV, D, causal, q_offset, kv_length, split_keys = case
    jdt, tdt, _ = DTYPES[dtype]
    rng = np.random.default_rng(Tk + H + D)
    q, tq = _pair(rng, (B, 1, H, D), jdt, tdt)
    k, tk = _pair(rng, (B, Tk, KV, D), jdt, tdt)
    v, tv = _pair(rng, (B, Tk, KV, D), jdt, tdt)
    lengths = np.asarray(kv_length, dtype=np.int32)
    want = np.asarray(jlayers.flash_attention(
        q, k, v, causal=causal, q_offset=jnp.asarray(q_offset, jnp.int32),
        kv_length=jnp.asarray(lengths),
    ).astype(jnp.float32))
    got = K.flash_attention_split_plain(
        tq, tk, tv, causal=causal, q_offset=q_offset,
        kv_length=torch.from_numpy(lengths), split_keys=split_keys,
    )
    assert got.dtype == tdt and got.shape == (B, 1, H, D)
    diff = np.abs(got.float().numpy() - want)
    if dtype == "float32":
        assert diff.max() < 2e-5
    else:
        assert (diff <= BF16_ATOL + BF16_RTOL * np.abs(want)).all()
    for row, n in enumerate(kv_length):
        if n == 0:
            assert float(got[row].abs().max()) == 0.0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_split_plain_with_one_split_is_the_plain_version(dtype):
    """One key range is the plain version over 64-key blocks, bit for bit:
    the combine of a single partial is the division itself."""
    rng = np.random.default_rng(5)
    q = torch.from_numpy(rng.standard_normal((3, 1, 8, 16)).astype(np.float32)).to(dtype)
    k = torch.from_numpy(rng.standard_normal((3, 150, 2, 16)).astype(np.float32)).to(dtype)
    v = torch.from_numpy(rng.standard_normal((3, 150, 2, 16)).astype(np.float32)).to(dtype)
    lengths = torch.tensor([150, 3, 0], dtype=torch.int32)
    got = K.flash_attention_split_plain(q, k, v, kv_length=lengths, split_keys=192)
    want = K.flash_attention_plain(q, k, v, causal=False, kv_length=lengths, block_kv=64)
    assert torch.equal(got, want)


@pytest.mark.parametrize("Tk, pairs", [(4128, 16), (1056, 16), (130, 6), (64, 1), (1, 300)])
def test_decode_split_fills_the_card(Tk, pairs):
    """Whole 64-key tiles, every key covered, and two blocks per SM of an
    H100 wherever the cache has enough tiles."""
    n_split, split_keys = K.decode_split(Tk, pairs)
    assert split_keys % 64 == 0 and n_split * split_keys >= Tk
    assert (n_split - 1) * split_keys < Tk
    tiles = -(-Tk // 64)
    assert n_split * pairs >= min(2 * 132, tiles * pairs)


def test_decode_split_at_the_main_path_shape():
    """glm4-9b's decode: 8 slots x 2 kv heads over a 4128-key cache."""
    n_split, split_keys = K.decode_split(4128, 8 * 2)
    assert (n_split, split_keys) == (22, 192)
    assert n_split * 8 * 2 >= 264


def test_wrapper_counts_every_kernel_key_at_zero_on_cpu():
    K.reset_launch_counts()
    q = torch.zeros((2, 1, 4, 8), dtype=torch.bfloat16)
    kv = torch.zeros((2, 70, 2, 8), dtype=torch.bfloat16)
    K.flash_attention(q, kv, kv, causal=False, kv_length=torch.tensor([3, 70]))
    K.flash_attention(q.float(), kv.float(), kv.float(), causal=False)
    assert set(K.LAUNCHES) == {"flash_attention", "flash_attention_prefill",
                               "flash_attention_decode", "flash_attention_combine",
                               "flash_attention_f32", "flash_attention_prefill_lse",
                               "flash_attention_f32_lse"}
    assert not any(K.LAUNCHES.values()) and not any(K.PLAIN_CUDA_CALLS.values())
    with pytest.raises(ValueError, match="multiple of 64"):
        K.flash_attention_split_plain(q, kv, kv, split_keys=100)
