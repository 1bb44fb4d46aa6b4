"""The CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked ``cuda`` and skips without an NVIDIA GPU.  The
file imports neither JAX nor the JAX package, so it runs where only the
port is installed; the suite's ``conftest.py`` imports the JAX package,
so on such a machine run it as

    python -m pytest -q --noconftest tests/test_torch_cuda.py

Operands come from the port's own host half (a small DBLP catalog,
extracted, corrected and packed); frontiers are integer-valued (with
``inf`` / ``-inf`` where the op allows), so kernel and plain version must
agree bit for bit.  Float frontiers agree to float32 round-off: the
kernels add in another order than ``index_add_``.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import dedup, engine, extract
from repro_torch.core.condensed import BipartiteEdges
from repro_torch.data.synth import dblp_catalog
from repro_torch.kernels import bitmap_spmm as K
from repro_torch.kernels.pack import TILE, pack_bipartite

pytestmark = pytest.mark.cuda

Q1 = """
Nodes(ID, Name) :- Author(ID, Name).
Edges(ID1, ID2) :- AuthorPub(ID1, PubID), AuthorPub(ID2, PubID).
"""

ZERO = {"sum": 0.0, "min": float("inf"), "max": 0.0}


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels run only on the card")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def packed(card):
    g = extract(dblp_catalog(700, 1200, 6.0, seed=5), Q1).graph
    corr = dedup.build_correction(g)
    return engine.to_device_packed(g, correction=corr, backend="cuda", device=card)


def _frontier(rng, n, feat, op):
    x = rng.integers(0, 7, (n, feat)).astype(np.float32)
    if op == "min":
        x[rng.random((n, feat)) < 0.5] = np.inf
    elif op == "max":
        x = (x > 3).astype(np.float32)
        x[rng.random((n, feat)) < 0.2] = -np.inf  # every -inf maps to zero
    return torch.from_numpy(x).cuda()


def _spmm_args(layer, reverse, x):
    ops = layer.rev if reverse else layer.fwd
    n_out = layer.n_src if reverse else layer.n_dst
    return (ops.slot_src, ops.slot_row, ops.row_start, ops.row_count, ops.bitmaps, x, n_out)


def _fused_args(dev, reverse, h, x):
    f = dev.fused_rev if reverse else dev.fused_fwd
    return (f.kind, f.main_src, f.corr_src, f.main_idx, f.corr_idx, f.slot_row,
            f.row_start, f.row_count, f.bitmaps, f.planes, h, x, f.n_out,
            f.plane_weights)


@pytest.mark.parametrize("feat", [8, 32, 40])
def test_cuda_kernels_match_plain(packed, feat):
    """K1 and K2 over both layers in both directions, and K3 in both
    directions, bit for bit against the plain versions; 40 features take
    two feature blocks, the second one mostly masked."""
    rng = np.random.default_rng(feat)
    for layer in packed.chains[0]:
        for reverse in (False, True):
            n_in = layer.n_dst if reverse else layer.n_src
            for op in ("sum", "min", "max"):
                args = _spmm_args(layer, reverse, _frontier(rng, n_in, feat, op))
                before = K.LAUNCHES[f"bitmap_spmm_{op}"]
                got = K.bitmap_spmm(*args, op=op, zero=ZERO[op])
                assert K.LAUNCHES[f"bitmap_spmm_{op}"] == before + 1
                assert torch.equal(got, K.bitmap_spmm_plain(*args, op=op, zero=ZERO[op]))
    for reverse in (False, True):
        chain = packed.chains[-1]
        n_h = chain[0].n_dst if reverse else chain[-1].n_src
        h = _frontier(rng, n_h, feat, "sum")
        x = _frontier(rng, packed.n_real, feat, "sum")
        fargs = _fused_args(packed, reverse, h, x)
        before = K.LAUNCHES["bitmap_spmm_fused"]
        got = K.bitmap_spmm_fused(*fargs)
        assert K.LAUNCHES["bitmap_spmm_fused"] == before + 1
        assert torch.equal(got, K.bitmap_spmm_fused_plain(*fargs))
    assert packed.fused_fwd.planes.shape[1] >= 2  # several bit-planes


@pytest.mark.parametrize("op", ["sum", "min", "max"])
def test_cuda_pad_slots_and_ragged_rows(card, op):
    """Empty upper row tiles (one all-zero pad slot each) come out as the
    semiring zero, and an output that ends inside a row tile is written
    up to its last row only."""
    rng = np.random.default_rng(11)
    key = np.unique(rng.integers(0, 90, 700) * 260 + rng.integers(0, 260, 700))
    s, d = key % 260, key // 260
    bsb = pack_bipartite(BipartiteEdges(s, d, 260, 450))
    ops = engine._upload_operands(bsb, card)
    x = _frontier(rng, 260, 8, op)
    for n_out in (450, bsb.n_row_tiles * TILE):
        args = (ops.slot_src, ops.slot_row, ops.row_start, ops.row_count,
                ops.bitmaps, x, n_out)
        got = K.bitmap_spmm(*args, op=op, zero=ZERO[op])
        assert got.shape == (n_out, 8)
        assert torch.equal(got, K.bitmap_spmm_plain(*args, op=op, zero=ZERO[op]))
        assert bool((got[128:] == ZERO[op]).all())


def test_cuda_float_frontiers_agree_to_roundoff(packed):
    rng = np.random.default_rng(3)
    layer = packed.chains[0][0]
    x = torch.from_numpy(rng.random((layer.n_src, 16)).astype(np.float32)).cuda()
    args = _spmm_args(layer, False, x)
    torch.testing.assert_close(K.bitmap_spmm(*args), K.bitmap_spmm_plain(*args),
                               rtol=1e-5, atol=1e-6)
    chain = packed.chains[-1]
    h = torch.from_numpy(rng.random((chain[-1].n_src, 16)).astype(np.float32)).cuda()
    xr = torch.from_numpy(rng.random((packed.n_real, 16)).astype(np.float32)).cuda()
    fargs = _fused_args(packed, False, h, xr)
    torch.testing.assert_close(K.bitmap_spmm_fused(*fargs),
                               K.bitmap_spmm_fused_plain(*fargs), rtol=1e-5, atol=1e-4)


def test_cuda_auto_dispatch_launches_and_matches_segment(packed):
    """``'auto'`` on an sm_90 card sends batched steps to the kernels and
    answers as the segment path does; elsewhere it takes the segment
    path."""
    import dataclasses

    rng = np.random.default_rng(9)
    x = _frontier(rng, packed.n_real, 8, "sum")
    auto = dataclasses.replace(packed, backend="auto")
    seg = dataclasses.replace(packed, backend="segment")
    K.reset_launch_counts()
    got = engine.propagate(auto, x)
    want = engine.propagate(seg, x)
    on_hopper = torch.cuda.get_device_capability() == (9, 0)
    assert (K.LAUNCHES["bitmap_spmm_sum"] > 0) == on_hopper
    assert (K.LAUNCHES["bitmap_spmm_fused"] > 0) == on_hopper
    assert torch.equal(got, want)


def test_wrapper_refuses_misaligned_words(packed):
    ops = packed.chains[0][0].fwd
    words = torch.empty(ops.bitmaps.numel() + 1, dtype=torch.int32, device="cuda")
    shifted = words[1:].view(ops.bitmaps.shape)
    x = torch.zeros((packed.chains[0][0].n_src, 8), device="cuda")
    with pytest.raises(ValueError, match="8-byte"):
        K.bitmap_spmm(ops.slot_src, ops.slot_row, ops.row_start, ops.row_count,
                      shifted, x, packed.chains[0][0].n_dst)


# ---------------------------------------------------------------------------
# K4: flash attention
# ---------------------------------------------------------------------------

FLASH_SWEEP = [
    # (B, T, H, KV, D, causal), the shapes of tests/test_kernels.py
    (1, 64, 2, 1, 8, True),
    (2, 128, 4, 2, 16, True),
    (1, 96, 4, 4, 8, False),
    (2, 100, 2, 1, 8, True),
    (1, 256, 8, 2, 32, True),
    (1, 300, 32, 2, 128, True),      # glm4-9b's heads, ragged q tiles
]

# (B, Tq, Tk, H, KV, D, causal, q_offset, kv_length)
FLASH_CACHE = [
    (1, 40, 96, 32, 2, 128, True, 0, [40]),           # prefill into a longer cache
    (2, 12, 64, 8, 2, 64, True, 20, [32, 32]),        # prefill after a prefix
    (4, 1, 130, 32, 2, 128, False, 0, [1, 33, 97, 130]),  # decode, ragged tails
    (2, 1, 40, 6, 2, 50, False, 0, [0, 17]),          # a row with no key; D = 50
]

# float32 with full-precision matmuls in the plain version; bf16 at the
# reference's bound (tests/test_kernels.py)
FLASH_TOL = {torch.float32: 2e-5, torch.bfloat16: 0.05}


def _qkv(seed, B, Tq, Tk, H, KV, D, dtype):
    g = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn((B, Tq, H, D), generator=g, device="cuda").to(dtype)
    k = torch.randn((B, Tk, KV, D), generator=g, device="cuda").to(dtype)
    v = torch.randn((B, Tk, KV, D), generator=g, device="cuda").to(dtype)
    return q, k, v


@pytest.fixture
def full_fp32():
    before = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield
    torch.backends.cuda.matmul.allow_tf32 = before


@pytest.mark.parametrize("shape", FLASH_SWEEP)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_cuda_flash_attention_sweep(card, full_fp32, shape, dtype):
    from repro_torch.kernels import flash_attention as FA

    B, T, H, KV, D, causal = shape
    q, k, v = _qkv(T + D, B, T, T, H, KV, D, dtype)
    before = FA.LAUNCHES["flash_attention"]
    got = FA.flash_attention(q, k, v, causal=causal)
    assert FA.LAUNCHES["flash_attention"] == before + 1
    want = FA.flash_attention_plain(q, k, v, causal=causal, block_q=64, block_kv=64)
    assert got.dtype == dtype
    assert float((got.float() - want.float()).abs().max()) < FLASH_TOL[dtype]


@pytest.mark.parametrize("case", FLASH_CACHE)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_cuda_flash_attention_cache_path(card, full_fp32, case, dtype):
    from repro_torch.kernels import flash_attention as FA

    B, Tq, Tk, H, KV, D, causal, q_offset, kv_length = case
    q, k, v = _qkv(Tk + D, B, Tq, Tk, H, KV, D, dtype)
    lengths = torch.tensor(kv_length, dtype=torch.int32, device="cuda")
    kw = dict(causal=causal, q_offset=q_offset, kv_length=lengths)
    got = FA.flash_attention(q, k, v, **kw)
    want = FA.flash_attention_plain(q, k, v, **kw)
    assert float((got.float() - want.float()).abs().max()) < FLASH_TOL[dtype]
    if 0 in kv_length:
        assert float(got[kv_length.index(0)].abs().max()) == 0.0


def test_cuda_batched_server_runs_k4_and_matches_cpu(card):
    """A small float32 model served on the card gives the CPU's tokens, and
    every attention call of the run launched K4: n_layers per prefill and
    per decode step; the plain version never ran on the card."""
    import dataclasses

    from repro_torch.configs import registry
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.models import transformer
    from repro_torch.serve.server import BatchedServer, Request

    cfg = dataclasses.replace(registry.get_arch("glm4-9b").SMOKE, dtype="float32")
    params = transformer.init_params(cfg, torch.Generator().manual_seed(0), "cpu")

    def to_card(tree):
        return {k: to_card(v) if isinstance(v, dict) else v.cuda() for k, v in tree.items()}

    on_card = to_card(params)

    def requests():
        rng = np.random.default_rng(0)
        return [Request(rid=i, prompt=rng.integers(0, cfg.vocab_size, size=int(n)),
                        max_new_tokens=5) for i, n in enumerate([7, 7, 4, 7])]

    want = BatchedServer(params, cfg, batch_slots=3, max_len=32).run(requests())
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        FA.reset_launch_counts()
        got = BatchedServer(on_card, cfg, batch_slots=3, max_len=32).run(requests())
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    assert got == want
    # 4 prefills; two batches of 4 decode steps each (max_new_tokens - 1)
    assert FA.LAUNCHES["flash_attention"] == cfg.n_layers * (4 + 2 * 4)
    assert FA.PLAIN_CUDA_CALLS["flash_attention"] == 0


# ---------------------------------------------------------------------------
# K4's bf16 kernels: tensor-core prefill, split-KV decode + combine
# ---------------------------------------------------------------------------

# element-wise bf16 bound against the plain version (chip_smoke.py's
# K4_BF16_ATOL / K4_BF16_RTOL): one output ulp relative, plus p rounded to
# bf16 against another running max than the plain version's
BF16_ATOL, BF16_RTOL = 2e-3, 2.0 ** -7
# against flash_attention_split_plain, which rounds p at the same points:
# one output ulp, plus the rare p whose bf16 rounding flips because the
# two add the same products in another order (a few 1e-4 at 17 keys)
SPLIT_ATOL = 5e-4


def _within(got, want, atol, rtol=BF16_RTOL):
    diff = (got.float() - want.float()).abs()
    excess = float((diff - atol - rtol * want.float().abs()).max())
    assert excess <= 0.0, f"exceeds {atol} + {rtol} |want| by {excess}"


@pytest.mark.parametrize("D", [8, 16, 64, 128])
@pytest.mark.parametrize("G", [1, 2, 16])
def test_cuda_prefill_kernel_matches_plain(card, D, G):
    """A causal prefill of 100 positions (not a multiple of any tile) after
    30 cached ones, over a 160-position cache with a ragged valid prefix."""
    from repro_torch.kernels import flash_attention as FA

    KV, T, q_offset, Tk = 2, 100, 30, 160
    q, k, v = _qkv(D * 7 + G, 2, T, Tk, G * KV, KV, D, torch.bfloat16)
    lengths = torch.tensor([q_offset + T, q_offset + T - 9], dtype=torch.int32, device="cuda")
    kw = dict(causal=True, q_offset=q_offset, kv_length=lengths)
    before = dict(FA.LAUNCHES)
    got = FA.flash_attention(q, k, v, **kw)
    assert FA.LAUNCHES["flash_attention_prefill"] == before["flash_attention_prefill"] + 1
    _within(got, FA.flash_attention_plain(q, k, v, **kw), BF16_ATOL)


@pytest.mark.parametrize("shape", [
    # (B, Tq, Tk, H, KV, D, causal, q_offset, kv_length)
    (1, 300, 4128, 32, 2, 128, True, 0, [300]),     # glm4-9b's heads, 8 positions a block
    (2, 65, 65, 4, 4, 128, False, 0, None),         # not causal, one key past a tile
    (1, 129, 129, 12, 2, 64, True, 0, None),        # G = 6: 126 of 128 rows in use
    (1, 40, 40, 128, 2, 50, True, 0, None),         # G = 64, D = 50 (element loads)
])
def test_cuda_prefill_kernel_edges(card, shape):
    from repro_torch.kernels import flash_attention as FA

    B, Tq, Tk, H, KV, D, causal, q_offset, kv_length = shape
    q, k, v = _qkv(Tq + D, B, Tq, Tk, H, KV, D, torch.bfloat16)
    lengths = (None if kv_length is None
               else torch.tensor(kv_length, dtype=torch.int32, device="cuda"))
    kw = dict(causal=causal, q_offset=q_offset, kv_length=lengths)
    _within(FA.flash_attention(q, k, v, **kw), FA.flash_attention_plain(q, k, v, **kw),
            BF16_ATOL)


# (name, B, Tk, H, KV, D, causal, q_offset, kv_length)
DECODE_CASES = [
    ("empty_row", 2, 200, 4, 1, 16, False, 0, [0, 150]),
    ("shorter_than_one_split", 1, 4128, 4, 1, 64, False, 0, [50]),
    ("not_a_multiple_of_the_split", 1, 4128, 16, 1, 128, False, 0, [3000]),
    ("ragged_rows", 4, 260, 8, 2, 16, False, 0, [1, 64, 129, 260]),
    ("g3_d50", 2, 40, 6, 2, 50, False, 0, [0, 17]),
    ("g32_two_head_chunks", 2, 300, 64, 2, 64, False, 0, [300, 201]),
    ("causal_one_query", 1, 200, 4, 1, 16, True, 90, [200]),
    ("main_path", 8, 4128, 32, 2, 128, False, 4099, [4100] * 8),
]


@pytest.mark.parametrize("case", DECODE_CASES, ids=[c[0] for c in DECODE_CASES])
def test_cuda_decode_kernel_matches_split_and_plain(card, case):
    """The split-KV kernel and its combine: close to the split plain version
    (the same rounding points) and within the element-wise bound of the
    plain version; a row with no valid key is 0."""
    from repro_torch.kernels import flash_attention as FA

    _, B, Tk, H, KV, D, causal, q_offset, kv_length = case
    q, k, v = _qkv(Tk + H + D, B, 1, Tk, H, KV, D, torch.bfloat16)
    lengths = torch.tensor(kv_length, dtype=torch.int32, device="cuda")
    kw = dict(causal=causal, q_offset=q_offset, kv_length=lengths)
    before = dict(FA.LAUNCHES)
    got = FA.flash_attention(q, k, v, **kw)
    assert FA.LAUNCHES["flash_attention_decode"] == before["flash_attention_decode"] + 1
    assert FA.LAUNCHES["flash_attention_combine"] == before["flash_attention_combine"] + 1
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    _, split_keys = FA.decode_split(Tk, B * KV * -(-(H // KV) // 16), n_sm)
    _within(got, FA.flash_attention_split_plain(q, k, v, split_keys=split_keys, **kw),
            SPLIT_ATOL)
    _within(got, FA.flash_attention_plain(q, k, v, **kw), BF16_ATOL)
    for row, n in enumerate(kv_length):
        if n == 0:
            assert float(got[row].abs().max()) == 0.0


def test_cuda_k4_launches_one_kernel_route_per_call(card):
    """bf16 Tq > 1: the prefill kernel; bf16 Tq == 1: the decode kernel and
    its combine; float32: the float32 kernel only.  Each call is one wrapper
    call."""
    from repro_torch.kernels import flash_attention as FA

    routes = [
        (torch.bfloat16, 5, {"flash_attention_prefill": 1}),
        (torch.bfloat16, 1, {"flash_attention_decode": 1, "flash_attention_combine": 1}),
        (torch.float32, 5, {"flash_attention_f32": 1}),
        (torch.float32, 1, {"flash_attention_f32": 1}),
    ]
    for dtype, Tq, kernels in routes:
        q, k, v = _qkv(1, 2, Tq, 70, 8, 2, 32, dtype)
        FA.reset_launch_counts()
        FA.flash_attention(q, k, v, causal=Tq > 1, q_offset=70 - Tq)
        torch.cuda.synchronize()
        want = {key: 0 for key in FA.LAUNCHES}
        want.update(kernels, flash_attention=1)
        assert FA.LAUNCHES == want, (dtype, Tq)
        assert FA.PLAIN_CUDA_CALLS["flash_attention"] == 0
