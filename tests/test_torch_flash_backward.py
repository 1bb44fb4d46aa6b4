"""K4's training backward on the CPU: the tiled mirrors of the backward
kernels (``csrc/flash_backward.cu``, bf16; ``csrc/flash_backward_f32.cu``,
float32), the route that picks them, and the registered op
``repro_torch::flash_attention_backward`` over fake tensors.

The kernels run only on the card (``tests/test_torch_cuda.py`` holds them
against both plain versions there).  Here:

* :func:`flash_attention_backward_tiled_plain`, the kernels' arithmetic
  (64-row and 64-key tiles, ``p`` and ``ds`` rounded to bf16 before their
  products, the kernels' order of sums: the long route's, and the short
  route's at SASRec's sequences of 50, D = 50), on bf16 inputs against
  ``jax.vjp`` of the reference's ``layers.flash_attention`` (its custom
  VJP, ``_flash_train_bwd``, which keeps ``p`` and ``ds`` in float32):
  each gradient within ``BF16_L2`` relative L2 error and ``BF16_MAX`` of
  its largest element (each product term moves by up to 2^-9 where ``p``
  or ``ds`` is rounded, and the bf16 outputs by as much);
* the same mirror with the rounding off, float32 throughout, against
  :func:`flash_attention_backward_plain` within ``rtol=1e-5,
  atol=1e-6`` (the same products, summed in another order);
* :func:`flash_attention_backward_f32_tiled_plain`, the float32 kernel's
  arithmetic (32-key dK / dV tiles over 32-row chunks in row splits,
  32-row dQ tiles over 32-key tiles in key splits, each tile's walk split
  over the 4 ranks of a cluster and the shares added in rank order), on
  float32 inputs against
  ``jax.vjp`` of the reference's ``layers.flash_attention`` in float32,
  and against :func:`flash_attention_backward_plain`, both within
  ``rtol=F32_RTOL`` and ``atol=F32_ATOL`` times the gradient's largest
  element (float32 on both sides: only the order of sums and ``exp``'s
  last bits differ, ~2e-7 of the largest element; an element that is a
  sum cancelling to near zero keeps the error of its large terms, so the
  absolute bound scales with them);
* :func:`backward_route` for the dtype and training shapes of every arch
  the port trains, and the op traced over fake CUDA tensors on both
  routes: shapes, the workspace :func:`backward_workspace` gives, FLOPs
  ``10 B H D causal_pairs``; ``FlashAttentionFn``'s backward through it
  over fake tensors.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.utils._python_dispatch

from repro.models import layers as jlayers
from repro_torch.kernels import flash_attention as FA

BF16_L2, BF16_MAX = 0.01, 0.02
F32_RTOL, F32_ATOL = 1e-5, 1e-6

# (B, T, H, KV, D, causal): D 64 and 128, narrow and ragged T, G 1, 3, 16
CASES = [
    (1, 16, 16, 1, 128, True),
    (2, 37, 3, 1, 64, True),
    (1, 37, 16, 1, 64, False),
    (2, 37, 6, 2, 128, True),
    (1, 70, 3, 3, 64, True),
    (2, 23, 48, 3, 64, False),
    # the short route's (one kv head, a sequence one tile): SASRec's 50
    # positions at D = 50, odd and even sequence counts
    (1, 50, 1, 1, 50, True),
    (2, 50, 1, 1, 50, True),
    (3, 50, 1, 1, 50, True),
    (3, 50, 1, 1, 50, False),
    # the long route over several key tiles
    (1, 300, 4, 2, 64, True),
    (1, 200, 2, 1, 128, False),
]
SHORT_CASES = CASES[6:10]
LONG_CASES = CASES[10:]
# the float32 kernel's (B, T, H, KV, D, causal): rows not a whole tile or
# chunk, G = 1, 2, 4, D 64 and 128, D not a multiple of 4 (50, 7), D
# between the padded widths (100), not causal; lm-100m's training
# attention last
F32_CASES = [
    (2, 37, 2, 2, 64, True),
    (1, 45, 4, 2, 64, False),
    (2, 23, 8, 2, 128, True),
    (1, 50, 4, 1, 50, True),
    (1, 33, 2, 1, 7, False),
    (1, 70, 8, 4, 100, True),
    (4, 128, 8, 4, 64, True),
    # the cluster split's edges: key tile 0's 5 chunks over 4 ranks
    # (1, 1, 1, 2), a dQ tile whose 2 key tiles leave 2 ranks idle; G = 8
    # at both padded widths, causal and not
    (1, 75, 2, 1, 64, True),
    (2, 23, 8, 1, 128, True),
    (1, 40, 16, 2, 64, False),
]


def _inputs(case):
    B, T, H, KV, D, _ = case
    rng = np.random.default_rng(T * 131 + H * 7 + D)
    q, do = (rng.standard_normal((B, T, H, D)).astype(np.float32) for _ in range(2))
    k, v = (rng.standard_normal((B, T, KV, D)).astype(np.float32) for _ in range(2))
    return q, k, v, do


def _bf16(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(a).to(torch.bfloat16)


def _f32_close(got: torch.Tensor, want: torch.Tensor) -> None:
    torch.testing.assert_close(got, want, rtol=F32_RTOL,
                               atol=F32_ATOL * max(1.0, float(want.abs().max())))


def _rel(got: torch.Tensor, want: np.ndarray):
    a, b = got.float().numpy(), np.asarray(want, dtype=np.float32)
    return (float(np.linalg.norm(a - b) / np.linalg.norm(b)),
            float(np.abs(a - b).max() / np.abs(b).max()))


@pytest.mark.parametrize("case", CASES, ids=[str(c).replace(" ", "") for c in CASES])
def test_tiled_mirror_bf16_matches_reference_vjp(case):
    B, T, H, KV, D, causal = case
    q, k, v, do = _inputs(case)

    def f(a, b, c):
        return jlayers.flash_attention(a, b, c, causal=causal)

    jq, jk, jv, jdo = (jnp.asarray(a, dtype=jnp.bfloat16) for a in (q, k, v, do))
    _, vjp = jax.vjp(f, jq, jk, jv)
    wants = vjp(jdo)
    tq, tk, tv, tdo = (_bf16(a) for a in (q, k, v, do))
    out, lse = FA.flash_attention_plain(tq, tk, tv, causal=causal, return_lse=True)
    got = FA.flash_attention_backward_tiled_plain(tq, tk, tv, out, lse, tdo, causal=causal)
    for name, g, w in zip(("dq", "dk", "dv"), got, wants):
        assert g.dtype == torch.bfloat16
        l2, worst = _rel(g, np.asarray(w.astype(jnp.float32)))
        assert l2 <= BF16_L2 and worst <= BF16_MAX, (name, l2, worst)


@pytest.mark.parametrize("splits", [1, 2, 5])
@pytest.mark.parametrize("case", CASES[1:4], ids=[str(c).replace(" ", "") for c in CASES[1:4]])
def test_tiled_mirror_unrounded_is_the_plain_backward(case, splits):
    B, T, H, KV, D, causal = case
    q, k, v, do = (torch.from_numpy(a) for a in _inputs(case))
    out, lse = FA.flash_attention_plain(q, k, v, causal=causal, return_lse=True)
    want = FA.flash_attention_backward_plain(q, k, v, out, lse, do, causal=causal,
                                             block_q=16, block_kv=32)
    got = FA.flash_attention_backward_tiled_plain(q, k, v, out, lse, do, causal=causal,
                                                  splits=splits, rounding=False)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("case", SHORT_CASES + LONG_CASES,
                         ids=[str(c).replace(" ", "") for c in SHORT_CASES + LONG_CASES])
def test_tiled_mirror_unrounded_on_each_route_is_the_plain_backward(case):
    """The short route's order (one tile a sequence: each gradient one
    product) and the long route's over several key tiles, float32
    throughout, against the plain backward at its default and its small
    blocks."""
    B, T, H, KV, D, causal = case
    assert FA.backward_route(torch.bfloat16, (B, T, H, D), (B, T, KV, D)) == "kernel"
    q, k, v, do = (torch.from_numpy(a) for a in _inputs(case))
    out, lse = FA.flash_attention_plain(q, k, v, causal=causal, return_lse=True)
    got = FA.flash_attention_backward_tiled_plain(q, k, v, out, lse, do, causal=causal,
                                                  rounding=False)
    for blocks in ((512, 1024), (16, 32)):
        want = FA.flash_attention_backward_plain(q, k, v, out, lse, do, causal=causal,
                                                 block_q=blocks[0], block_kv=blocks[1])
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-6)


# The long route's row tiles (floor(64 / G) positions) and key tiles
# (a dK / dV block's 128 keys at D = 128, 64 at 64; the dQ kernel's 128):
# (B, Tq, Tk, H, KV, D, causal) at G = 1, 3 and 16, both head dims, Tq
# not a multiple of the row tile, Tk past Tq and past one key tile
RETILE_CASES = [
    (1, 70, 70, 2, 2, 128, True),      # G = 1: two row tiles, the second of 6 positions
    (1, 50, 90, 6, 2, 64, True),       # G = 3: 63-row tiles of 21 positions, Tk > Tq
    (1, 37, 80, 16, 1, 128, False),    # G = 16: 4 positions a tile, Tk > Tq
    (2, 30, 130, 3, 1, 128, True),     # Tk past one 128-key tile
]


def _retile_inputs(case):
    B, Tq, Tk, H, KV, D, _ = case
    rng = np.random.default_rng(Tq * 7 + Tk + H + D)
    q, do = (rng.standard_normal((B, Tq, H, D)).astype(np.float32) for _ in range(2))
    k, v = (rng.standard_normal((B, Tk, KV, D)).astype(np.float32) for _ in range(2))
    return q, k, v, do


@pytest.mark.parametrize("case", RETILE_CASES, ids=[str(c).replace(" ", "") for c in RETILE_CASES])
def test_retiled_mirror_matches_reference_vjp(case):
    """The wgmma kernels' tiles on bf16 inputs against ``jax.vjp`` of the
    reference (its ``_flash_train_bwd``), Tk past Tq included."""
    B, Tq, Tk, H, KV, D, causal = case
    q, k, v, do = _retile_inputs(case)

    def f(a, b, c):
        return jlayers.flash_attention(a, b, c, causal=causal)

    _, vjp = jax.vjp(f, *(jnp.asarray(a, dtype=jnp.bfloat16) for a in (q, k, v)))
    wants = vjp(jnp.asarray(do, dtype=jnp.bfloat16))
    tq, tk, tv, tdo = (_bf16(a) for a in (q, k, v, do))
    out, lse = FA.flash_attention_plain(tq, tk, tv, causal=causal, return_lse=True)
    got = FA.flash_attention_backward_tiled_plain(tq, tk, tv, out, lse, tdo, causal=causal)
    for name, g, w in zip(("dq", "dk", "dv"), got, wants):
        l2, worst = _rel(g, np.asarray(w.astype(jnp.float32)))
        assert l2 <= BF16_L2 and worst <= BF16_MAX, (name, l2, worst)


@pytest.mark.parametrize("splits", [1, 2, 5])
@pytest.mark.parametrize("case", [(1, 130, 130, 16, 1, 128, True), (1, 100, 150, 3, 1, 64, True),
                                  (2, 45, 45, 4, 2, 64, False)],
                         ids=["G16-33tiles", "G3-Tk150", "G2-noncausal"])
def test_retiled_mirror_unrounded_at_each_split_count(case, splits):
    """Runs of row tiles cut where the dK / dV kernel cuts them (each key
    tile's walk from its diagonal tile), float32 throughout: the plain
    backward's gradients at every split count (the float32 tolerance of
    the float32 kernel's mirror: only the order of sums differs)."""
    B, Tq, Tk, H, KV, D, causal = case
    q, k, v, do = (torch.from_numpy(a) for a in _retile_inputs(case))
    out, lse = FA.flash_attention_plain(q, k, v, causal=causal, return_lse=True)
    want = FA.flash_attention_backward_plain(q, k, v, out, lse, do, causal=causal)
    got = FA.flash_attention_backward_tiled_plain(q, k, v, out, lse, do, causal=causal,
                                                  splits=splits, rounding=False)
    for g, w in zip(got, want):   # dK sums 2,080 terms at G = 16: atol by the largest
        _f32_close(g, w)


def test_tiled_mirror_with_more_keys_than_queries():
    """Tk > Tq (no cache: the queries sit at positions 0 .. Tq - 1), causal
    and not: the keys no query sees get zero gradients."""
    rng = np.random.default_rng(3)
    q, do = (torch.from_numpy(rng.standard_normal((2, 30, 4, 64)).astype(np.float32))
             for _ in range(2))
    k, v = (torch.from_numpy(rng.standard_normal((2, 90, 2, 64)).astype(np.float32))
            for _ in range(2))
    for causal in (True, False):
        out, lse = FA.flash_attention_plain(q, k, v, causal=causal, return_lse=True)
        want = FA.flash_attention_backward_plain(q, k, v, out, lse, do, causal=causal)
        got = FA.flash_attention_backward_tiled_plain(q, k, v, out, lse, do, causal=causal,
                                                      rounding=False)
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-6)
        if causal:
            assert float(got[1][:, 30:].abs().max()) == 0.0
            assert float(got[2][:, 30:].abs().max()) == 0.0


@pytest.mark.parametrize("arch,route", [
    ("glm4-9b", "kernel"), ("granite-moe-3b-a800m", "kernel"), ("llama3-405b", "kernel"),
    ("yi-9b", "kernel"), ("moonshot-v1-16b-a3b", "kernel"), ("sasrec", "kernel"),
    ("lm-100m", "kernel"),
])
def test_backward_route_of_each_trained_arch(arch, route):
    """Each arch's training attention: the LMs' 4096-token batch rows,
    SASRec's ``train_batch`` (65,536 sequences of 50, one head, D = 50),
    lm-100m's 4 x 128 tokens in float32."""
    from repro_torch.models.transformer import torch_dtype

    if arch == "lm-100m":
        from repro_torch.launch.train_lm import model_100m

        cfg = model_100m(log=lambda line: None)
        dtype, T, B = torch_dtype(cfg.dtype), 128, 4
        H, KV, D = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    elif arch == "sasrec":
        from repro_torch.configs import sasrec

        cfg = sasrec.CONFIG
        dtype, T, B, H, KV, D = torch_dtype(cfg.dtype), cfg.seq_len, 65_536, 1, 1, cfg.d
    else:
        from repro_torch.configs import registry

        cfg = registry.get_arch(arch).CONFIG
        dtype, T, B = torch_dtype(cfg.dtype), 4096, 1
        H, KV, D = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    assert FA.backward_route(dtype, (B, T, H, D), (B, T, KV, D)) == route
    if route == "kernel":
        want = {"sasrec": "short", "lm-100m": "f32"}.get(arch, "long")
        assert FA._backward_kernel(dtype, (B, T, H, D), (B, T, KV, D)) == want


@pytest.mark.parametrize("dtype,D,route", [
    (torch.bfloat16, 64, "kernel"), (torch.bfloat16, 128, "kernel"),
    (torch.bfloat16, 50, "plain"), (torch.bfloat16, 96, "plain"),
    (torch.float32, 64, "kernel"), (torch.float32, 128, "kernel"), (torch.float16, 64, "plain"),
])
def test_backward_route_by_dtype_and_head_dim(dtype, D, route):
    """Long sequences (4096 positions, 8 heads over 2): in bf16 only the
    long route's head dims take a kernel; float32 takes the float32
    kernel at any head dim up to 128."""
    assert FA.backward_route(dtype, (1, 4096, 8, D), (1, 4096, 2, D)) == route


@pytest.mark.parametrize("Tq,Tk,H,KV,D,dtype,kernel", [
    (50, 50, 1, 1, 50, torch.bfloat16, "short"),
    (64, 64, 1, 1, 64, torch.bfloat16, "short"),
    (32, 32, 2, 1, 17, torch.bfloat16, "short"),
    (1, 1, 1, 1, 1, torch.bfloat16, "short"),
    (65, 65, 1, 1, 50, torch.bfloat16, None),       # past one tile
    (50, 50, 2, 1, 50, torch.bfloat16, None),       # 100 rows a sequence
    (50, 50, 2, 2, 50, torch.bfloat16, None),       # two kv heads
    (50, 60, 1, 1, 50, torch.bfloat16, None),       # keys past the queries
    (50, 50, 1, 1, 50, torch.float32, "f32"),
    (50, 50, 1, 1, 128, torch.bfloat16, "long"),
    (50, 50, 2, 2, 64, torch.bfloat16, "long"),
])
def test_backward_kernel_of_short_sequences(Tq, Tk, H, KV, D, dtype, kernel):
    got = FA._backward_kernel(dtype, (3, Tq, H, D), (3, Tk, KV, D))
    assert got == kernel
    assert FA.backward_route(dtype, (3, Tq, H, D), (3, Tk, KV, D)) == (
        "kernel" if kernel else "plain")


def test_backward_splits_and_workspace_at_the_training_shapes():
    # glm4-9b: 64 key tiles x 2 kv heads = 128 blocks, three an SM take 4 runs
    assert FA.backward_splits(1, 4096, 4096, 32, 2) == 4
    # granite: 64 x 8 = 512 blocks, 1 run
    assert FA.backward_splits(1, 4096, 4096, 24, 8) == 1
    # never more runs than row tiles, nor than 8; at least 1
    assert FA.backward_splits(1, 10, 10, 2, 2) == 1
    assert FA.backward_splits(1, 2048, 2048, 64, 1) == 8
    assert FA.backward_splits(64, 4096, 4096, 32, 8) == 1
    rows = 4096 * 16
    assert FA.backward_workspace(1, 4096, 4096, 32, 2, 128, 5, torch.bfloat16) == (
        2 * 2 * rows + 2 * 5 * 4096 * 2 * 128)
    assert FA.backward_workspace(2, 37, 37, 6, 2, 64, 1, torch.bfloat16) == 2 * 2 * 2 * 128
    # the short route (SASRec's train_batch) needs none, nor does the
    # float32 kernel at any shape (lm-100m's; glm4-9b's heads)
    assert FA.backward_workspace(65_536, 50, 50, 1, 1, 50, 1, torch.bfloat16) == 0
    assert FA.backward_workspace(4, 128, 128, 8, 4, 64, 1, torch.float32) == 0
    assert FA.backward_workspace(1, 4096, 4096, 32, 2, 128, 4, torch.float32) == 0


@pytest.mark.parametrize("case", [(1, 4096, 32, 2, 128, True), (2, 37, 6, 2, 64, True),
                                  (3, 50, 24, 8, 64, False), (65_536, 50, 1, 1, 50, True),
                                  (3, 20, 2, 1, 16, False)])
def test_backward_op_fake_shapes_workspace_and_flops(case):
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils.flop_counter import FlopCounterMode

    B, T, H, KV, D, causal = case
    with FakeTensorMode():
        q = torch.empty(B, T, H, D, dtype=torch.bfloat16, device="cuda")
        k = torch.empty(B, T, KV, D, dtype=torch.bfloat16, device="cuda")
        lse = torch.empty(B, T, H, dtype=torch.float32, device="cuda")
        with FlopCounterMode(display=False) as fc:
            dq, dk, dv, work = FA.flash_attention_backward_op(q, k, k, q, lse, q, causal,
                                                               512, 1024)
    assert (dq.shape, dk.shape, dv.shape) == (q.shape, k.shape, k.shape)
    assert {t.dtype for t in (dq, dk, dv)} == {torch.bfloat16}
    assert dq.device.type == "cuda" and work.dtype == torch.float32
    splits = FA.backward_splits(B, T, T, H, KV)
    assert work.numel() == FA.backward_workspace(B, T, T, H, KV, D, splits, torch.bfloat16)
    assert fc.get_total_flops() == 10 * B * H * D * FA.causal_pairs(T, T, 0, causal)


@pytest.mark.parametrize("case", [(4, 128, 8, 4, 64, True), (2, 37, 6, 2, 128, False),
                                  (1, 4096, 32, 2, 128, True), (3, 50, 4, 1, 7, True)])
def test_backward_op_fake_float32_shapes_workspace_and_flops(case):
    """The float32 route over fake CUDA tensors (lm-100m's shape first):
    float32 gradients of the inputs' shapes, no workspace, FLOPs ``10 B H D
    causal_pairs``."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils.flop_counter import FlopCounterMode

    B, T, H, KV, D, causal = case
    assert FA._backward_kernel(torch.float32, (B, T, H, D), (B, T, KV, D)) == "f32"
    with FakeTensorMode():
        q = torch.empty(B, T, H, D, dtype=torch.float32, device="cuda")
        k = torch.empty(B, T, KV, D, dtype=torch.float32, device="cuda")
        lse = torch.empty(B, T, H, dtype=torch.float32, device="cuda")
        with FlopCounterMode(display=False) as fc:
            dq, dk, dv, work = FA.flash_attention_backward_op(q, k, k, q, lse, q, causal,
                                                               512, 1024)
    assert (dq.shape, dk.shape, dv.shape) == (q.shape, k.shape, k.shape)
    assert {t.dtype for t in (dq, dk, dv)} == {torch.float32}
    assert dq.device.type == "cuda" and work.shape == (0,)
    assert fc.get_total_flops() == 10 * B * H * D * FA.causal_pairs(T, T, 0, causal)


@pytest.mark.parametrize("case", F32_CASES, ids=[str(c).replace(" ", "") for c in F32_CASES])
def test_f32_mirror_matches_reference_vjp(case):
    """The float32 kernel's arithmetic against the reference's custom VJP
    (``_flash_train_bwd``) in float32, on the same numpy-seeded inputs."""
    B, T, H, KV, D, causal = case
    q, k, v, do = _inputs(case)

    def f(a, b, c):
        return jlayers.flash_attention(a, b, c, causal=causal)

    _, vjp = jax.vjp(f, *(jnp.asarray(a) for a in (q, k, v)))
    wants = vjp(jnp.asarray(do))
    tq, tk, tv, tdo = (torch.from_numpy(a) for a in (q, k, v, do))
    out, lse = FA.flash_attention_plain(tq, tk, tv, causal=causal, return_lse=True)
    got = FA.flash_attention_backward_f32_tiled_plain(tq, tk, tv, out, lse, tdo, causal=causal)
    for g, w in zip(got, wants):
        assert g.dtype == torch.float32
        _f32_close(g, torch.from_numpy(np.array(w)))


@pytest.mark.parametrize("case", F32_CASES + [(2, 30, 4, 2, 64, True, 90),
                                              (1, 20, 2, 1, 7, False, 45)],
                         ids=[str(c).replace(" ", "") for c in F32_CASES] + ["keys90", "keys45"])
def test_f32_mirror_is_the_plain_backward(case):
    """The float32 kernel's arithmetic against the plain backward at its
    default and its small blocks, and with more keys than queries (the
    keys no query sees get zero gradients under causal)."""
    B, T, H, KV, D, causal = case[:6]
    Tk = case[6] if len(case) > 6 else T
    rng = np.random.default_rng(T * 7 + Tk + D)
    q, do = (torch.from_numpy(rng.standard_normal((B, T, H, D)).astype(np.float32))
             for _ in range(2))
    k, v = (torch.from_numpy(rng.standard_normal((B, Tk, KV, D)).astype(np.float32))
            for _ in range(2))
    out, lse = FA.flash_attention_plain(q, k, v, causal=causal, return_lse=True)
    got = FA.flash_attention_backward_f32_tiled_plain(q, k, v, out, lse, do, causal=causal)
    for blocks in ((512, 1024), (16, 32)):
        want = FA.flash_attention_backward_plain(q, k, v, out, lse, do, causal=causal,
                                                 block_q=blocks[0], block_kv=blocks[1])
        for g, w in zip(got, want):
            _f32_close(g, w)
    if causal and Tk > T:
        assert float(got[1][:, T:].abs().max()) == 0.0
        assert float(got[2][:, T:].abs().max()) == 0.0


def test_backward_op_on_the_cpu_is_the_plain_version_bit_for_bit():
    rng = np.random.default_rng(4)
    q, do = (torch.from_numpy(rng.standard_normal((2, 9, 4, 64)).astype(np.float32))
             .to(torch.bfloat16) for _ in range(2))
    k, v = (torch.from_numpy(rng.standard_normal((2, 9, 2, 64)).astype(np.float32))
            .to(torch.bfloat16) for _ in range(2))
    out, lse = FA.flash_attention_plain(q, k, v, causal=True, return_lse=True)
    dq, dk, dv, work = FA.flash_attention_backward_op(q, k, v, out, lse, do, True, 4, 8)
    want = FA.flash_attention_backward_plain(q, k, v, out, lse, do, causal=True, block_q=4,
                                             block_kv=8)
    assert all(torch.equal(a, b) for a, b in zip((dq, dk, dv), want))
    assert work.shape == (0,)


@pytest.mark.parametrize("dtype,D,T,H,KV,through_op", [
    (torch.bfloat16, 128, 96, 6, 2, True), (torch.bfloat16, 64, 96, 6, 2, True),
    (torch.bfloat16, 50, 96, 6, 2, False), (torch.float32, 64, 96, 6, 2, True),
    (torch.bfloat16, 50, 50, 1, 1, True), (torch.bfloat16, 50, 70, 1, 1, False),
])
def test_training_backward_goes_through_the_route(dtype, D, T, H, KV, through_op):
    """``FlashAttentionFn``'s backward over fake tensors (a dry-run's trace;
    fake CPU tensors, since autograd's engine needs a card for fake CUDA
    ones): the kernels' op where the route says so (the long route's head
    dims, the short route's SASRec sequences, float32 at any head dim),
    counted at the FLOP formula; the plain backward's einsums otherwise."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils.flop_counter import FlopCounterMode

    B = 1
    ops = []

    class Record(torch.utils._python_dispatch.TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            ops.append(str(func._overloadpacket))
            return func(*args, **(kwargs or {}))

    with FakeTensorMode():
        q = torch.empty(B, T, H, D, dtype=dtype, requires_grad=True)
        k = torch.empty(B, T, KV, D, dtype=dtype, requires_grad=True)
        v = torch.empty(B, T, KV, D, dtype=dtype, requires_grad=True)
        out = FA.flash_attention(q, k, v, causal=True)
        with FlopCounterMode(display=False) as fc, Record():
            out.backward(torch.ones_like(out))
        assert q.grad.shape == q.shape and k.grad.shape == k.shape
    assert ("repro_torch.flash_attention_backward" in ops) == through_op
    if through_op:
        assert fc.get_total_flops() == 10 * B * H * D * FA.causal_pairs(T, T, 0, True)
