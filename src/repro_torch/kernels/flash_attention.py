"""GQA flash-attention forward: the CUDA kernels of K4, their wrapper and
their plain PyTorch versions.

:func:`flash_attention` is the attention of the port's LM path
(:mod:`repro_torch.models.layers` re-exports it).  It computes what the
JAX package's ``layers._flash_impl`` computes, which is the Pallas
``kernels/flash_attention.py::_kernel`` extended by ``q_offset`` (the
absolute position of ``q[:, 0]``) and ``kv_length`` (the valid key prefix
of each batch row): prefill into a KV cache (``causal=True``) and decode
(``Tq == 1``, ``causal=False``) over a ragged key tail alike.

A CPU tensor runs :func:`flash_attention_plain`.  A CUDA tensor launches
one of K4's kernels on the current stream, chosen by dtype and shape, or
raises: there is no fallback.  The launch is the registered op
``repro_torch::flash_attention`` (:func:`flash_attention_op`, returning
``(out, lse)``): its fake implementation lets a step be traced over fake
tensors (the dry-run), and its FLOP formula lets ``torch.utils.flop_counter``
count it.  Over a sharded KV cache, :func:`sharded_cached_attention` runs
the op on each rank's key range and :func:`combine_key_ranges` merges the
ranges.

========================  ==============================================
bfloat16, ``Tq > 1``      ``csrc/flash_prefill.cu``, by
                          :func:`prefill_route`: head dim 64 or 128,
                          aligned, one sequence a block (``'sm90'``:
                          every LM prefill and training forward): TMA
                          loads on mbarriers, warp-specialised wgmma,
                          128 query rows (192 at D = 64) of the G heads
                          of a kv head x 128- (96-) key tiles
                          (:func:`sm90_prefill_plan`); other multiples
                          of 8 (``'mma'``): mma.sync tensor cores, 128
                          rows x 64-key tiles; a head dim that is not a
                          multiple of 8, unaligned operands or short
                          sequences packed (``'relay'``,
                          :func:`prefill_pack`): mma.sync on operands
                          staged raw in 16-byte copies and re-laid in
                          shared memory
bfloat16, ``Tq == 1``     ``csrc/flash_decode.cu``: split-KV partials
                          over key ranges of whole 64-key tiles
                          (:func:`decode_split`), then a combine kernel
float32, any shape        ``csrc/flash_attention.cu``: CUDA-core FFMA
                          (plain TF32 tensor cores cannot hold 2e-5),
                          16, 32 or 64 query rows a block
                          (:func:`f32_block_rows`) x 64-key tiles
========================  ==============================================

Training (no cache: ``q_offset == 0``, ``kv_length is None``, and some
of ``q``, ``k``, ``v`` requiring grad, under grad mode) goes through
:class:`FlashAttentionFn`, the counterpart of the reference's custom-VJP
``layers._flash_train``: its forward launches the same kernels with a
log-sum-exp output (``lse``, natural log, ``+inf`` on a row whose every
key is masked).  Its backward computes the reference's
``_flash_train_bwd`` (XLA code, not a Pallas kernel), by the route
:func:`backward_route` picks from dtype and shapes, through the
registered op ``repro_torch::flash_attention_backward``
(:func:`flash_attention_backward_op`) on a CUDA tensor, a CPU tensor
holding data running :func:`flash_attention_backward_plain` (which
recomputes ``p`` block by block from ``lse``):

========================  ==============================================
bfloat16, ``Tq == Tk``,   the short route: one launch, each block
one kv head, ``Tq H <=    taking two whole sequences at a time, each one
64``, ``D <= 64``         64-row x 64-key tile (SASRec's 50 positions at
                          D = 50), staged raw and re-laid in shared
                          memory, the next two in flight meanwhile
bfloat16, D 64 or 128,    the long route (:func:`sm90_backward_plan`):
``H / KV <= 64``          row statistics in row tiles of ``floor(64 /
                          G)`` positions, a dK / dV kernel over key
                          tiles of 128 (64 at D = 64; its row tiles cut in
                          :func:`backward_splits` runs, added in order by
                          a reduce kernel), a dQ kernel over pairs of row
                          tiles; both TMA-fed, warp-specialised wgmma
                          (one producer warp, a consumer warpgroup for
                          each 64 keys or each row tile)
float32, any shape        ``csrc/flash_backward_f32.cu``: CUDA-core FFMA,
                          one launch of 4-block clusters, 32-key dK / dV
                          tiles walking the rows that see them and 32-row
                          dQ tiles walking the keys, each walk split over
                          its cluster's blocks and their shares added in
                          rank order (lm-100m's training)
========================  ==============================================

The bf16 routes are ``csrc/flash_backward.cu``'s.  A bfloat16 shape that
neither bf16 route takes (a head dim other than 64 / 128 past the short
route) runs the plain backward on the card.  No kernel route uses float
atomics, so the gradients repeat their bits.

A call with a cache that requires grad raises: no call goes through a
kernel without autograd.

``LAUNCHES['flash_attention']`` counts wrapper calls on the card, one
per attention call; ``flash_attention_prefill``, ``_decode``,
``_combine`` and ``_f32`` count each kernel's launches, and
``_prefill_lse`` / ``_f32_lse`` the launches that also write ``lse``
(training's forward); ``PREFILL_ROUTES`` counts the bf16 prefill's
launches (with or without ``lse``) by :func:`prefill_route`'s route.  ``flash_attention_backward`` counts backward
calls through the kernels, ``_short`` the short route's launches,
``_rowstat``, ``_dkdv``, ``_dq`` and ``_reduce`` (only where the dK / dV
rows are split) each long-route kernel's, and ``_f32`` the float32
kernel's.  A call of a plain forward on
a CUDA tensor (a comparison, never the wrapper) adds one to
``PLAIN_CUDA_CALLS['flash_attention']`` instead, so a run can show that
its attention went through the kernels;
each plain backward on the card adds one to
``PLAIN_CUDA_CALLS['flash_attention_backward']``.

Numbers: scores and softmax sums in float32, ``p`` rounded to the value
type before the P·V product, the output ``acc / max(l, 1e-20)`` cast to
``q.dtype``; a row whose every key is masked gives 0.  ``block_q`` and
``block_kv`` tile the plain version as they tile the reference; the
kernels use their own tiles (64 keys; on the sm90 route
:func:`sm90_block_kv`'s 128 or 96), which changes only the order of
float32 sums and where ``p`` is rounded:
``flash_attention_plain(block_kv=sm90_block_kv(D))`` has the sm90
kernel's rounding points.
:func:`flash_attention_split_plain` is the decode kernel's arithmetic in
plain PyTorch (``p`` rounded against each split's running max), and
:func:`flash_attention_backward_tiled_plain` the backward kernels' (the
long route's row tiles and key tiles, ``p`` and ``ds`` rounded to bf16
before their products, the kernels' order of sums, the short route's
included) and
:func:`flash_attention_backward_f32_tiled_plain` the float32 backward
kernel's (its 32-key and 32-row tiles, each walk split over 4 ranks,
float32 throughout), for the
tests and the smoke run; the main path never calls them.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
import torch.profiler

from ..distributed.sharding import is_dtensor

__all__ = [
    "LAUNCHES",
    "PLAIN_CUDA_CALLS",
    "reset_launch_counts",
    "decode_split",
    "f32_block_rows",
    "prefill_pack",
    "prefill_route",
    "sm90_prefill_plan",
    "sm90_block_kv",
    "PREFILL_ROUTES",
    "FlashAttentionFn",
    "flash_attention",
    "flash_attention_plain",
    "flash_attention_backward_plain",
    "flash_attention_backward_tiled_plain",
    "flash_attention_backward_f32_tiled_plain",
    "flash_attention_split_plain",
    "backward_route",
    "backward_splits",
    "sm90_backward_plan",
    "backward_workspace",
    "flash_attention_backward_op",
    "sharded_flash_attention",
    "flash_attention_op",
    "causal_pairs",
    "sharded_cached_attention",
    "combine_key_ranges",
]

# wrapper calls on the card, then each kernel's launches
LAUNCHES: Dict[str, int] = {
    "flash_attention": 0,
    "flash_attention_prefill": 0,
    "flash_attention_decode": 0,
    "flash_attention_combine": 0,
    "flash_attention_f32": 0,
    "flash_attention_prefill_lse": 0,
    "flash_attention_f32_lse": 0,
    "flash_attention_backward": 0,
    "flash_attention_backward_short": 0,
    "flash_attention_backward_rowstat": 0,
    "flash_attention_backward_dkdv": 0,
    "flash_attention_backward_dq": 0,
    "flash_attention_backward_reduce": 0,
    "flash_attention_backward_f32": 0,
}
# plain forwards and backwards on CUDA tensors: comparisons, and the
# backward of a bf16 shape no kernel route takes
PLAIN_CUDA_CALLS: Dict[str, int] = {"flash_attention": 0, "flash_attention_backward": 0}
# the bf16 prefill kernel's launches (``flash_attention_prefill`` and
# ``_prefill_lse`` together) by the route :func:`prefill_route` names
PREFILL_ROUTES: Dict[str, int] = {"sm90": 0, "mma": 0, "relay": 0}

_MAX_GROUP = 64      # query heads per kv head
_MAX_HEAD_DIM = 128
_TILE = 64           # keys per tile of the bf16 kernels
_DECODE_ROWS = 16    # query heads per block of the decode kernel
_PREFILL_ROWS = 128  # query rows a block of the bf16 prefill kernel
_F32_ROWS = (64, 32, 16)  # query rows a block of the float32 kernel may take
_LOG2E = 1.4426950408889634
_BWD_ROWS = 64       # slots of a row tile of the backward kernels; the short route's bound
_BWD_HEAD_DIMS = (64, 128)  # the long backward route's head dims (bf16)
_BWD_MAX_SPLITS = 8  # runs of row tiles a key tile of the dK / dV kernel is cut in
# the long route's wgmma kernels (csrc/flash_backward.cu, Config<DP>): keys
# a dK / dV block by head dim (64 a consumer warpgroup), stages of its Q /
# dO ring, keys a K / V tile of the dQ kernel; a dQ block takes two row tiles
_BWD_SM90_KEYS = {64: 64, 128: 128}
_BWD_SM90_STAGES = 3
_BWD_SM90_DQ_KEYS = 128
_BWD_SM90_DQ_TILES = 2
_SMEM_OPTIN = 232_448   # an H100 block's shared memory
_F32_BWD_KEYS = 32   # keys a dK / dV tile of the float32 backward kernel
_F32_BWD_CHUNK = 32  # query rows a chunk of that tile's walk
_F32_BWD_ROWS = 32   # query rows a dQ tile
_F32_BWD_TILE = 32   # keys a tile of a dQ tile's walk
_F32_BWD_CLUSTER = 4  # blocks of a cluster, over which a tile's walk is split
# the bf16 prefill's sm90 kernel (csrc/flash_prefill.cu, flash_prefill_sm90):
# the head dims it takes, and by head dim its consumer warpgroups of 64
# query rows, keys a K / V tile and stages of the K / V ring
_SM90_HEAD_DIMS = (64, 128)
_SM90_CONSUMERS = {64: 3, 128: 2}
_SM90_BKV = {64: 96, 128: 128}
_SM90_STAGES = {64: 3, 128: 3}
_SM90_PINGPONG = {64: True, 128: False}     # turns between the consumer warpgroups
_SM90_PERSISTENT = {64: False, 128: True}   # one block an SM walking the items
_SM90_ROW_BYTES = 128   # a 128-byte-swizzled tile row: 64 bf16 columns


def reset_launch_counts() -> None:
    for counts in (LAUNCHES, PLAIN_CUDA_CALLS, PREFILL_ROUTES):
        for key in counts:
            counts[key] = 0


def decode_split(Tk: int, pairs: int, n_sm: int = 132) -> Tuple[int, int]:
    """``(n_split, split_keys)`` of the split-KV decode kernel over a cache
    of ``Tk`` positions, for ``pairs`` blocks per key range (batch rows x kv
    heads x 16-head chunks).  Key ranges are whole 64-key tiles, as few as
    give ``n_split * pairs >= 2 * n_sm`` (two blocks per SM) where the
    cache has that many tiles.  From the cache's static length, never from
    ``kv_length``: that would need a device sync."""
    tiles = max(1, -(-Tk // _TILE))
    need = -(-2 * n_sm // max(1, pairs))
    per_split = max(1, tiles // need)
    return -(-tiles // per_split), _TILE * per_split


def _backward_kernel(dtype: torch.dtype, q_shape, k_shape) -> Optional[str]:
    """The backward kernel route that takes q of ``q_shape`` ``(B, Tq, H,
    D)`` and k of ``k_shape`` ``(B, Tk, KV, D)``: ``'f32'`` (float32, ``0 <
    D <= 128``, ``H / KV <= 64``: ``csrc/flash_backward_f32.cu``), or one
    of ``csrc/flash_backward.cu``'s: ``'short'`` (bfloat16, ``Tq == Tk``,
    one kv head, ``Tq H <= 64``, ``D <= 64``: a sequence is one tile),
    ``'long'`` (bfloat16 at head dim 64 or 128); else None."""
    B, Tq, H, D = q_shape
    Tk, KV = k_shape[1], k_shape[2]
    if min(B, Tq, Tk) <= 0:
        return None
    if dtype == torch.float32:
        ok = 0 < D <= _MAX_HEAD_DIM and KV > 0 and H % KV == 0 and H // KV <= _MAX_GROUP
        return "f32" if ok else None
    if dtype != torch.bfloat16:
        return None
    if Tq == Tk and KV == 1 and Tq * H <= _BWD_ROWS and D <= _BWD_ROWS:
        return "short"
    if D in _BWD_HEAD_DIMS and KV > 0 and H % KV == 0 and H // KV <= _MAX_GROUP:
        return "long"
    return None


def backward_route(dtype: torch.dtype, q_shape, k_shape) -> str:
    """How :class:`FlashAttentionFn` computes its backward on the card (or
    over fake tensors) for q of ``q_shape`` ``(B, Tq, H, D)`` and k of
    ``k_shape`` ``(B, Tk, KV, D)``: ``'kernel'`` (through
    :func:`flash_attention_backward_op`) where a kernel route takes the
    shapes: float32 at any head dim up to 128 (``csrc/flash_backward_f32.cu``:
    lm-100m's), bfloat16 on ``csrc/flash_backward.cu``'s long route
    (glm4-9b's, granite's, llama3-405b's, yi-9b's, moonshot's heads) or
    short route (SASRec's sequences of 50 at D = 50); else ``'plain'``
    (:func:`flash_attention_backward_plain`: a bfloat16 head dim neither
    bf16 route takes).  A CPU tensor holding data runs the plain version
    whatever this says."""
    return "kernel" if _backward_kernel(dtype, q_shape, k_shape) else "plain"


def _bwd_dims(D: int) -> int:
    """The long route's kernel configuration that tiles head dim ``D``: 64
    up to 64, else 128 (the short route's head dims, D <= 64, take 64's
    tiles in the mirror)."""
    return 64 if D <= 64 else 128


def _bwd_walks(Tq: int, Tk: int, H: int, KV: int, D: int, causal: bool = True):
    """``(P, n_rt, walks)``: the positions a row tile of the long route
    holds (``floor(64 / G)``), its row tiles a kv head, and the row tiles
    each dK / dV key tile walks (under causal from the tile that holds
    its first key's position)."""
    G = H // KV
    P = max(1, _BWD_ROWS // G)
    n_rt = -(-Tq // P)
    keys = _BWD_SM90_KEYS[_bwd_dims(D)]
    walks = [n_rt - (min(k0 // P, n_rt) if causal else 0) for k0 in range(0, Tk, keys)]
    return P, n_rt, walks


def backward_splits(B: int, Tq: int, Tk: int, H: int, KV: int, n_sm: int = 132,
                    D: int = 128) -> int:
    """Runs of whole row tiles the dK / dV kernel cuts each key tile's walk
    in (each run writes an fp32 partial, added in order by the reduce
    kernel): the longest walk over the card's share of all walks
    (``ceil(longest * n_sm / total)``, so that no block walks longer than
    an SM's share of the work), at most ``_BWD_MAX_SPLITS``, never more
    than the row tiles.  glm4-9b's training attention (B 1, T 4096, 32
    heads over 2, D = 128): 64 key tiles of 128 keys, walks 1,024 .. 32
    row tiles, 4 runs; granite's (24 over 8, D = 64): 512 key tiles of 64
    keys, walks 196 .. 4, 1 run (no partials).  On an H100 these were the
    fastest of 1, 2, 4 and 8 runs at both shapes
    (``scripts/backward_sm90_variants.py --splits``)."""
    _, n_rt, walks = _bwd_walks(Tq, Tk, H, KV, D)
    total = max(1, B * KV * sum(walks))
    need = -(-max(walks, default=1) * n_sm // total)
    return max(1, min(_BWD_MAX_SPLITS, n_rt, need))


def sm90_backward_plan(B: int, Tq: int, Tk: int, H: int, KV: int, D: int,
                       n_sm: int = 132) -> Dict[str, int]:
    """The long route's launches at q ``(B, Tq, H, D)`` over ``KV`` kv heads
    on a card of ``n_sm`` SMs, causal, mirroring the kernels' constants
    (``csrc/flash_backward.cu``): a row tile's positions (``floor(64 /
    G)``) and rows in use (``G`` heads each: 64 at G = 16, 63 at G = 3) of
    its 64 slots, the row tiles a kv head; the dK / dV kernel's keys a
    block (64 a consumer warpgroup), threads (a producer warpgroup and the
    consumers), key tiles, runs (:func:`backward_splits`), blocks (key
    tiles x kv heads x runs x batch rows), stages of its Q / dO ring and
    dynamic shared memory (K and V of the key tile, each stage's Q and dO
    row tiles in 64-column tiles of 128-byte rows and their 512 bytes of
    lse2 / delta, plus 1024 bytes to align them); the dQ kernel's row
    tiles a block (a consumer warpgroup each), keys a K / V tile, threads,
    blocks, stages (as many of the dK / dV ring's as fit) and shared
    memory (the block's Q and dO row tiles, each stage's K and V)."""
    if D not in _BWD_HEAD_DIMS:
        raise ValueError(f"the long backward route takes head dims {_BWD_HEAD_DIMS}, got {D}")
    G = H // KV
    if G > _MAX_GROUP:
        raise ValueError(f"the long backward route takes at most {_MAX_GROUP} query heads per "
                         f"kv head, got H/KV={G}")
    P, n_rt, walks = _bwd_walks(Tq, Tk, H, KV, D)
    keys, stages = _BWD_SM90_KEYS[D], _BWD_SM90_STAGES
    halves = D // 64
    row_tile = halves * _BWD_ROWS * _SM90_ROW_BYTES
    splits = backward_splits(B, Tq, Tk, H, KV, n_sm, D)
    dq_keys = _BWD_SM90_DQ_KEYS
    dq_stage = 2 * halves * dq_keys * _SM90_ROW_BYTES
    dq_fixed = 1024 + 2 * _BWD_SM90_DQ_TILES * row_tile
    dq_stages = min(stages, (_SMEM_OPTIN - 256 - dq_fixed) // dq_stage)
    return {"positions": P, "rows_used": P * G, "row_tiles": n_rt,
            "keys": keys, "threads": 128 * (1 + keys // 64), "key_tiles": len(walks),
            "splits": splits, "blocks": B * KV * len(walks) * splits,
            "longest_walk": max(walks), "stages": stages,
            "smem_bytes": 1024 + 2 * halves * keys * _SM90_ROW_BYTES
            + stages * (2 * row_tile + 2 * _BWD_ROWS * 4),
            "dq_row_tiles": _BWD_SM90_DQ_TILES, "dq_keys": dq_keys,
            "dq_threads": 128 * (1 + _BWD_SM90_DQ_TILES),
            "dq_blocks": B * KV * -(-n_rt // _BWD_SM90_DQ_TILES), "dq_stages": dq_stages,
            "dq_smem_bytes": dq_fixed + dq_stages * dq_stage}


def backward_workspace(B: int, Tq: int, Tk: int, H: int, KV: int, D: int, splits: int,
                       dtype: torch.dtype) -> int:
    """float32 elements of the backward kernels' workspace for inputs of
    ``dtype``.  The float32 kernel and the short route need none.  The
    long route: ``lse2`` and ``delta`` in the kernels' row tiles, 64 slots
    a tile (``B x KV x row_tiles x 64`` each, :func:`sm90_backward_plan`),
    then, where ``splits > 1``, the dK and dV partials (``splits x B x Tk
    x KV x D`` each)."""
    if _backward_kernel(dtype, (B, Tq, H, D), (B, Tk, KV, D)) in ("f32", "short"):
        return 0
    _, n_rt, _ = _bwd_walks(Tq, Tk, H, KV, D)
    n = 2 * B * KV * n_rt * _BWD_ROWS
    if splits > 1:
        n += 2 * splits * B * Tk * KV * D
    return n


def f32_block_rows(B: int, Tq: int, H: int, KV: int, n_sm: int = 132) -> Tuple[int, int]:
    """``(rows, blocks)`` of the float32 kernel: the query rows a block
    takes (64, 32 or 16, never fewer than the group's ``H / KV`` heads)
    and the blocks of its grid, ``ceil(Tq / (rows // G)) * KV * B``.  The
    most rows whose grid still gives two blocks an SM, else the fewest:
    fewer rows a block read each K/V tile more often but fill the card
    where the grid is short (lm-100m's q ``(4, 128, 8, 64)`` over 4 kv
    heads: 16 rows, 256 blocks, where 64 rows gave 64)."""
    G = H // KV
    options = [r for r in _F32_ROWS if r >= G]
    for rows in options:
        blocks = -(-Tq // (rows // G)) * KV * B
        if blocks >= 2 * n_sm or rows == options[-1]:
            return rows, blocks
    raise ValueError(f"the float32 kernel takes at most {_F32_ROWS[0]} query heads per kv head, "
                     f"got H/KV={G}")


def prefill_pack(Tq: int, Tk: int, G: int, q_offset: int) -> int:
    """Whole sequences a block of the bf16 prefill kernel takes: ``128 //
    (Tq * G)`` where the queries are the keys (``Tq == Tk``, ``q_offset ==
    0``: training, or a prefill into an empty cache of its own length) and
    one sequence fills at most half of the block's 128 rows; else 1, a
    block being a query tile of one sequence.  SASRec's 50 positions at one
    head give 2: 100 of 128 rows at work, where one sequence gave 50."""
    if Tq != Tk or q_offset != 0 or 2 * Tq * G > _PREFILL_ROWS:
        return 1
    return _PREFILL_ROWS // (Tq * G)


def prefill_route(dtype: torch.dtype, q_shape, k_shape, pack: int, aligned: bool) -> str:
    """The kernel ``flash_prefill_launch`` runs a bfloat16 prefill of q
    ``(B, Tq, H, D)`` over k ``(B, Tk, KV, D)`` on: ``'relay'`` (the
    mma.sync kernel with re-laid staging) where ``D`` is not a multiple of 8, q, k
    and v are not all 16-byte aligned (``aligned``) or ``pack`` (from
    :func:`prefill_pack`) puts more than one sequence in a block (SASRec's
    prefills); else ``'sm90'`` (the TMA-fed, warp-specialised wgmma kernel)
    at head dim 64 or 128 (glm4-9b's, granite's, moonshot's, llama3-405b's
    prefills and training forwards); else ``'mma'`` (the mma.sync
    kernel, straight staging: head dims 8 .. 120 other than 64).  A plain
    mirror of the launcher's choice: the wrapper counts each launch under
    it in ``PREFILL_ROUTES``."""
    if dtype != torch.bfloat16:
        raise ValueError(f"the prefill kernels take bfloat16, got {dtype}")
    D = q_shape[3]
    if D % 8 or not aligned or pack > 1:
        return "relay"
    return "sm90" if D in _SM90_HEAD_DIMS else "mma"


def sm90_prefill_plan(B: int, Tq: int, H: int, KV: int, D: int,
                      n_sm: int = 132) -> Dict[str, int]:
    """The sm90 prefill kernel's launch at q ``(B, Tq, H, D)`` over ``KV``
    kv heads on a card of ``n_sm`` SMs, mirroring its constants: a block's
    threads (a producer warpgroup and the consumer warpgroups) and query
    rows (64 a consumer warpgroup: 128 at head dim 128, 192 at 64), an
    item's positions (``rows // G``) and rows in use (the G heads of each:
    126 of 128 or 192 of 192 at G = 3), the query tiles a kv head and batch
    row, the items (query tiles x batch rows x kv heads), the blocks of the
    grid (one an SM walking the items where ``persistent``, else one an
    item), whether the consumer warpgroups take turns (``pingpong``), the
    keys a K / V tile, the stages of the ring and the dynamic shared memory
    a block asks for (Q's rows and each stage's K and V tiles, in 64-column
    tiles of 128-byte rows, plus 1024 bytes to align them)."""
    if D not in _SM90_HEAD_DIMS:
        raise ValueError(f"the sm90 prefill takes head dims {_SM90_HEAD_DIMS}, got {D}")
    G = H // KV
    consumers = _SM90_CONSUMERS[D]
    rows = 64 * consumers
    positions = rows // G
    qtiles = -(-Tq // positions)
    items = qtiles * KV * B
    bkv, stages = _SM90_BKV[D], _SM90_STAGES[D]
    smem = 1024 + (D // 64) * _SM90_ROW_BYTES * (rows + stages * 2 * bkv)
    return {"threads": 128 * (1 + consumers), "rows": rows, "positions": positions,
            "rows_used": positions * G, "qtiles": qtiles, "items": items,
            "blocks": min(items, n_sm) if _SM90_PERSISTENT[D] else items,
            "persistent": _SM90_PERSISTENT[D], "pingpong": _SM90_PINGPONG[D],
            "block_kv": bkv, "stages": stages, "smem_bytes": smem}


def sm90_block_kv(D: int) -> int:
    """The keys a K / V tile of the sm90 prefill kernel at head dim ``D``:
    where ``p`` is rounded (against its row's running max after each
    tile), so ``flash_attention_plain(block_kv=sm90_block_kv(D))`` has the
    kernel's rounding points."""
    return _SM90_BKV[D]


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           kv_length: Optional[torch.Tensor]) -> None:
    if q.ndim != 4 or k.ndim != 4 or v.shape != k.shape:
        raise ValueError(
            f"q must be (B, Tq, H, D) and k, v (B, Tk, KV, D); got "
            f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}"
        )
    B, _, H, D = q.shape
    if k.shape[0] != B or k.shape[3] != D:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} disagree on B or D")
    KV = k.shape[2]
    if KV == 0 or H % KV:
        raise ValueError(f"H={H} not a multiple of KV={KV}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"q, k, v must share one dtype: {q.dtype}, {k.dtype}, {v.dtype}")
    if k.device != q.device or v.device != q.device:
        raise ValueError(f"q, k, v must lie on one device: {q.device}, {k.device}, {v.device}")
    if kv_length is not None:
        if kv_length.shape != (B,) or kv_length.dtype not in (torch.int32, torch.int64):
            raise ValueError(
                f"kv_length must be an int (B,) tensor, got {kv_length.dtype} "
                f"{tuple(kv_length.shape)}"
            )
        if kv_length.device != q.device:
            raise ValueError(f"kv_length is on {kv_length.device}, q on {q.device}")


def _partials(qb, q_pos, k, v, kv_valid, causal, scale, start, stop, block):
    """Online-softmax state ``(acc, m, l)`` of the query block ``qb``
    (float, ``(B, bq, KV, G, D)``) at positions ``q_pos`` over keys
    ``[start, stop)`` of ``k``, ``v`` in blocks of ``block``, in order, as
    the reference's ``_flash_impl`` walks its key blocks."""
    B, bq, KV, G, D = qb.shape
    dev = qb.device
    neg_inf = torch.tensor(float("-inf"), device=dev)
    acc = torch.zeros((B, bq, KV, G, D), dtype=torch.float32, device=dev)
    m = torch.full((B, bq, KV, G), float("-inf"), dtype=torch.float32, device=dev)
    l = torch.zeros((B, bq, KV, G), dtype=torch.float32, device=dev)
    for k0 in range(start, stop, block):
        kb = k[:, k0:k0 + block].float()
        vb = v[:, k0:k0 + block]
        s = torch.einsum("bqkgd,bskd->bqkgs", qb, kb) * scale
        kv_pos = k0 + torch.arange(block, device=dev)
        mask = kv_pos[None, :] < kv_valid[:, None]                # (B, block)
        if causal:
            mask = mask[:, None, :] & (kv_pos[None, None, :] <= q_pos[None, :, None])
            s = torch.where(mask[:, :, None, None, :], s, neg_inf)
        else:
            s = torch.where(mask[:, None, None, None, :], s, neg_inf)
        m_new = torch.maximum(m, s.amax(dim=-1))
        m_safe = torch.where(torch.isneginf(m_new), 0.0, m_new)
        p = torch.exp(s - m_safe[..., None])
        p = torch.where(torch.isneginf(s), 0.0, p)
        alpha = torch.where(torch.isneginf(m), 0.0, torch.exp(m - m_safe))
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum(
            "bqkgs,bskd->bqkgd", p.to(vb.dtype).float(), vb.float()
        )
        m = m_new
    return acc, m, l


def _pad_keys(k: torch.Tensor, v: torch.Tensor, multiple: int):
    pad = (-k.shape[1]) % multiple
    if pad:
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
    return k, v


def _kv_valid(kv_length: Optional[torch.Tensor], B: int, Tk: int, dev) -> torch.Tensor:
    if kv_length is None:
        return torch.full((B,), Tk, dtype=torch.int64, device=dev)
    return kv_length.to(torch.int64)


def flash_attention_plain(
    q: torch.Tensor,             # (B, Tq, H, D)
    k: torch.Tensor,             # (B, Tk, KV, D)
    v: torch.Tensor,
    *,
    causal: bool = True,
    q_offset: int = 0,
    kv_length: Optional[torch.Tensor] = None,
    block_q: int = 512,
    block_kv: int = 1024,
    return_lse: bool = False,
):
    """Plain PyTorch K4: a port of the reference's ``_flash_impl`` (padded
    blocks, online softmax ``(acc, m, l)`` over key blocks in order).
    With ``return_lse``, also each row's log-sum-exp ``m + log(l)``,
    float32 ``(B, Tq, H)``, ``+inf`` where every key is masked."""
    _check(q, k, v, kv_length)
    if q.is_cuda:
        PLAIN_CUDA_CALLS["flash_attention"] += 1
    B, Tq, H, D = q.shape
    _, Tk, KV, _ = k.shape
    G = H // KV
    bq = min(block_q, Tq)
    bkv = min(block_kv, Tk)
    pad_q = (-Tq) % bq
    if pad_q:
        q = F.pad(q, (0, 0, 0, 0, 0, pad_q))
    k, v = _pad_keys(k, v, bkv)
    nq = (Tq + pad_q) // bq
    qg = q.reshape(B, nq, bq, KV, G, D)
    scale = 1.0 / math.sqrt(D)
    dev = q.device
    kv_valid = _kv_valid(kv_length, B, Tk, dev)
    blocks, lses = [], []
    for qi in range(nq):
        q_pos = q_offset + qi * bq + torch.arange(bq, device=dev)
        acc, m, l = _partials(qg[:, qi].float(), q_pos, k, v, kv_valid, causal, scale,
                              0, k.shape[1], bkv)
        out = acc / torch.clamp(l[..., None], min=1e-20)
        blocks.append(out.to(q.dtype))
        if return_lse:
            lses.append(torch.where(l > 0, m + torch.log(torch.clamp(l, min=1e-30)),
                                    float("inf")))
    out = torch.stack(blocks, dim=1).reshape(B, nq * bq, H, D)[:, :Tq]
    if not return_lse:
        return out
    return out, torch.stack(lses, dim=1).reshape(B, nq * bq, H)[:, :Tq]


def flash_attention_backward_plain(
    q: torch.Tensor,             # (B, Tq, H, D)
    k: torch.Tensor,             # (B, Tk, KV, D)
    v: torch.Tensor,
    out: torch.Tensor,           # (B, Tq, H, D), the forward's output
    lse: torch.Tensor,           # (B, Tq, H) float32, the forward's log-sum-exp
    do: torch.Tensor,            # (B, Tq, H, D), the output's gradient
    *,
    causal: bool = True,
    block_q: int = 512,
    block_kv: int = 1024,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(dq, dk, dv)`` of attention without a cache: a port of the
    reference's ``_flash_train_bwd``.  ``p`` is recomputed per
    ``(block_q, block_kv)`` block from ``lse`` (nothing quadratic is
    saved), ``delta = rowsum(do * out)``, everything in float32 over the
    reference's padding, and the gradients cast to the inputs' dtypes.
    Under ``causal``, a key block that starts past the query block's last
    position is skipped: the reference adds exact zeros there."""
    if q.is_cuda:
        PLAIN_CUDA_CALLS["flash_attention_backward"] += 1
    B, Tq, H, D = q.shape
    _, Tk, KV, _ = k.shape
    G = H // KV
    bq = min(block_q, Tq)
    bkv = min(block_kv, Tk)
    pad_q = (-Tq) % bq
    dev = q.device

    def pad_rows(t, value=0.0):
        return F.pad(t, (0, 0, 0, 0, 0, pad_q), value=value) if pad_q else t

    nq = (Tq + pad_q) // bq
    qg = pad_rows(q).reshape(B, nq, bq, KV, G, D)
    dog = pad_rows(do).reshape(B, nq, bq, KV, G, D)
    outg = pad_rows(out).reshape(B, nq, bq, KV, G, D)
    lseg = pad_rows(lse.reshape(B, Tq, KV, G), float("inf")).reshape(B, nq, bq, KV, G)
    kp, vp = _pad_keys(k, v, bkv)
    Tk_p = kp.shape[1]
    scale = 1.0 / math.sqrt(D)
    dq = torch.empty((B, nq, bq, KV, G, D), dtype=torch.float32, device=dev)
    dk = torch.zeros((B, Tk_p, KV, D), dtype=torch.float32, device=dev)
    dv = torch.zeros((B, Tk_p, KV, D), dtype=torch.float32, device=dev)
    for qi in range(nq):
        qb = qg[:, qi].float()
        dob = dog[:, qi].float()
        lseb = lseg[:, qi]
        deltab = (dob * outg[:, qi].float()).sum(dim=-1)
        q_pos = qi * bq + torch.arange(bq, device=dev)
        dqb = torch.zeros((B, bq, KV, G, D), dtype=torch.float32, device=dev)
        for k0 in range(0, Tk_p, bkv):
            if causal and k0 > qi * bq + bq - 1:
                break
            kb = kp[:, k0:k0 + bkv].float()
            vb = vp[:, k0:k0 + bkv].float()
            s = torch.einsum("bqkgd,bskd->bqkgs", qb, kb) * scale
            kv_pos = k0 + torch.arange(bkv, device=dev)
            mask = (kv_pos < Tk)[None, :]                         # padding keys
            if causal:
                mask = mask & (kv_pos[None, :] <= q_pos[:, None])  # (bq, bkv)
            s = torch.where(mask[None, :, None, None, :], s, float("-inf"))
            p = torch.exp(s - lseb[..., None])        # rows with lse = inf give 0
            p = torch.where(torch.isneginf(s), 0.0, p)
            dp = torch.einsum("bqkgd,bskd->bqkgs", dob, vb)
            ds = p * (dp - deltab[..., None])
            dqb = dqb + scale * torch.einsum("bqkgs,bskd->bqkgd", ds, kb)
            dk[:, k0:k0 + bkv] += scale * torch.einsum("bqkgs,bqkgd->bskd", ds, qb)
            dv[:, k0:k0 + bkv] += torch.einsum("bqkgs,bqkgd->bskd", p, dob)
        dq[:, qi] = dqb
    dq = dq.reshape(B, nq * bq, H, D)[:, :Tq].to(q.dtype)
    return dq, dk[:, :Tk].to(k.dtype), dv[:, :Tk].to(v.dtype)


def _kernel_rows(t: torch.Tensor, KV: int, r_pad: int, value: float = 0.0) -> torch.Tensor:
    """``(B, T, H, ...)`` as the backward kernels walk it: ``(B, KV, R_pad,
    ...)`` float32, row ``r`` of kv head ``kv`` being position ``r // G``
    of head ``kv G + r % G``, rows past ``T G`` filled with ``value``."""
    B, T, H = t.shape[:3]
    G = H // KV
    rest = tuple(t.shape[3:])
    x = t.reshape(B, T, KV, G, *rest).transpose(1, 2).reshape(B, KV, T * G, *rest).float()
    pad = r_pad - T * G
    if pad:
        x = torch.cat([x, x.new_full((B, KV, pad, *rest), value)], dim=2)
    return x


def flash_attention_backward_tiled_plain(
    q: torch.Tensor,             # (B, Tq, H, D)
    k: torch.Tensor,             # (B, Tk, KV, D)
    v: torch.Tensor,
    out: torch.Tensor,           # (B, Tq, H, D)
    lse: torch.Tensor,           # (B, Tq, H) float32
    do: torch.Tensor,            # (B, Tq, H, D)
    *,
    causal: bool = True,
    splits: Optional[int] = None,
    rounding: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The backward kernels' arithmetic (``csrc/flash_backward.cu``) in
    plain PyTorch: ``(dq, dk, dv)`` in the inputs' dtypes.

    Query rows in the kernels' order (the G heads of each position in
    turn) in row tiles of ``floor(64 / G)`` positions (``G floor(64 / G)``
    rows), keys in the long route's tiles (:func:`sm90_backward_plan`:
    dK / dV blocks of 64 keys at head dim 64 and 128 at 128, dQ's K / V
    tiles of 128 keys at both); ``p = 2^(s * scale * log2 e - lse * log2 e)``, 0 where
    masked; ``ds = p (dp - delta)``; with ``rounding``, ``p`` and ``ds``
    rounded to bf16 before their products, as the kernels round them (off:
    every product in float32, which is
    :func:`flash_attention_backward_plain`'s arithmetic up to the order of
    sums).  dQ sums over its key tiles in order; dK and dV over the row
    tiles of each of ``splits`` runs (default :func:`backward_splits` on an
    H100) in order, the runs' sums then added in order; ``scale``
    multiplies dQ and dK after their sums.  The short route's order (a
    sequence is one tile: ``Tq == Tk <= 64``, ``Tq G <= 64``) is the same
    with one key tile, one row tile and one run: each gradient is one
    product.  For the tests and the smoke run; the main path never calls
    it."""
    B, Tq, H, D = q.shape
    _, Tk, KV, _ = k.shape
    G = H // KV
    if splits is None:
        splits = backward_splits(B, Tq, Tk, H, KV, D=D)
    dims = _bwd_dims(D)
    kv_keys, dq_keys = _BWD_SM90_KEYS[dims], _BWD_SM90_DQ_KEYS
    dev = q.device
    R = Tq * G
    P, n_rt, _ = _bwd_walks(Tq, Tk, H, KV, D, causal)
    rows = P * G                                              # rows of a row tile
    r_pad = n_rt * rows
    width = max(kv_keys, dq_keys)
    n_k = -(-Tk // width) * width
    kp, vp = _pad_keys(k, v, width)
    kr = kp.transpose(1, 2).float()                           # (B, KV, n_k, D)
    vr = vp.transpose(1, 2).float()
    qr = _kernel_rows(q, KV, r_pad)                           # (B, KV, r_pad, D)
    dor = _kernel_rows(do, KV, r_pad)
    lse2 = _kernel_rows(lse, KV, r_pad, float("inf")) * _LOG2E
    delta = _kernel_rows((do.float() * out.float()).sum(dim=-1), KV, r_pad)
    scale = 1.0 / math.sqrt(D)
    scale_log2 = float(torch.tensor(scale, dtype=torch.float32) * _LOG2E)
    pos = torch.arange(r_pad, device=dev) // G                # each row's position
    key = torch.arange(n_k, device=dev)

    def bf16(x):
        return x.to(torch.bfloat16).float() if rounding else x

    def probs(s, l2, visible):
        p = torch.exp2(s * scale_log2 - l2)
        return torch.where(visible, p, 0.0)

    # dQ: each row over the dQ kernel's key tiles in order
    dq = torch.zeros((B, KV, r_pad, D), dtype=torch.float32, device=dev)
    for j0 in range(0, n_k, dq_keys):
        kj, vj = kr[:, :, j0:j0 + dq_keys], vr[:, :, j0:j0 + dq_keys]
        kj_pos = key[j0:j0 + dq_keys]
        visible = (kj_pos < Tk)[None, :]
        if causal:
            visible = visible & (kj_pos[None, :] <= pos[:, None])
        p = probs(qr @ kj.transpose(-1, -2), lse2[..., None], visible)
        ds = p * (dor @ vj.transpose(-1, -2) - delta[..., None])
        dq = dq + bf16(ds) @ kj

    # dK, dV: each key tile over its runs of row tiles, each run in order
    n_kt = n_k // kv_keys
    first = [min(j * kv_keys // P, n_rt) if causal else 0 for j in range(n_kt)]
    starts = torch.zeros((n_rt, n_k), dtype=torch.bool, device=dev)
    for j, f in enumerate(first):
        for sp in range(1, splits):
            at = f + (sp * (n_rt - f)) // splits
            if at < n_rt:
                starts[at, j * kv_keys:(j + 1) * kv_keys] = True
    total_k = torch.zeros((B, KV, n_k, D), dtype=torch.float32, device=dev)
    total_v = torch.zeros_like(total_k)
    acc_k, acc_v = torch.zeros_like(total_k), torch.zeros_like(total_k)
    for i in range(n_rt):
        tile = slice(i * rows, (i + 1) * rows)
        qi, doi = qr[:, :, tile], dor[:, :, tile]
        visible = (key[:, None] <= pos[None, tile]) if causal else torch.ones(
            (1, 1), dtype=torch.bool, device=dev)
        pt = probs(kr @ qi.transpose(-1, -2), lse2[:, :, None, tile], visible)
        dst = pt * (vr @ doi.transpose(-1, -2) - delta[:, :, None, tile])
        new_run = starts[i][:, None]
        total_k = torch.where(new_run, total_k + acc_k, total_k)
        total_v = torch.where(new_run, total_v + acc_v, total_v)
        acc_k = torch.where(new_run, 0.0, acc_k)
        acc_v = torch.where(new_run, 0.0, acc_v)
        acc_v = acc_v + bf16(pt) @ doi
        acc_k = acc_k + bf16(dst) @ qi
    dk = scale * (total_k + acc_k)
    dv = total_v + acc_v

    dq = (scale * dq[:, :, :R]).reshape(B, KV, Tq, G, D).transpose(1, 2).reshape(B, Tq, H, D)
    dk = dk[:, :, :Tk].transpose(1, 2)
    dv = dv[:, :, :Tk].transpose(1, 2)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def f32_backward_walks(Tq: int, Tk: int, H: int, KV: int, causal: bool):
    """The steps each tile of the float32 backward kernel walks: ``(dK /
    dV tiles' chunks, key tile by key tile; dQ tiles' key tiles, row tile
    by row tile)``."""
    G = H // KV
    R = Tq * G
    kv = [-(-(R - (min(j0 * G, R) if causal else 0)) // _F32_BWD_CHUNK)
          for j0 in range(0, Tk, _F32_BWD_KEYS)]
    q = [-(-(min(Tk, (min(r0 + _F32_BWD_ROWS, R) - 1) // G + 1) if causal else Tk)
           // _F32_BWD_TILE) for r0 in range(0, R, _F32_BWD_ROWS)]
    return kv, q


def f32_backward_target(B: int, KV: int, kv_walks, q_walks, n_sm: int = 132) -> int:
    """The most steps of a tile's walk a rank of the float32 backward
    kernel takes: the fewest, from the longest walk over 4 (rounded up),
    whose grid of ``B KV`` heads holds at most a quarter more blocks than
    ``n_sm`` SMs keep at two an SM (else the longest walk)."""
    heads, ranks = B * KV, _F32_BWD_CLUSTER
    longest = max(kv_walks[0], q_walks[-1])

    def blocks(target):
        return sum(-(-heads * f32_backward_split(n, target) // ranks) * ranks
                   for n in kv_walks + q_walks)

    lo, hi = max(1, -(-longest // ranks)), max(1, longest)
    while lo < hi:  # the grid shrinks as the shares grow
        mid = (lo + hi) // 2
        if blocks(mid) > 2 * n_sm + (2 * n_sm) // 4:
            lo = mid + 1
        else:
            hi = mid
    return lo


def f32_backward_split(n: int, target: int) -> int:
    """The ranks of a cluster a tile's walk of ``n`` steps is split over:
    the fewest of 4, 2, 1 that keep a rank's share within ``target``
    steps (else 4)."""
    split = _F32_BWD_CLUSTER
    while split > 1 and n <= target * (split // 2):
        split //= 2
    return split


def flash_attention_backward_f32_tiled_plain(
    q: torch.Tensor,             # (B, Tq, H, D) float32
    k: torch.Tensor,             # (B, Tk, KV, D)
    v: torch.Tensor,
    out: torch.Tensor,           # (B, Tq, H, D)
    lse: torch.Tensor,           # (B, Tq, H)
    do: torch.Tensor,            # (B, Tq, H, D)
    *,
    causal: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The float32 backward kernel's arithmetic
    (``csrc/flash_backward_f32.cu``) in plain PyTorch: ``(dq, dk, dv)``,
    float32 throughout.

    Query rows in the kernel's order (the G heads of each position in
    turn); ``p = exp(s * scale - lse)``, 0 where masked; ``ds = p (dp -
    delta)``.  dK and dV: each 32-key tile walks the rows that see it
    (from its first position under causal) in chunks of 32; dQ: each
    32-row tile walks its 32-key tiles (up to its last position under
    causal).  A tile's ``n`` steps are split over ``s`` ranks of a
    cluster (:func:`f32_backward_split` at :func:`f32_backward_target`'s
    share, for an H100's 132 SMs; rank ``r`` takes steps ``[r n // s, (r
    + 1) n // s)``, in order), each step's rows (dK, dV) or keys
    (dQ) dealt to ``512 / DP`` interleaved splits (DP the head dim padded
    to 64 or 128); the shares of every rank (zeros where its steps are
    none), each rank's splits in turn, are then added one after another.  ``scale`` multiplies dQ
    and dK after their sums.  For the tests and the smoke run; the main
    path never calls it."""
    B, Tq, H, D = q.shape
    _, Tk, KV, _ = k.shape
    G = H // KV
    R = Tq * G
    keys, chunk, rows_q, tile = _F32_BWD_KEYS, _F32_BWD_CHUNK, _F32_BWD_ROWS, _F32_BWD_TILE
    ncg = (64 if D <= 64 else 128) // 4
    row_splits = 256 // (keys // 4 * ncg)     # threads / (key groups x column groups)
    key_splits = 256 // (rows_q // 4 * ncg)   # threads / (row groups x column groups)
    r_pad = R + max(chunk, rows_q)            # a chunk or tile may run past R
    dev = q.device
    kr = k.transpose(1, 2).float()            # (B, KV, Tk, D)
    vr = v.transpose(1, 2).float()
    qr = _kernel_rows(q, KV, r_pad)           # (B, KV, r_pad, D)
    dor = _kernel_rows(do, KV, r_pad)
    lser = _kernel_rows(lse, KV, r_pad)
    delta = _kernel_rows((do.float() * out.float()).sum(dim=-1), KV, r_pad)
    scale = 1.0 / math.sqrt(D)
    rows = torch.arange(r_pad, device=dev)
    pos = rows // G

    def probs(s, row_ids, key_ids):
        seen = (row_ids < R)[:, None] & (key_ids < Tk)[None, :]
        if causal:
            seen = seen & (key_ids[None, :] <= pos[row_ids][:, None])
        return torch.where(seen, torch.exp(s * scale - lser[:, :, row_ids, None]), 0.0)

    kv_walks, q_walks = f32_backward_walks(Tq, Tk, H, KV, causal)
    target = f32_backward_target(B, KV, kv_walks, q_walks)

    def shares(n):
        """Each rank's steps, in rank order (some may be none)."""
        split = f32_backward_split(n, target)
        cuts = [r * n // split for r in range(split + 1)]
        return [range(lo, hi) for lo, hi in zip(cuts, cuts[1:])]

    def in_order(parts):
        total = parts[0]
        for part in parts[1:]:
            total = total + part
        return total

    def scores(r0, j0, n_rows, n_keys):
        row_ids = rows[r0:r0 + n_rows]
        key_ids = torch.arange(j0, min(j0 + n_keys, Tk), device=dev)
        qc, doc = qr[:, :, r0:r0 + n_rows], dor[:, :, r0:r0 + n_rows]
        kj, vj = kr[:, :, key_ids], vr[:, :, key_ids]
        p = probs(qc @ kj.transpose(-1, -2), row_ids, key_ids)
        ds = p * (doc @ vj.transpose(-1, -2) - delta[:, :, r0:r0 + n_rows, None])
        return qc, doc, kj, p, ds

    # dQ: each 32-row tile over its 32-key tiles, split over the ranks
    dq = torch.zeros((B, KV, R, D), dtype=torch.float32, device=dev)
    for r0 in range(0, R, rows_q):
        last = min(r0 + rows_q, R) - 1
        n_tiles = -(-(min(Tk, last // G + 1) if causal else Tk) // tile)
        parts = []
        for steps in shares(n_tiles):
            split = [0.0] * key_splits
            for t in steps:
                _, _, kj, _, ds = scores(r0, t * tile, rows_q, tile)
                for h in range(key_splits):
                    split[h] = split[h] + ds[..., h::key_splits] @ kj[:, :, h::key_splits]
            parts += split
        dq[:, :, r0:r0 + rows_q] = in_order(parts)[:, :, :min(rows_q, R - r0)]

    # dK, dV: each 32-key tile over its chunks of 32 rows, split over the
    # ranks, each chunk's rows split
    dk = torch.zeros((B, KV, Tk, D), dtype=torch.float32, device=dev)
    dv = torch.zeros_like(dk)
    for j0 in range(0, Tk, keys):
        first = min(j0 * G, R) if causal else 0
        parts_k, parts_v = [], []
        for steps in shares(-(-(R - first) // chunk)):
            split_k, split_v = [0.0] * row_splits, [0.0] * row_splits
            for c in steps:
                qc, doc, _, p, ds = scores(first + c * chunk, j0, chunk, keys)
                for h in range(row_splits):
                    split_v[h] = split_v[h] + p[:, :, h::row_splits].transpose(-1, -2) @ \
                        doc[:, :, h::row_splits]
                    split_k[h] = split_k[h] + ds[:, :, h::row_splits].transpose(-1, -2) @ \
                        qc[:, :, h::row_splits]
            parts_k += split_k
            parts_v += split_v
        dk[:, :, j0:j0 + keys] = scale * in_order(parts_k)
        dv[:, :, j0:j0 + keys] = in_order(parts_v)

    dq = (scale * dq).reshape(B, KV, Tq, G, D).transpose(1, 2).reshape(B, Tq, H, D)
    return dq, dk.transpose(1, 2), dv.transpose(1, 2)


def flash_attention_split_plain(
    q: torch.Tensor,             # (B, Tq, H, D)
    k: torch.Tensor,             # (B, Tk, KV, D)
    v: torch.Tensor,
    *,
    causal: bool = False,
    q_offset: int = 0,
    kv_length: Optional[torch.Tensor] = None,
    split_keys: Optional[int] = None,
) -> torch.Tensor:
    """The split-KV decode kernel's arithmetic in plain PyTorch: the
    partial ``(acc_s, m_s, l_s)`` of each key range ``[s * split_keys,
    (s + 1) * split_keys)`` in 64-key tiles, then the combine
    ``sum_s e^(m_s - M) acc_s / max(sum_s e^(m_s - M) l_s, 1e-20)`` with
    ``M = max_s m_s``, cast once.  ``split_keys`` (a multiple of 64)
    defaults to :func:`decode_split`'s on an H100.  For tests and the
    smoke run; the main path never calls it."""
    _check(q, k, v, kv_length)
    if q.is_cuda:
        PLAIN_CUDA_CALLS["flash_attention"] += 1
    B, Tq, H, D = q.shape
    _, Tk, KV, _ = k.shape
    G = H // KV
    if split_keys is None:
        _, split_keys = decode_split(Tk, B * KV * -(-G // _DECODE_ROWS))
    if split_keys <= 0 or split_keys % _TILE:
        raise ValueError(f"split_keys must be a positive multiple of {_TILE}, got {split_keys}")
    k, v = _pad_keys(k, v, split_keys)
    qb = q.reshape(B, Tq, KV, G, D).float()
    q_pos = q_offset + torch.arange(Tq, device=q.device)
    kv_valid = _kv_valid(kv_length, B, Tk, q.device)
    scale = 1.0 / math.sqrt(D)
    parts = [_partials(qb, q_pos, k, v, kv_valid, causal, scale, s0, s0 + split_keys, _TILE)
             for s0 in range(0, k.shape[1], split_keys)]
    acc, m, l = (torch.stack(t) for t in zip(*parts))
    top = m.amax(dim=0)
    top = torch.where(torch.isneginf(top), 0.0, top)
    w = torch.where(torch.isneginf(m), 0.0, torch.exp(m - top))
    num = (w[..., None] * acc).sum(dim=0)
    den = (w * l).sum(dim=0)
    out = num / torch.clamp(den[..., None], min=1e-20)
    return out.to(q.dtype).reshape(B, Tq, H, D)


def _launched(rc: int, kernel: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{kernel} launch failed: CUDA error {rc}")
    LAUNCHES[kernel] += 1


def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool, q_offset: int,
            kv_length: Optional[torch.Tensor], with_lse: bool):
    """Launch the K4 kernel that ``q``'s dtype and shape select, on the
    current stream; returns ``(out, lse or None)``.  ``with_lse`` (the
    training forward) also writes the float32 ``(B, Tq, H)`` log-sum-exp,
    through the prefill kernel in bf16 whatever ``Tq``."""
    if q.device.type != "cuda":
        raise ValueError(f"q lies on {q.device}: only cpu and cuda are served")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"K4 takes float32 or bfloat16, got {q.dtype}")
    B, Tq, H, D = q.shape
    _, Tk, KV, _ = k.shape
    G = H // KV
    if D > _MAX_HEAD_DIM or G > _MAX_GROUP:
        raise ValueError(
            f"K4 takes head_dim <= {_MAX_HEAD_DIM} and at most {_MAX_GROUP} query "
            f"heads per kv head, got D={D}, H/KV={G}"
        )
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    lengths = None
    if kv_length is not None:
        lengths = kv_length.to(torch.int32).contiguous()
    from .build import load

    def ptr(t: Optional[torch.Tensor]) -> ctypes.c_void_p:
        return ctypes.c_void_p(t.data_ptr() if t is not None else 0)

    o = torch.empty_like(q)
    lse = (torch.empty((B, Tq, H), dtype=torch.float32, device=q.device)
           if with_lse else None)
    suffix = "_lse" if with_lse else ""
    dev = q.device.index if q.device.index is not None else torch.cuda.current_device()
    stream = ctypes.c_void_p(torch.cuda.current_stream(q.device).cuda_stream)
    scale = 1.0 / math.sqrt(D)
    common = (B, Tq, Tk, H, KV, D, int(q_offset), int(bool(causal)))
    if q.dtype == torch.float32:
        rows, _ = f32_block_rows(B, Tq, H, KV, _sm_count(dev))
        _launched(load("flash_attention").flash_attention_launch(
            ptr(q), ptr(k), ptr(v), ptr(o), ptr(lse), ptr(lengths), *common, rows, scale, dev,
            stream,
        ), "flash_attention_f32" + suffix)
    elif Tq > 1 or with_lse:  # the decode kernel writes no lse
        pack = prefill_pack(Tq, Tk, G, int(q_offset))
        aligned = all(t.data_ptr() % 16 == 0 for t in (q, k, v))
        _launched(load("flash_prefill").flash_prefill_launch(
            ptr(q), ptr(k), ptr(v), ptr(o), ptr(lse), ptr(lengths), *common,
            pack, scale * _LOG2E, dev, stream,
        ), "flash_attention_prefill" + suffix)
        PREFILL_ROUTES[prefill_route(q.dtype, q.shape, k.shape, pack, aligned)] += 1
    else:
        lib = load("flash_decode")
        pairs = B * KV * -(-G // _DECODE_ROWS)
        n_split, split_keys = decode_split(Tk, pairs, _sm_count(dev))
        # one scratch buffer: acc (B, H, n_split, D), then m and l (B, H, n_split)
        n_part = B * H * n_split
        scratch = torch.empty(n_part * (D + 2), dtype=torch.float32, device=q.device)
        part_o = scratch.data_ptr()
        part_m = part_o + 4 * n_part * D
        part_l = part_m + 4 * n_part
        _launched(lib.flash_decode_launch(
            ptr(q), ptr(k), ptr(v), ptr(lengths), part_o, part_m, part_l, B, Tk, H, KV, D,
            split_keys, n_split, int(q_offset), int(bool(causal)), scale * _LOG2E, dev, stream,
        ), "flash_attention_decode")
        _launched(lib.flash_combine_launch(
            part_o, part_m, part_l, ptr(o), B * H, D, n_split, dev, stream,
        ), "flash_attention_combine")
    LAUNCHES["flash_attention"] += 1
    return o, lse


@torch.library.custom_op("repro_torch::flash_attention", mutates_args=())
def flash_attention_op(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, kv_length: Optional[torch.Tensor],
    causal: bool, q_offset: int, with_lse: bool, block_q: int, block_kv: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """K4 as a registered op, ``repro_torch::flash_attention``: ``(out,
    lse)``.  On a CUDA tensor it launches the kernel that ``q``'s dtype and
    shape select (:func:`_launch`); on a CPU tensor it is
    :func:`flash_attention_plain` with ``block_q`` / ``block_kv``.  ``lse``
    is float32 ``(B, Tq, H)`` under ``with_lse`` and empty ``(0,)``
    otherwise.  Its fake implementation gives these shapes and dtypes
    without touching memory, so a step traced over fake tensors meets no
    ``ctypes`` launch (a fake tensor's ``data_ptr()`` is 0), and its FLOP
    formula (:func:`_flash_flops`) lets a FLOP count see the kernel."""
    if q.device.type == "cpu":
        if with_lse:
            return flash_attention_plain(q, k, v, causal=causal, q_offset=q_offset,
                                         kv_length=kv_length, block_q=block_q,
                                         block_kv=block_kv, return_lse=True)
        out = flash_attention_plain(q, k, v, causal=causal, q_offset=q_offset,
                                    kv_length=kv_length, block_q=block_q, block_kv=block_kv)
        return out, q.new_empty((0,), dtype=torch.float32)
    out, lse = _launch(q, k, v, causal, q_offset, kv_length, with_lse)
    return out, (lse if lse is not None else q.new_empty((0,), dtype=torch.float32))


@flash_attention_op.register_fake
def _(q, k, v, kv_length, causal, q_offset, with_lse, block_q, block_kv):
    B, Tq, H, _ = q.shape
    lse_shape = (B, Tq, H) if with_lse else (0,)
    return torch.empty_like(q), q.new_empty(lse_shape, dtype=torch.float32)


def _backward_rowstats(lib, out, do, lse, work, KV: int, dev: int, stream):
    """Launch the row-statistics kernel into the head of ``work``; returns
    the views ``(lse2, delta)``, each ``B x KV x row_tiles x 64`` float32
    (:func:`sm90_backward_plan`'s row tiles)."""
    B, Tq, H, D = out.shape
    n = B * KV * _bwd_walks(Tq, 1, H, KV, D)[1] * _BWD_ROWS
    lse2, delta = work[:n], work[n:2 * n]
    _launched(lib.flash_backward_rowstat_launch(
        out.data_ptr(), do.data_ptr(), lse.data_ptr(), lse2.data_ptr(), delta.data_ptr(),
        B, Tq, H, KV, D, dev, stream), "flash_attention_backward_rowstat")
    return lse2, delta


def _launch_backward(q, k, v, out, lse, do, causal: bool):
    """Launch the backward kernels of the route :func:`_backward_kernel`
    takes on the current stream; returns ``(dq, dk, dv, workspace)``.
    ``q``, ``out``, ``do`` ``(B, Tq, H, D)`` and ``k``, ``v`` ``(B, Tk, KV,
    D)`` in one dtype (float32: ``csrc/flash_backward_f32.cu``, one launch;
    bfloat16: ``csrc/flash_backward.cu``, the short route's one launch or
    the long route's row statistics, wgmma dK / dV and dQ kernels and,
    where :func:`backward_splits` cuts the dK / dV walks, the reduce),
    float32 ``lse`` ``(B, Tq, H)``, all contiguous on one card; anything
    else raises, and a launch the card refuses raises too."""
    _check(q, k, v, None)
    if q.device.type != "cuda":
        raise ValueError(f"q lies on {q.device}: the backward kernels run on cuda")
    B, Tq, H, D = q.shape
    _, Tk, KV, _ = k.shape
    route = _backward_kernel(q.dtype, q.shape, k.shape)
    if route is None:
        raise ValueError(f"the backward kernels take float32 at head_dim <= {_MAX_HEAD_DIM} "
                         f"and H/KV <= {_MAX_GROUP}, bfloat16 at head_dim {_BWD_HEAD_DIMS}, or "
                         f"bfloat16 with Tq == Tk, one kv head, Tq * H <= {_BWD_ROWS} and "
                         f"head_dim <= {_BWD_ROWS}; got {q.dtype} q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}")
    for name, t, shape, dtype in (("out", out, q.shape, q.dtype), ("do", do, q.shape, q.dtype),
                                  ("lse", lse, (B, Tq, H), torch.float32)):
        if tuple(t.shape) != tuple(shape) or t.dtype != dtype or t.device != q.device:
            raise ValueError(f"{name} must be {dtype} {tuple(shape)} on {q.device}, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")
    for name, t in (("q", q), ("k", k), ("v", v), ("out", out), ("lse", lse), ("do", do)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    from .build import load

    dev = q.device.index if q.device.index is not None else torch.cuda.current_device()
    stream = ctypes.c_void_p(torch.cuda.current_stream(q.device).cuda_stream)
    if route == "f32":
        dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
        _launched(load("flash_backward_f32").flash_backward_f32_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(),
            do.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), B, Tq, Tk, H, KV, D,
            int(bool(causal)), 1.0 / math.sqrt(D), dev, stream), "flash_attention_backward_f32")
        LAUNCHES["flash_attention_backward"] += 1
        return dq, dk, dv, q.new_empty((0,), dtype=torch.float32)
    lib = load("flash_backward")
    if route == "short":
        dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
        _launched(lib.flash_backward_short_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), do.data_ptr(),
            lse.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), B, Tq, H, D,
            int(bool(causal)), 1.0 / math.sqrt(D), dev, stream), "flash_attention_backward_short")
        LAUNCHES["flash_attention_backward"] += 1
        return dq, dk, dv, q.new_empty((0,), dtype=torch.float32)
    splits = backward_splits(B, Tq, Tk, H, KV, _sm_count(dev), D)
    work = torch.empty(backward_workspace(B, Tq, Tk, H, KV, D, splits, q.dtype),
                       dtype=torch.float32, device=q.device)
    lse2, delta = _backward_rowstats(lib, out, do, lse, work, KV, dev, stream)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    n_kv = B * Tk * KV * D
    part_k = part_v = None
    if splits > 1:
        n0 = 2 * lse2.numel()
        part_k = work[n0:n0 + splits * n_kv]
        part_v = work[n0 + splits * n_kv:n0 + 2 * splits * n_kv]
    scale = 1.0 / math.sqrt(D)

    def ptr(t):
        return t.data_ptr() if t is not None else None

    _launched(lib.flash_backward_dkdv_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse2.data_ptr(),
        delta.data_ptr(), dk.data_ptr(), dv.data_ptr(), ptr(part_k), ptr(part_v),
        B, Tq, Tk, H, KV, D, int(bool(causal)), splits, scale, dev, stream),
        "flash_attention_backward_dkdv")
    _launched(lib.flash_backward_dq_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse2.data_ptr(),
        delta.data_ptr(), dq.data_ptr(), B, Tq, Tk, H, KV, D, int(bool(causal)), scale, dev,
        stream), "flash_attention_backward_dq")
    if splits > 1:
        _launched(lib.flash_backward_reduce_launch(
            part_k.data_ptr(), part_v.data_ptr(), dk.data_ptr(), dv.data_ptr(), n_kv, splits,
            scale, dev, stream), "flash_attention_backward_reduce")
    LAUNCHES["flash_attention_backward"] += 1
    return dq, dk, dv, work


@torch.library.custom_op("repro_torch::flash_attention_backward", mutates_args=())
def flash_attention_backward_op(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, out: torch.Tensor, lse: torch.Tensor,
    do: torch.Tensor, causal: bool, block_q: int, block_kv: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """K4's training backward as a registered op,
    ``repro_torch::flash_attention_backward``: ``(dq, dk, dv, workspace)``.
    On a CUDA tensor it launches the backward kernels
    (:func:`_launch_backward`; ``workspace`` is the long route's float32
    row statistics and dK / dV partials, empty on the short route and the
    float32 kernel's, returned so that a trace counts the bytes they hold,
    :func:`backward_workspace`); on a CPU tensor it is
    :func:`flash_attention_backward_plain` with ``block_q`` / ``block_kv``
    and an empty ``(0,)`` workspace.  Its fake implementation gives the
    kernels' shapes, workspace included, and its FLOP formula
    (:func:`_flash_backward_flops`) lets a FLOP count see the kernels."""
    if q.device.type == "cpu":
        dq, dk, dv = flash_attention_backward_plain(q, k, v, out, lse, do, causal=causal,
                                                    block_q=block_q, block_kv=block_kv)
        return dq, dk, dv, q.new_empty((0,), dtype=torch.float32)
    return _launch_backward(q, k, v, out, lse, do, causal)


@flash_attention_backward_op.register_fake
def _(q, k, v, out, lse, do, causal, block_q, block_kv):
    B, Tq, H, D = q.shape
    _, Tk, KV, _ = k.shape
    n = backward_workspace(B, Tq, Tk, H, KV, D, backward_splits(B, Tq, Tk, H, KV, D=D), q.dtype)
    return (torch.empty_like(q), torch.empty_like(k), torch.empty_like(v),
            q.new_empty((n,), dtype=torch.float32))


def _runs_plain(q: torch.Tensor) -> bool:
    """Whether the wrapper runs the plain version: a CPU tensor that holds
    data.  A fake tensor (a dry-run's trace, on either device) goes through
    the op, whose fake implementation carries the kernel's shapes and
    FLOPs."""
    from torch._subclasses.fake_tensor import is_fake

    return q.device.type == "cpu" and not is_fake(q)


def causal_pairs(Tq: int, Tk: int, q_offset: int, causal: bool) -> int:
    """The (query, key) pairs K4 scores for one (batch row, head): every
    ``Tq x Tk`` pair, or under ``causal`` the keys at or before each query's
    position ``q_offset + i``, at most ``Tk`` of them (none before key 0:
    a rank's key range can start past a query)."""
    if not causal:
        return Tq * Tk
    z = min(max(-q_offset, 0), Tq)                 # rows before the first key: none
    Tq, q_offset = Tq - z, q_offset + z
    tri = min(max(Tk - q_offset, 0), Tq)           # rows i whose keys q_offset + i + 1 <= Tk
    return tri * (q_offset + 1) + tri * (tri - 1) // 2 + (Tq - tri) * Tk


def _flash_flops(q_shape, k_shape, v_shape, kv_length_shape, causal, q_offset, with_lse,
                 block_q, block_kv, out_shape=None, **kwargs) -> int:
    """FLOPs of one K4 call: ``4 · B · H · D`` per (query, key) pair that
    :func:`causal_pairs` counts (``q·k`` and ``p·v``, two FLOPs per
    multiply-add each), the work of the causal triangle and not of the
    masked tiles; softmax exponentials are not counted, as the matmul
    formulas of ``torch.utils.flop_counter`` count none.  ``kv_length``
    lives on the device and is not read: the count covers the cache's
    ``Tk`` positions."""
    B, Tq, H, D = q_shape
    return 4 * B * H * D * causal_pairs(Tq, k_shape[1], q_offset, causal)


def _flash_backward_flops(q_shape, k_shape, v_shape, o_shape, lse_shape, do_shape, causal,
                          block_q, block_kv, out_shape=None, **kwargs) -> int:
    """FLOPs of one backward call: ``10 · B · H · D`` per (query, key) pair
    that :func:`causal_pairs` counts, the five products of the backward
    (``q·k``, ``do·v``, ``pᵀ·do``, ``dsᵀ·q``, ``ds·k``), two FLOPs per
    multiply-add each.  The long route's dQ pass and the float32 kernel's
    dQ blocks recompute ``q·k`` and ``do·v`` (the short route computes each
    product once): those two products are not counted, nor are the
    exponentials and the row sums of ``delta``."""
    B, Tq, H, D = q_shape
    return 10 * B * H * D * causal_pairs(Tq, k_shape[1], 0, causal)


def _register_flops() -> None:
    from torch.utils.flop_counter import register_flop_formula

    register_flop_formula(torch.ops.repro_torch.flash_attention)(_flash_flops)
    register_flop_formula(torch.ops.repro_torch.flash_attention_backward)(_flash_backward_flops)


_register_flops()


class FlashAttentionFn(torch.autograd.Function):
    """Attention without a cache under autograd: the port of the
    reference's ``_flash_train`` custom VJP.  The forward runs K4 with its
    ``lse`` output on a CUDA tensor (the plain version on a CPU one) and
    saves ``(q, k, v, out, lse)``; the backward goes through
    :func:`flash_attention_backward_op` (the backward kernels: every
    float32 call, and the bf16 routes' shapes) where
    :func:`backward_route` says ``'kernel'``, else through
    :func:`flash_attention_backward_plain`, as on a CPU tensor holding
    data.  No fallback: a kernel that fails to build or launch raises."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, block_q: int, block_kv: int):
        if _runs_plain(q):
            out, lse = flash_attention_plain(q, k, v, causal=causal, block_q=block_q,
                                             block_kv=block_kv, return_lse=True)
        else:
            out, lse = flash_attention_op(q, k, v, None, causal, 0, True, block_q, block_kv)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.blocks = (causal, block_q, block_kv)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        causal, block_q, block_kv = ctx.blocks
        with torch.profiler.record_function("repro_torch.flash_attention_backward"):
            if _runs_plain(q) or backward_route(q.dtype, q.shape, k.shape) == "plain":
                dq, dk, dv = flash_attention_backward_plain(
                    q, k, v, out, lse, do, causal=causal, block_q=block_q, block_kv=block_kv)
            else:
                dq, dk, dv, _ = flash_attention_backward_op(
                    q, k, v, out, lse, do.contiguous(), causal, block_q, block_kv)
        return dq, dk, dv, None, None, None


def flash_attention(
    q: torch.Tensor,             # (B, Tq, H, D)
    k: torch.Tensor,             # (B, Tk, KV, D)
    v: torch.Tensor,             # (B, Tk, KV, D)
    *,
    causal: bool = True,
    q_offset: int = 0,
    kv_length: Optional[torch.Tensor] = None,
    block_q: int = 512,
    block_kv: int = 1024,
) -> torch.Tensor:
    """Blockwise GQA attention, ``(B, Tq, H, D)`` in ``q.dtype``; never
    materializes ``(Tq, Tk)``.  Query head ``h`` reads kv head ``h // G``.

    ``q_offset``: absolute position of ``q[:, 0]`` (the cache length at
    prefill).  ``kv_length``: ``(B,)`` valid key prefix per batch row, or
    ``None`` for all ``Tk`` keys.  A CPU tensor runs
    :func:`flash_attention_plain`; a CUDA tensor (float32 or bfloat16,
    contiguous, ``D <= 128``, ``H / KV <= 64``) launches the K4 kernel its
    dtype and shape select (see the module docstring).  A call without a
    cache whose inputs require grad (grad mode on) goes through
    :class:`FlashAttentionFn`, as the reference's ``train_path`` goes
    through its custom VJP; a call with a cache that requires grad
    raises.

    DTensor ``q``, ``k``, ``v`` (the sharded train step's) run through
    :func:`sharded_flash_attention`: each rank calls this function on its
    own shards."""
    if is_dtensor(q):
        if kv_length is not None or q_offset != 0:
            raise ValueError("attention over a sharded KV cache is sharded_cached_attention's: "
                             "it writes the cache and runs K4 on each rank's key range")
        return sharded_flash_attention(q, k, v, causal=causal, block_q=block_q,
                                       block_kv=block_kv)
    _check(q, k, v, kv_length)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        if kv_length is not None or q_offset != 0:
            raise ValueError(
                "attention over a KV cache (q_offset > 0 or kv_length given) has no "
                "backward: call it without grad, or without a cache to train"
            )
        return FlashAttentionFn.apply(q, k, v, causal, block_q, block_kv)
    if _runs_plain(q):
        return flash_attention_plain(
            q, k, v, causal=causal, q_offset=q_offset, kv_length=kv_length,
            block_q=block_q, block_kv=block_kv,
        )
    return flash_attention_op(q, k, v, kv_length, causal, int(q_offset), False, block_q,
                              block_kv)[0]


def _attention_placements(q, k):
    """Per mesh dim, the placements K4's shards need: ``q`` split over its
    batch (dim 0) or heads (dim 2), or replicated; ``k`` / ``v`` split as
    ``q``'s batch, over their own heads where those line up with ``q``'s
    head blocks (``KV`` divides as ``H`` does), or replicated; and the
    gradient placements of ``k`` / ``v``: ``Partial`` where they are
    replicated beside ``q``'s head split (each rank's query heads add
    their share to the same kv heads)."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    mesh = q.device_mesh
    H, KV = q.shape[2], k.shape[2]
    qp, kp, kgp = [], [], []
    for i, (a, b) in enumerate(zip(q.placements, k.placements)):
        n = mesh.size(i)
        if a in (Shard(0), Shard(2)) and n > 1:
            qp.append(a)
        else:
            qp.append(Replicate())
        if qp[-1] == Shard(0):
            kp.append(Shard(0))
            kgp.append(Shard(0))
        elif qp[-1] == Shard(2):
            aligned = b == Shard(2) and KV % n == 0 and H % n == 0
            kp.append(Shard(2) if aligned else Replicate())
            kgp.append(Shard(2) if aligned else Partial())
        else:
            kp.append(Replicate())
            kgp.append(Replicate())
    return tuple(qp), tuple(kp), tuple(kgp)


def sharded_flash_attention(
    q, k, v, *, causal: bool = True, block_q: int = 512, block_kv: int = 1024,
):
    """:func:`flash_attention` of DTensor ``q`` ``(B, Tq, H, D)`` and
    ``k``, ``v`` ``(B, Tk, KV, D)`` without a cache, under
    ``torch.distributed.tensor.experimental.local_map``: each rank runs
    K4 (its plain version on a CPU tensor) and :class:`FlashAttentionFn`'s
    backward on its own batch rows and query heads, so no DTensor reaches
    the kernel's ``ctypes`` call or the backward's in-place adds.

    Inputs are redistributed to :func:`_attention_placements`' layout.
    A rank whose query heads are ``[h0, h0 + H_loc)`` reads kv heads
    ``[h0 // G, (h0 + H_loc - 1) // G]`` of its ``k`` / ``v`` shard (``G =
    H / KV``), so that each query head meets its own kv head as in the
    unsharded call; a head split that cuts a group unevenly raises.
    Each rank launches K4 once per call, as the unsharded step does."""
    from torch.distributed.tensor.experimental import local_map

    from ..distributed.sharding import local_shape_and_offset

    mesh = q.device_mesh
    qp, kp, kgp = _attention_placements(q, k)
    q = q.redistribute(mesh, qp)
    k = k.redistribute(mesh, kp)
    v = v.redistribute(mesh, kp)
    G = q.shape[2] // k.shape[2]
    q_shape, q_off = local_shape_and_offset(q.shape, mesh, qp)
    k_shape, k_off = local_shape_and_offset(k.shape, mesh, kp)
    h0, h_loc, kv0, kv_loc = q_off[2], q_shape[2], k_off[2], k_shape[2]
    lo, hi = h0 // G, (h0 + h_loc - 1) // G + 1
    g_loc = h_loc // (hi - lo) if h_loc else 1
    if h_loc and (lo < kv0 or hi > kv0 + kv_loc or h_loc % (hi - lo) or any(
            (h0 + j) // G - lo != j // g_loc for j in range(h_loc))):
        raise ValueError(
            f"query heads [{h0}, {h0 + h_loc}) of a {G}-head group size cannot meet "
            f"kv heads [{kv0}, {kv0 + kv_loc}) on this rank"
        )

    def local(q_l, k_l, v_l):
        if (lo, hi) != (kv0, kv0 + kv_loc):
            k_l = k_l[:, :, lo - kv0:hi - kv0].contiguous()
            v_l = v_l[:, :, lo - kv0:hi - kv0].contiguous()
        return flash_attention(q_l.contiguous(), k_l, v_l, causal=causal,
                               block_q=block_q, block_kv=block_kv)

    # a tuple of placements would read as one per output: lists here
    qp, kp, kgp = list(qp), list(kp), list(kgp)
    return local_map(local, out_placements=qp, in_placements=(qp, kp, kp),
                     in_grad_placements=(qp, kgp, kgp), device_mesh=mesh)(q, k, v)


def combine_key_ranges(out: torch.Tensor, lse: torch.Tensor, groups) -> torch.Tensor:
    """Attention over key ranges held by different ranks, combined: each
    rank's K4 output ``out`` ``(B, Tq, H, D)`` and log-sum-exp ``lse``
    ``(B, Tq, H)`` over its own keys, merged over the process groups
    ``groups`` (``(mesh, dim)`` pairs) with the split-KV combine's
    arithmetic: ``M`` the max of the ``lse`` over the ranks, then
    ``sum_r e^(lse_r - M) out_r / sum_r e^(lse_r - M)`` in float32, cast
    once.  A rank whose keys are all masked (``lse = +inf``) weighs 0.  At
    one rank the weight is 1 and the result is ``out`` bit for bit."""
    import torch.distributed._functional_collectives as funcol

    lse = torch.where(torch.isinf(lse), float("-inf"), lse)
    top = lse
    for g in groups:
        top = funcol.all_reduce(top, "max", g)
    top = torch.where(torch.isneginf(top), 0.0, top)
    w = torch.exp(lse - top)
    num, den = w[..., None] * out.float(), w
    for g in groups:
        num = funcol.all_reduce(num, "sum", g)
        den = funcol.all_reduce(den, "sum", g)
    return (num / torch.clamp(den[..., None], min=1e-20)).to(out.dtype)


def sharded_cached_attention(q, k, v, ck, cv, cache_len: int, *, causal: bool,
                             block_q: int = 512, block_kv: int = 1024):
    """Attention of DTensor ``q`` ``(B, T, H, D)`` over a sharded KV cache,
    after writing the new keys ``k``, ``v`` ``(B, T, KV, D)`` at positions
    ``[cache_len, cache_len + T)``: the prefill and decode of a sharded LM.

    The cache layer ``ck`` / ``cv`` ``(B, S, KV, D)`` is split by its
    placements (batch rows, kv heads, key positions: the cells' rules).
    Each rank writes the new positions that fall in its own key range
    ``[s0, s0 + S_loc)`` into its shard, then runs K4 on its shard with
    ``q_offset = cache_len - s0`` and ``kv_length`` the filled part of its
    range, its batch rows and query heads: the heads of its kv heads where
    the cache splits them, else those ``q`` holds, meeting their kv heads
    as :func:`sharded_flash_attention` slices them.  Where the key
    positions are split, each rank's K4 also gives its ``lse`` and
    :func:`combine_key_ranges` merges the ranges.  No DTensor reaches the
    kernel; the cache is updated in place."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    from ..distributed.sharding import local_shape_and_offset

    mesh = ck.device_mesh
    pc = tuple(ck.placements)
    seq_dims = [i for i, p in enumerate(pc) if p == Shard(1)]
    pk = tuple(Replicate() if p == Shard(1) else p for p in pc)
    pq = []
    for i, p in enumerate(pk):
        if p in (Shard(0), Shard(2)):
            pq.append(p)
        elif i not in seq_dims and q.placements[i] == Shard(2) and mesh.size(i) > 1:
            pq.append(Shard(2))              # q's heads split beside whole kv heads
        else:
            pq.append(Replicate())
    pq = tuple(pq)
    q, k, v = q.redistribute(mesh, pq), k.redistribute(mesh, pk), v.redistribute(mesh, pk)
    T = q.shape[1]
    (_, S_loc, kv_loc, _), (_, s0, kv0, _) = local_shape_and_offset(ck.shape, mesh, pc)
    ck_l, cv_l = ck.to_local(), cv.to_local()
    k_l, v_l, q_l = k.to_local(), v.to_local(), q.to_local()
    lo, hi = max(cache_len, s0), min(cache_len + T, s0 + S_loc)
    if lo < hi:                                    # this rank's new positions
        ck_l[:, lo - s0:hi - s0] = k_l[:, lo - cache_len:hi - cache_len]
        cv_l[:, lo - s0:hi - s0] = v_l[:, lo - cache_len:hi - cache_len]
    (_, _, h_loc, _), (_, _, h0, _) = local_shape_and_offset(q.shape, mesh, pq)
    G = q.shape[2] // ck.shape[2]
    a, b = h0 // G, (h0 + h_loc - 1) // G + 1       # the kv heads of this rank's q heads
    if a < kv0 or b > kv0 + kv_loc:
        raise ValueError(f"query heads [{h0}, {h0 + h_loc}) cannot meet kv heads "
                         f"[{kv0}, {kv0 + kv_loc}) on this rank")
    if (a, b) != (kv0, kv0 + kv_loc):
        ck_l, cv_l = ck_l[:, :, a - kv0:b - kv0], cv_l[:, :, a - kv0:b - kv0]
    kv_len = torch.full((q_l.shape[0],), max(0, min(cache_len + T - s0, S_loc)),
                        dtype=torch.int32, device=q_l.device)
    split = [(mesh, i) for i in seq_dims if mesh.size(i) > 1]
    out, lse = flash_attention_op(q_l.contiguous(), ck_l.contiguous(), cv_l.contiguous(),
                                  kv_len, causal, cache_len - s0, bool(split), block_q,
                                  block_kv)
    if split:
        out = combine_key_ranges(out, lse, split)
    return DTensor.from_local(out, mesh, pq, run_check=False, shape=q.shape, stride=q.stride())
