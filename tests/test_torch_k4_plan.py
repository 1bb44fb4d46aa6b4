"""K4's launch plans, chosen in the wrapper from the call's shape: the
float32 kernel's query rows a block (:func:`f32_block_rows`), the bf16
prefill kernel's sequences a block (:func:`prefill_pack`), the bf16
prefill's kernel route (:func:`prefill_route`: the sm90 TMA / wgmma
kernel, the mma.sync kernel or its re-laid staging) and the sm90
kernel's block plan (:func:`sm90_prefill_plan`: rows, positions, grid,
key tile, stages, shared memory).  Plain Python: the CUDA kernels that
take these plans are held to the plain versions in
``tests/test_torch_cuda.py`` on the card."""
import pytest
import torch

from repro_torch.kernels import flash_attention as K

H100_SMS = 132
TILE = 64  # keys a tile of either kernel


def test_f32_rows_at_lm100m_fill_the_card():
    """lm-100m's training attention: q (4, 128, 8, 64) over 4 kv heads.  The
    64-row block of the first port gave 4 x 4 x 4 = 64 blocks; the plan
    gives at least one block an SM and at most two key tiles on the
    longest block (its last 8 positions see keys 0 .. 127)."""
    rows, blocks = K.f32_block_rows(4, 128, 8, 4, H100_SMS)
    assert (rows, blocks) == (16, 256)
    assert blocks >= H100_SMS
    positions = rows // 2                       # G = 2
    last_key = (128 // positions) * positions - 1
    assert -(-(last_key + 1) // TILE) <= 2


@pytest.mark.parametrize("B, Tq, H, KV", [
    (1, 4096, 32, 2),     # glm4-9b's prefill in float32 (the smoke's cache check)
    (8, 1, 32, 2),        # glm4-9b's decode: one position, 16 heads a block
    (2, 128, 4, 2),       # the kernel sweep
    (1, 40, 128, 2),      # G = 64: one position a block
    (3, 77, 6, 2),        # G = 3: 5 positions of 16 rows, 15 in use
    (65_536, 50, 1, 1),   # SASRec's batch in float32
    (4, 128, 8, 4),
])
def test_f32_rows_rule(B, Tq, H, KV):
    """Rows a block never fewer than the group's heads; the most rows whose
    grid gives two blocks an SM, and where no choice does, the fewest."""
    G = H // KV
    rows, blocks = K.f32_block_rows(B, Tq, H, KV, H100_SMS)
    assert rows in (16, 32, 64) and rows >= G
    assert blocks == -(-Tq // (rows // G)) * KV * B
    larger = [r for r in (64, 32, 16) if r > rows]
    for r in larger:
        assert -(-Tq // (r // G)) * KV * B < 2 * H100_SMS
    if blocks < 2 * H100_SMS:
        assert rows == max(16, 1 << (G - 1).bit_length())


def test_f32_rows_at_the_smoke_shapes():
    assert K.f32_block_rows(1, 4096, 32, 2) == (64, 2048)
    assert K.f32_block_rows(8, 1, 32, 2) == (16, 16)
    assert K.f32_block_rows(1, 40, 128, 2) == (64, 80)
    with pytest.raises(ValueError, match="at most 64"):
        K.f32_block_rows(1, 40, 256, 2)


def test_prefill_packs_two_sasrec_sequences():
    """SASRec: 50 positions, one head: two sequences a block, 100 of its
    128 rows, where one sequence gave 50."""
    assert K.prefill_pack(50, 50, 1, 0) == 2


@pytest.mark.parametrize("T, G, pack", [
    (1, 1, 128), (1, 64, 2), (49, 1, 2), (50, 1, 2), (64, 1, 2), (65, 1, 1),
    (20, 1, 6), (3, 1, 42), (32, 2, 2), (33, 2, 1), (8, 16, 1), (4, 16, 2),
])
def test_prefill_pack_fills_at_most_a_block(T, G, pack):
    """Whole sequences only, and only where one fills at most half of the
    block's 128 rows."""
    got = K.prefill_pack(T, T, G, 0)
    assert got == pack
    assert got * T * G <= 128
    assert got == 1 or 2 * T * G <= 128


@pytest.mark.parametrize("Tq, Tk, q_offset", [
    (50, 60, 0),      # a prefill into a longer cache
    (50, 50, 10),     # after a cached prefix: positions are not keys
    (30, 50, 20),
])
def test_prefill_packs_nothing_over_a_cache(Tq, Tk, q_offset):
    assert K.prefill_pack(Tq, Tk, 1, q_offset) == 1


def test_main_path_prefills_are_not_packed():
    """glm4-9b's, granite's and moonshot's prefills keep their query tiles."""
    assert K.prefill_pack(4096, 4128, 16, 0) == 1
    assert K.prefill_pack(4096, 4096, 16, 0) == 1
    assert K.prefill_pack(4096, 4096, 3, 0) == 1
    assert K.prefill_pack(4096, 4096, 1, 0) == 1


# ---------------------------------------------------------------------------
# The bf16 prefill's kernel route (prefill_route) and the sm90 kernel's plan
# ---------------------------------------------------------------------------

LM_ARCHS = ("glm4-9b", "granite-moe-3b-a800m", "moonshot-v1-16b-a3b", "llama3-405b")
SMEM_OPTIN = 232_448   # an H100 block's shared memory: 227 KB


def _heads(arch):
    from repro_torch.configs import registry

    cfg = registry.get_arch(arch).CONFIG
    return cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim


def _route(Tq, Tk, H, KV, D, q_offset=0, aligned=True, B=1):
    pack = K.prefill_pack(Tq, Tk, H // KV, q_offset)
    return K.prefill_route(torch.bfloat16, (B, Tq, H, D), (B, Tk, KV, D), pack, aligned)


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_prefill_route_is_sm90_at_the_lm_shapes(arch):
    """Every LM prefill the smoke serves (4096 tokens into a 4128-slot
    cache, and 64 after 200 cached) and the training forward (4096 tokens,
    no cache) take the TMA / wgmma kernel."""
    H, KV, D = _heads(arch)
    assert _route(4096, 4128, H, KV, D) == "sm90"
    assert _route(64, 600, H, KV, D, q_offset=200, B=2) == "sm90"
    assert _route(4096, 4096, H, KV, D, B=4) == "sm90"


@pytest.mark.parametrize("D", [8, 16, 24, 32, 48, 120])
def test_prefill_route_keeps_mma_at_other_head_dims(D):
    """A head dim that is a multiple of 8 other than 64 or 128 (the kernel
    sweep's 8, 16, 32), aligned and one sequence a block: the mma.sync
    kernel."""
    assert _route(100, 160, 4, 2, D, q_offset=30) == "mma"
    assert _route(256, 256, 8, 2, D) == "mma"


@pytest.mark.parametrize("Tq, Tk, H, KV, D, aligned, why", [
    (50, 50, 1, 1, 50, True, "SASRec's head: D = 50, two sequences a block"),
    (40, 96, 1, 1, 50, True, "D = 50 over a cache: not packed, re-laid all the same"),
    (300, 300, 32, 2, 128, False, "q, k or v not 16-byte aligned"),
    (20, 20, 4, 2, 64, True, "packed: three sequences of 20 x 2 rows a block"),
    (30, 30, 2, 2, 64, True, "packed at D = 64"),
])
def test_prefill_route_relays_what_flash_prefill_cu_relays(Tq, Tk, H, KV, D, aligned, why):
    assert _route(Tq, Tk, H, KV, D, aligned=aligned) == "relay", why


def test_prefill_route_takes_bfloat16_only():
    with pytest.raises(ValueError, match="bfloat16"):
        K.prefill_route(torch.float32, (1, 8, 2, 64), (1, 8, 2, 64), 1, True)


@pytest.mark.parametrize("D, G, positions, rows_used", [
    # 128 rows at head dim 128 (two consumer warpgroups), 192 at 64 (three)
    (128, 1, 128, 128), (128, 3, 42, 126), (128, 16, 8, 128), (128, 64, 2, 128),
    (64, 1, 192, 192), (64, 3, 64, 192), (64, 16, 12, 192), (64, 64, 3, 192),
])
def test_sm90_block_row_map(D, G, positions, rows_used):
    """A block's rows are the G heads of one kv head at rows // G
    positions; rows past the last whole position (granite's 126 and 127 at
    D = 128) are never written."""
    plan = K.sm90_prefill_plan(1, 4096, G * 2, 2, D)
    assert plan["rows"] == (128 if D == 128 else 192)
    assert plan["threads"] == 128 + 2 * plan["rows"]
    assert (plan["positions"], plan["rows_used"]) == (positions, rows_used)
    assert plan["rows"] - G < plan["rows_used"] <= plan["rows"]
    assert plan["rows_used"] > plan["rows"] - 64   # dead rows lie in the last warpgroup


@pytest.mark.parametrize("arch, items, blocks", [
    ("glm4-9b", 1024, 132),             # 512 query tiles of 8 positions x 2 kv heads
    ("granite-moe-3b-a800m", 512, 512),  # 64 tiles of 64 positions x 8, one block each
    ("moonshot-v1-16b-a3b", 512, 132),  # 32 tiles of 128 x 16
    ("llama3-405b", 4096, 132),         # 512 tiles of 8 x 8
])
def test_sm90_grid_at_the_lm_shapes(arch, items, blocks):
    """Head dim 128: a persistent grid of one block an SM walks the items;
    head dim 64 (granite): one block an item."""
    H, KV, D = _heads(arch)
    plan = K.sm90_prefill_plan(1, 4096, H, KV, D)
    assert plan["items"] == items == plan["qtiles"] * KV
    assert plan["blocks"] == blocks
    assert plan["persistent"] == (D == 128) and plan["pingpong"] == (D == 64)
    assert plan["qtiles"] * plan["positions"] >= 4096 > (plan["qtiles"] - 1) * plan["positions"]
    assert plan["items"] >= H100_SMS      # every SM has an item
    assert K.sm90_prefill_plan(2, 20, H, KV, D)["blocks"] == 2 * KV * -(-20 // plan["positions"])


@pytest.mark.parametrize("D", [64, 128])
def test_sm90_shared_memory_fits_a_block(D):
    """Q's rows and the ring's K / V tiles (plus 1024 bytes of alignment
    and the 1 + 2 x stages barriers of 8 bytes) fit the 227 KB a block may
    ask for; the tiles are whole 1024-byte swizzle atoms."""
    plan = K.sm90_prefill_plan(1, 4096, 32, 2, D)
    barriers = 8 * (1 + 2 * plan["stages"])
    assert plan["smem_bytes"] + barriers <= SMEM_OPTIN
    assert plan["block_kv"] % 16 == 0 and plan["block_kv"] <= 256
    assert (plan["block_kv"] * 128) % 1024 == 0 and (plan["rows"] * 128) % 1024 == 0


def test_sm90_constants_match_the_kernel_source():
    """The mirror's constants are the kernel's defaults in
    ``csrc/flash_prefill.cu``."""
    import re
    from pathlib import Path

    src = (Path(K.__file__).parent / "csrc" / "flash_prefill.cu").read_text()

    def define(name):
        return int(re.search(rf"#define {name} (\d+)", src).group(1))

    assert define("FLASH_PREFILL_SM90") == 1
    for D in (64, 128):
        assert define(f"FLASH_SM90_BKV_{D}") == K.sm90_block_kv(D)
        plan = K.sm90_prefill_plan(1, 128, 2, 1, D)
        assert define(f"FLASH_SM90_PINGPONG_{D}") == plan["pingpong"]
        assert define(f"FLASH_SM90_PERSISTENT_{D}") == plan["persistent"]
        assert define(f"FLASH_SM90_STAGES_{D}") == plan["stages"]
        assert 64 * define(f"FLASH_SM90_CONSUMERS_{D}") == plan["rows"]


# ---------------------------------------------------------------------------
# The bf16 training backward's long route: the wgmma kernels' plan
# (sm90_backward_plan), which the splits, the workspace and the mirror follow
# ---------------------------------------------------------------------------

TRAIN_ARCHS = ("glm4-9b", "granite-moe-3b-a800m", "llama3-405b", "yi-9b",
               "moonshot-v1-16b-a3b")


@pytest.mark.parametrize("arch", TRAIN_ARCHS)
def test_sm90_backward_plan_at_the_lm_training_shapes(arch):
    """A microbatch row of 4096 positions at each LM's heads: row tiles of
    floor(64 / G) positions (G of them in use per position), dK / dV blocks
    of 64 keys a consumer warpgroup in key tiles x kv heads x runs, two row
    tiles a dQ block,
    and both kernels' shared memory within a block's 227 KB (with their
    barriers)."""
    H, KV, D = _heads(arch)
    G = H // KV
    plan = K.sm90_backward_plan(1, 4096, 4096, H, KV, D)
    assert plan["positions"] == 64 // G
    assert plan["rows_used"] == G * (64 // G) > 64 - G
    assert plan["row_tiles"] == -(-4096 // plan["positions"])
    assert plan["key_tiles"] == 4096 // plan["keys"]
    assert plan["splits"] == K.backward_splits(1, 4096, 4096, H, KV, H100_SMS, D)
    assert plan["blocks"] == KV * plan["key_tiles"] * plan["splits"]
    assert plan["dq_blocks"] == KV * -(-plan["row_tiles"] // plan["dq_row_tiles"])
    assert plan["threads"] == 128 * (1 + plan["keys"] // 64)
    assert plan["dq_threads"] == 128 * (1 + plan["dq_row_tiles"])
    barriers = 8 * (1 + 2 * max(plan["stages"], plan["dq_stages"]))
    assert plan["smem_bytes"] + barriers <= SMEM_OPTIN
    assert plan["dq_smem_bytes"] + barriers <= SMEM_OPTIN
    assert plan["dq_stages"] >= 2
    # key tile 0 walks every row tile; the runs: the longest walk over an
    # SM's share of all walks, at most 8
    walks = [plan["row_tiles"] - min(k0 // plan["positions"], plan["row_tiles"])
             for k0 in range(0, 4096, plan["keys"])]
    assert plan["longest_walk"] == max(walks) == plan["row_tiles"]
    assert plan["splits"] == max(1, min(8, -(-max(walks) * H100_SMS // (KV * sum(walks)))))


@pytest.mark.parametrize("arch, rows, splits, blocks, dq_blocks", [
    ("glm4-9b", 64, 4, 256, 1024),              # G = 16: 1,024 row tiles of 4 positions
    ("granite-moe-3b-a800m", 63, 1, 512, 784),  # G = 3: 196 tiles of 21, 63 rows; 64-key blocks
    ("moonshot-v1-16b-a3b", 64, 1, 512, 512),   # G = 1: 64 tiles of 64 positions
])
def test_sm90_backward_plan_numbers(arch, rows, splits, blocks, dq_blocks):
    H, KV, D = _heads(arch)
    plan = K.sm90_backward_plan(1, 4096, 4096, H, KV, D)
    assert (plan["rows_used"], plan["splits"], plan["blocks"], plan["dq_blocks"]) == (
        rows, splits, blocks, dq_blocks)


@pytest.mark.parametrize("G, positions, rows_used", [
    (1, 64, 64), (2, 32, 64), (3, 21, 63), (5, 12, 60), (16, 4, 64), (48, 1, 48), (64, 1, 64),
])
def test_sm90_backward_row_tiles(G, positions, rows_used):
    """A row tile is floor(64 / G) whole positions: at most 64 rows, and
    fewer than G of its 64 slots idle."""
    plan = K.sm90_backward_plan(2, 129, 129, G * 2, 2, 64)
    assert (plan["positions"], plan["rows_used"]) == (positions, rows_used)
    assert plan["row_tiles"] == -(-129 // positions)
    ws = K.backward_workspace(2, 129, 129, G * 2, 2, 64, 1, torch.bfloat16)
    assert ws == 2 * 2 * 2 * plan["row_tiles"] * 64


def test_sm90_backward_refuses_what_it_does_not_take():
    with pytest.raises(ValueError, match="head dims"):
        K.sm90_backward_plan(1, 128, 128, 4, 2, 96)
    with pytest.raises(ValueError, match="at most 64"):
        K.sm90_backward_plan(1, 128, 128, 130, 1, 64)
    assert K._backward_kernel(torch.bfloat16, (1, 128, 130, 64), (1, 128, 1, 64)) is None


@pytest.mark.parametrize("B, T, H, KV, want", [
    (1, 4096, 32, 2, 4),     # glm4-9b: walks 1,024 .. 32 over 64 key tiles
    (1, 4096, 24, 8, 1),     # granite: 256 key tiles fill the card
    (1, 10, 10, 2, 1),       # one row tile
    (1, 2048, 64, 1, 8),     # G = 64, one position a tile: capped at 8
    (64, 4096, 32, 8, 1),
])
def test_backward_splits_follow_the_walks(B, T, H, KV, want):
    assert K.backward_splits(B, T, T, H, KV, H100_SMS, 128) == want


def test_sm90_backward_constants_match_the_kernel_source():
    """The mirror's constants are the kernels' in ``csrc/flash_backward.cu``
    (``Config<DP>``)."""
    import re
    from pathlib import Path

    src = (Path(K.__file__).parent / "csrc" / "flash_backward.cu").read_text()

    def const(name):
        return re.search(rf"static constexpr int {name} = ([^;]+);", src).group(1)

    assert int(re.search(r"constexpr int BQ = (\d+);", src).group(1)) == K._BWD_ROWS
    assert int(const("DQ_CONSUMERS")) == K._BWD_SM90_DQ_TILES
    keys = re.fullmatch(r"DP == 64 \? (\d+) : (\d+)", const("KEYS")).groups()
    for D, want in zip((64, 128), keys):
        plan = K.sm90_backward_plan(1, 128, 128, 2, 1, D)
        assert int(want) == plan["keys"]
        assert int(const("STAGES")) == plan["stages"]
        assert int(const("DQ_KEYS")) == plan["dq_keys"]
