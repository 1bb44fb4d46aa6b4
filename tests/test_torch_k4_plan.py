"""K4's launch plans, chosen in the wrapper from the call's shape: the
float32 kernel's query rows a block (:func:`f32_block_rows`) and the bf16
prefill kernel's sequences a block (:func:`prefill_pack`).  Plain Python:
the CUDA kernels that take these plans are held to the plain versions in
``tests/test_torch_cuda.py`` on the card."""
import pytest

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
