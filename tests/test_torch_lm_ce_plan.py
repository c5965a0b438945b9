"""K8's and K10's dh GEMM launch plan (kmbart_tpu_torch/ops/lm_ce.py dh_plan)
and the padded row pitch of their dlogits buffer.

csrc/lm_ce.cu runs dh = dlogits @ W on the main loop of csrc/wgmma_gemm.cuh
with the depth K = V, read through TMA maps whose row pitch must be a
multiple of 16 bytes. These tests hold on the CPU what the kernel decodes
from the plan: every output element is computed once in each split, the
splits walk the whole vocab (its ragged last 64-deep slice included) in
order, the persistent grid visits every tile once, the six D tiles of a row
block are neighbours in the tile order, and the pitch is the least multiple
of 8 bf16 columns that holds the vocab.
"""

import numpy as np
import pytest

from kmbart_tpu_torch.ops import ffn, lm_ce
from tests.test_torch_ffn_plan import _assert_partition, _intervals, _tile

# (rows, d_model, vocab): the fine-tune head (N 128 x 40), the pretraining
# head (N 128 x 72), chip_smoke.py's edge (ragged rows, a small ragged
# vocab), the CPU tests' heads, and a vocab that is a multiple of 8 but not
# of 64
SHAPES = [(5120, 768, 50320), (9216, 768, 50320), (24, 128, 1100), (48, 128, 1100),
          (64, 128, 2500), (1000, 768, 50264)]


@pytest.mark.parametrize("vocab,pitch", [(50320, 50320), (1100, 1104), (2500, 2504),
                                         (1024, 1024), (1, 8), (50265, 50272)])
def test_padded_vocab(vocab, pitch):
    assert lm_ce.padded_vocab(vocab) == pitch
    assert pitch >= vocab and pitch - vocab < 8
    assert (2 * pitch) % 16 == 0   # TMA's row pitch in bytes


@pytest.mark.parametrize("sms", [132, 114])
@pytest.mark.parametrize("n,d,v", SHAPES)
def test_dh_plan_covers_each_output_once_in_split_order(n, d, v, sms):
    g = lm_ce.dh_plan(n, d, v, sms)
    assert (g.rows, g.cols, g.depth) == (n, d, v)
    rows = _intervals(g.row_tiles, ffn.ROW_TILE, n)
    cols = _intervals(g.col_tiles, ffn.COL_TILE, d)
    depth = _intervals(g.splits, g.kper * ffn.K_TILE, v)
    _assert_partition(rows, n)
    _assert_partition(cols, d)
    _assert_partition(depth, v)   # split p sums vocab range p, added in p order
    ksteps = -(-v // ffn.K_TILE)
    assert sum(-(-(hi - lo) // ffn.K_TILE) for lo, hi in depth) == ksteps
    tiles = g.row_tiles * g.col_tiles * g.splits
    assert 1 <= g.ctas <= min(sms, tiles)
    visits = np.zeros(tiles, np.int64)
    for b in range(g.ctas):
        visits[b::g.ctas] += 1
    assert (visits == 1).all()
    count = np.zeros((g.splits, n, d), np.uint8)
    for t in range(tiles):
        s, r, c = _tile(t, g)
        count[s, rows[r][0]:rows[r][1], cols[c][0]:cols[c][1]] += 1
    assert (count == 1).all()


def test_dh_plan_at_the_heads():
    # fine-tune head: 40 x 6 output tiles, 1.8 waves on 132 SMs, no split;
    # the vocab walk is 786 full slices and one of 16 columns
    g = lm_ce.dh_plan(5120, 768, 50320, 132)
    assert (g.row_tiles, g.col_tiles, g.splits, g.kper, g.ctas) == (40, 6, 1, 787, 132)
    assert 50320 - 786 * ffn.K_TILE == 16
    # pretraining head: 72 x 6 tiles
    g = lm_ce.dh_plan(9216, 768, 50320, 132)
    assert (g.row_tiles, g.col_tiles, g.splits, g.ctas) == (72, 6, 1, 132)
    # the edge: one output tile, so the 18-slice vocab walk splits fully
    g = lm_ce.dh_plan(24, 128, 1100, 132)
    assert (g.row_tiles, g.col_tiles, g.splits, g.kper, g.ctas) == (1, 1, 18, 1, 18)


@pytest.mark.parametrize("n", [5120, 9216])
def test_dh_tile_order_keeps_a_row_block_together(n):
    """Columns fastest: the six D tiles of a row block are consecutive, so
    in each wave of the persistent grid all but the last row block run
    with every D tile, and the dlogits slice they share comes from L2."""
    g = lm_ce.dh_plan(n, 768, 50320, 132)
    order = [_tile(t, g)[1:] for t in range(g.row_tiles * g.col_tiles)]
    for r in range(g.row_tiles):
        assert order[r * g.col_tiles:(r + 1) * g.col_tiles] == [(r, c) for c in
                                                                range(g.col_tiles)]
    wave = order[:g.ctas]
    blocks = sorted({r for r, _ in wave})
    assert blocks == list(range(len(blocks)))
    assert all(sum(1 for r2, _ in wave if r2 == r) == g.col_tiles for r in blocks[:-1])
