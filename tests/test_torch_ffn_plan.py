"""K2/K2b launch plan (kmbart_tpu_torch/ops/ffn.py plan) and width predicate.

The CUDA kernels in csrc/ffn.cu decode their tiles from the plan's numbers;
these tests hold the plan itself on the CPU: every output element of both
GEMMs is computed exactly once in each split, the splits walk the depth in
order and cover it once, and the persistent grid visits every tile once.
"""

import numpy as np
import pytest

from kmbart_tpu_torch.ops import ffn

# main-path rows (generate decode step and encoder; fine-tune decoder and
# encoder; pretraining encoder) at BART-base widths, a wide FFN, ragged rows
# at tiny widths; H100 SXM (132 SMs) and PCIe (114)
SHAPES = [(320, 768, 3072), (4608, 768, 3072), (5120, 768, 3072), (9216, 768, 3072),
          (12288, 768, 3072), (1000, 1024, 4096), (4608, 1024, 4096), (37, 32, 64)]


def _intervals(n_parts, step, total):
    return [(i * step, min(total, (i + 1) * step)) for i in range(n_parts)]


def _assert_partition(intervals, total):
    """Non-empty, in order, back to back, covering [0, total)."""
    assert intervals[0][0] == 0 and intervals[-1][1] == total
    for (a0, a1), (b0, _) in zip(intervals, intervals[1:]):
        assert a1 == b0
    assert all(lo < hi for lo, hi in intervals)


def _tile(t, g):
    """Tile t's (split, row tile, column tile), decoded as the kernel does."""
    per_split = g.row_tiles * g.col_tiles
    return t // per_split, t % per_split // g.col_tiles, t % g.col_tiles


@pytest.mark.parametrize("sms", [132, 114])
@pytest.mark.parametrize("n,d,f", SHAPES)
def test_plan_covers_each_output_once_in_split_order(n, d, f, sms):
    first, second = ffn.plan(n, d, f, sms)
    assert (first.rows, first.cols, first.depth) == (n, f, d)
    assert (second.rows, second.cols, second.depth) == (n, d, f)
    assert first.splits == 1   # its epilogue (GELU or its derivative) needs whole sums
    for g in (first, second):
        rows = _intervals(g.row_tiles, ffn.ROW_TILE, g.rows)
        cols = _intervals(g.col_tiles, ffn.COL_TILE, g.cols)
        depth = _intervals(g.splits, g.kper * ffn.K_TILE, g.depth)
        _assert_partition(rows, g.rows)
        _assert_partition(cols, g.cols)
        _assert_partition(depth, g.depth)   # split p sums depth range p, added in p order
        tiles = g.row_tiles * g.col_tiles * g.splits
        assert 1 <= g.ctas <= min(sms, tiles)
        # block b of the persistent grid takes tiles b, b + ctas, ...: each once
        visits = np.zeros(tiles, np.int64)
        for b in range(g.ctas):
            visits[b::g.ctas] += 1
        assert (visits == 1).all()
        count = np.zeros((g.splits, g.rows, g.cols), np.uint8)
        for t in range(tiles):
            s, r, c = _tile(t, g)
            count[s, rows[r][0]:rows[r][1], cols[c][0]:cols[c][1]] += 1
        assert (count == 1).all()


def test_plan_splits_only_when_tiles_leave_sms_idle():
    # decode step: 3 x 6 output tiles of the second GEMM on 132 SMs
    _, second = ffn.plan(320, 768, 3072, 132)
    assert second.splits > 1 and second.row_tiles * second.col_tiles * second.splits <= 132
    # training rows fill the card with output tiles alone
    for n in (4608, 5120, 9216, 12288):
        assert ffn.plan(n, 768, 3072, 132)[1].splits == 1


def _pr4_supported(d, f):
    """The predicate of the wmma kernels this design replaced."""
    return d % 16 == 0 and d <= 1024 and f % 64 == 0


@pytest.mark.parametrize("d", [16, 32, 48, 64, 96, 128, 256, 512, 768, 1008, 1024])
def test_supported_takes_every_width_of_the_wmma_kernels(d):
    for f in range(64, 8193, 64):
        assert _pr4_supported(d, f)
        assert ffn.supported(d, f), (d, f)
    assert not ffn.supported(d + 8, 3072)   # D % 16 stays the gate
    assert not ffn.supported(d, 3072 + 32)  # and F % 64
