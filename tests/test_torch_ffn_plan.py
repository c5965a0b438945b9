"""K2/K2b launch plans (kmbart_tpu_torch/ops/ffn.py plan and infer_plan) and
width predicate.

The CUDA kernels in csrc/ffn.cu decode their tiles from the plan's numbers;
these tests hold the plans themselves on the CPU: every output element of
both GEMMs is computed exactly once in each split, the splits walk the depth
in order and cover it once, and the persistent grid visits every tile once;
the inference route's parts are the same at every row count, a cluster
holds one tile's parts, and a decode step's F1 fills the card.
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


# The inference route's plan (ffn.infer_plan) at the rows its callers give
# it: one row, ragged rows, generation's decode step (64 x 5) and encoder
# (64 x 72), the serving pool's decode step (112 x 5) and admit (32 x 96);
# on 132 SMs with the cluster slots an H100 80GB HBM3 reported
# (cudaOccupancyMaxActiveClusters of the cluster kernel, sizes 1-8), and on
# 114 with the plan's default
INFER_ROWS = [1, 37, 320, 560, 3072, 4608]
H100_SLOTS = {1: 132, 2: 66, 3: 39, 4: 30, 5: 22, 6: 17, 7: 15, 8: 15}
SLOTS = {132: H100_SLOTS, 114: None}


def _parts(g, first, count):
    """Depth intervals of parts first, ..., first + count - 1."""
    return _intervals(g.splits, g.kper * ffn.K_TILE, g.depth)[first:first + count]


def _infer_blocks(g):
    """{block: [(row tile, column tile, [part indices in walk order])]}, decoded
    as csrc/wgmma_gemm.cuh tile_at decodes them for the plan's mode."""
    blocks = {}
    if g.mode == "cluster":
        ppc = g.splits // g.cluster
        for b in range(g.ctas):
            mn, rank = divmod(b, g.cluster)
            blocks[b] = [(mn // g.col_tiles, mn % g.col_tiles,
                          list(range(rank * ppc, rank * ppc + ppc)))]
        return blocks
    parts = list(range(g.splits))   # "plain" (F1, one part) and "sum": every part
    for t in range(g.row_tiles * g.col_tiles):
        blocks.setdefault(t % g.ctas, []).append((t // g.col_tiles, t % g.col_tiles, parts))
    return blocks


@pytest.mark.parametrize("sms", [132, 114])
@pytest.mark.parametrize("n", INFER_ROWS)
def test_infer_plan_covers_each_output_once_in_fixed_parts(n, sms):
    d, f = 768, 3072
    first, second = ffn.infer_plan(n, d, f, sms, SLOTS[sms])
    assert (first.rows, first.cols, first.depth) == (n, f, d)
    assert (second.rows, second.cols, second.depth) == (n, d, f)
    # F1 feeds GELU: one part, the whole depth
    assert first.splits == 1 and first.mode == "plain" and first.tile_rows in (64, 128)
    # F2: INFERENCE_KPER-slice parts at every N, in order, covering the depth once
    assert second.kper == ffn.INFERENCE_KPER
    assert (first.tile_rows, first.tile_cols) in ((128, 128), (64, 128))
    assert (second.tile_rows, second.tile_cols) in ((128, 128), (64, 128), (64, 256))
    depth = _intervals(second.splits, second.kper * ffn.K_TILE, f)
    _assert_partition(depth, f)
    assert depth == _intervals(6, 512, 3072)
    assert second.mode in ("sum", "cluster")
    for g in (first, second):
        assert 1 <= g.ctas
        rows = _intervals(g.row_tiles, g.tile_rows, g.rows)
        cols = _intervals(g.col_tiles, g.tile_cols, g.cols)
        _assert_partition(rows, g.rows)
        _assert_partition(cols, g.cols)
        count = np.zeros((g.splits, g.rows, g.cols), np.uint8)
        for b, tiles in _infer_blocks(g).items():
            assert 0 <= b < g.ctas
            for r, c, parts in tiles:
                assert parts == sorted(parts)   # a block walks its parts in order
                for p in parts:
                    count[p, rows[r][0]:rows[r][1], cols[c][0]:cols[c][1]] += 1
        assert (count == 1).all()   # each output element once in each part
    if second.mode == "sum":
        assert (second.tile_rows, second.tile_cols) == (ffn.ROW_TILE, ffn.COL_TILE)
        assert second.ctas == min(sms, second.row_tiles * second.col_tiles)
    else:
        assert second.ctas == second.row_tiles * second.col_tiles * second.cluster
        assert second.cluster <= ffn.MAX_CLUSTER and second.splits % second.cluster == 0


@pytest.mark.parametrize("f", [3072, 4096])
@pytest.mark.parametrize("mode", list(ffn.CLUSTER_MODES))
@pytest.mark.parametrize("n", INFER_ROWS)
def test_infer_plan_cluster_holds_one_tiles_parts(n, mode, f):
    """A cluster's blocks (consecutive, ``cluster`` of them) are one output
    tile's, and hold its parts exactly once, rank r the r-th run of
    splits / cluster of them."""
    ppc, tile = ffn.CLUSTER_MODES[mode]
    _, g = ffn.infer_plan(n, 768, f, 132, H100_SLOTS, mode=mode)
    assert g.mode == "cluster" and g.cluster == g.splits // ppc == f // 512 // ppc
    assert (g.tile_rows, g.tile_cols) == tile
    blocks = _infer_blocks(g)
    for c0 in range(0, g.ctas, g.cluster):
        members = [blocks[b][0] for b in range(c0, c0 + g.cluster)]
        assert len({(r, c) for r, c, _ in members}) == 1
        assert [p for _, _, parts in members for p in parts] == list(range(g.splits))


def test_infer_plan_fills_the_card_at_a_decode_step():
    first, second = ffn.infer_plan(320, 768, 3072, 132, H100_SLOTS)
    assert first.ctas >= 100
    # F2's clusters all fit the card at once (one wave) on 90 of its SMs:
    # 15 tiles of 64 x 256, one part a block, clusters of six. Every cluster
    # plan of 100 blocks or more (64 x 128 tiles in clusters of six: 180)
    # needs two waves, since an H100 holds 17 clusters of six at once, and
    # measured slower (chip_smoke.py's mode_ms)
    assert (second.mode, second.cluster, second.tile_cols) == ("cluster", 6, 256)
    assert second.row_tiles * second.col_tiles <= H100_SLOTS[second.cluster]
    assert second.ctas >= 2 * 132 // 3
    for m, (tile, size) in ffn.f2_modes(6, 132, H100_SLOTS).items():
        _, g = ffn.infer_plan(320, 768, 3072, 132, H100_SLOTS, mode=m)
        if m != "sum" and g.ctas >= 100:
            assert g.ctas // size > H100_SLOTS[size]


@pytest.mark.parametrize("n,mode", [(1, "cluster1@64x128"), (64, "cluster1@64x128"),
                                    (128, "cluster1@64x128"), (320, "cluster1@64x256"),
                                    (560, "cluster2@64x256"), (832, "cluster2@64x256"),
                                    (833, "sum"), (3072, "sum"), (4608, "sum")])
def test_infer_plan_clusters_only_what_one_wave_holds(n, mode):
    """F2 takes the first cluster mode whose clusters all fit the card at
    once (an H100's slots), else the running sum; F1 takes 64-row tiles
    while they fit in one wave."""
    first, second = ffn.infer_plan(n, 768, 3072, 132, H100_SLOTS)
    got = "sum" if second.mode == "sum" else next(
        m for m, (ppc, tile) in ffn.CLUSTER_MODES.items()
        if (second.tile_rows, second.tile_cols) == tile and second.cluster == 6 // ppc)
    assert got == mode
    if second.mode == "cluster":
        assert second.row_tiles * second.col_tiles <= H100_SLOTS[second.cluster]
    assert first.tile_rows == (64 if -(-n // 64) * 24 <= 132 else 128)


@pytest.mark.parametrize("f", [5120, 6144, 7168, 8192])
@pytest.mark.parametrize("n", [1, 320, 560])
def test_infer_plan_sums_more_parts_than_a_cluster_takes_in_one_block(n, f):
    """Past MAX_CLUSTER parts (F over 4096) no cluster mode is planned or
    accepted: csrc/wgmma_gemm.cuh cluster_reduce reads MAX_CLUSTER parts at
    most."""
    _, g = ffn.infer_plan(n, 768, f, 132, H100_SLOTS)
    assert g.splits == f // 512 > ffn.MAX_CLUSTER
    assert g.mode == "sum" and g.cluster == 1
    assert list(ffn.f2_modes(g.splits, 132, H100_SLOTS)) == ["sum"]
    for mode in ffn.CLUSTER_MODES:
        with pytest.raises(ValueError):
            ffn.infer_plan(n, 768, f, 132, H100_SLOTS, mode=mode)


def test_infer_plan_parts_do_not_depend_on_rows():
    plans = [ffn.infer_plan(n, 768, 3072, sms, SLOTS[sms])[1]
             for n in INFER_ROWS for sms in (132, 114)]
    assert {(g.splits, g.kper) for g in plans} == {(6, ffn.INFERENCE_KPER)}
    # ragged widths: the last part is short, still in order
    _, g = ffn.infer_plan(37, 32, 1088, 132)
    assert (g.splits, g.kper) == (3, 8)
    _assert_partition(_intervals(g.splits, g.kper * ffn.K_TILE, 1088), 1088)


def test_infer_plan_takes_no_cluster_the_card_cannot_hold():
    """A cluster size of which the card holds none (0 slots) is never
    planned: at N 320 the H100's choice (clusters of six) goes, and so does
    every mode of that size, forced or not."""
    slots = {**H100_SLOTS, 6: 0}
    _, g = ffn.infer_plan(320, 768, 3072, 132, slots)
    assert g.mode == "sum" or g.cluster != 6
    modes = ffn.f2_modes(6, 132, slots)
    assert not [m for m, c in modes.items() if c[1] == 6]
    with pytest.raises(ValueError):
        ffn.infer_plan(320, 768, 3072, 132, slots, mode="cluster1@64x256")
    # none at all: the running sum
    _, g = ffn.infer_plan(320, 768, 3072, 132, {size: 0 for size in H100_SLOTS})
    assert g.mode == "sum"
