"""K2's training forward and K2b: the training plan (kmbart_tpu_torch/ops/ffn.py
train_plan) and the Table layout's indexing, on the CPU.

csrc/ffn.cu kmb_ffn_fwd (with ``a``) and csrc/ffn_bwd.cu kmb_ffn_bwd decode
their tiles from the plan's numbers, as csrc/wgmma_gemm.cuh tile_at does:
one 128 x 128 tile a block (persistent, columns fastest, then rows, then
splits) on the Legacy, Fast and Table layouts. These tests decode every
plan the same way and hold it: every output element of both GEMMs computed
exactly once, the depth walked in order, the waves the plan reports, each
direction's first GEMM on the layout the plan's rule gives it. The Table
layout's epilogue reads gelu(a) of a bf16 a from a table indexed by a's
bits; a mirror of that index, tied to the source's constants, must map
every bf16 of the table's range to its own entry and every other to the
formula. The kernels themselves run only on the card (chip_smoke.py holds
each layout to the plain version and to Legacy's bits there).
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from kmbart_tpu_torch.ops import ffn

# the main-path rows (fine-tune decoder and encoder, pretraining encoder),
# generation's encoder and decode step, an odd count of 128-row tiles (41),
# a wide FFN and ragged rows at tiny widths
SHAPES = [(320, 768, 3072), (4608, 768, 3072), (5120, 768, 3072), (9216, 768, 3072),
          (12288, 768, 3072), (5157, 768, 3072), (1000, 1024, 4096), (37, 32, 64)]
SMS = [132, 114]
CSRC = Path(ffn.__file__).resolve().parents[1] / "csrc"


def _intervals(n_parts, step, total):
    return [(i * step, min(total, (i + 1) * step)) for i in range(n_parts)]


def _schedule(g):
    """[(block, split, row tile, column tile)] in each block's walk order,
    decoded as tile_at decodes the plan."""
    per_split = g.row_tiles * g.col_tiles
    return [(t % g.ctas, t // per_split, t % per_split // g.col_tiles, t % g.col_tiles)
            for t in range(per_split * g.splits)]


def _plans(n, d, f, sms):
    """Every plan train_plan gives at this shape: forward and backward, its
    own and with each first-GEMM layout forced."""
    for backward in (False, True):
        for layout in (None, "legacy", ffn.TRAIN_FIRST[backward]):
            yield ffn.train_plan(n, d, f, sms, backward, layout)


@pytest.mark.parametrize("sms", SMS)
@pytest.mark.parametrize("n,d,f", SHAPES)
def test_every_output_element_once_in_depth_order(n, d, f, sms):
    for first, second in _plans(n, d, f, sms):
        assert (first.rows, first.cols, first.depth) == (n, f, d)     # F1 and B1
        assert (second.rows, second.cols, second.depth) == (n, d, f)  # F2 and B2
        assert first.splits == 1   # its epilogue needs whole sums
        for g in (first, second):
            assert g.layout in ffn.TRAIN_LAYOUTS
            assert (g.tile_rows, g.tile_cols, g.mode, g.cluster) == (128, 128, "plain", 1)
            assert 1 <= g.ctas <= sms
            depth = _intervals(g.splits, g.kper * ffn.K_TILE, g.depth)
            assert depth[0][0] == 0 and depth[-1][1] == g.depth   # in order, back to back
            assert all(a1 == b0 for (_, a1), (b0, _) in zip(depth, depth[1:]))
            assert all(lo < hi for lo, hi in depth)
            rows = _intervals(g.row_tiles, g.tile_rows, g.rows)
            cols = _intervals(g.col_tiles, g.tile_cols, g.cols)
            assert rows[-1][1] == g.rows and cols[-1][1] == g.cols
            count = np.zeros((g.splits, g.rows, g.cols), np.uint8)
            for block, split, r, c in _schedule(g):
                assert 0 <= block < g.ctas
                count[split, rows[r][0]:rows[r][1], cols[c][0]:cols[c][1]] += 1
            assert (count == 1).all()


def test_odd_row_tiles_at_5157():
    """41 row tiles, the last of 37 rows (TMA zero-fills its reads past N
    and clips its stores): the first GEMM's 984 tiles give every block of
    132 seven or eight, the second's 246 two or one."""
    first, second = ffn.train_plan(5157, 768, 3072, 132)
    assert first.row_tiles == second.row_tiles == 41
    assert 5157 - 40 * 128 == 37
    assert (first.col_tiles, second.col_tiles, second.splits) == (24, 6, 1)
    assert (ffn.waves(first), ffn.waves(second)) == (8, 2)


@pytest.mark.parametrize("sms", SMS)
@pytest.mark.parametrize("n,d,f", SHAPES)
def test_waves_are_the_longest_blocks_walk(n, d, f, sms):
    for plan in _plans(n, d, f, sms):
        for g in plan:
            walks = {}
            for block, *_ in _schedule(g):
                walks[block] = walks.get(block, 0) + 1
            assert len(walks) == g.ctas   # no block without a tile
            assert ffn.waves(g) == max(walks.values())
    # the second GEMM at the training rows: 128 x 128 tiles a block, so many
    # waves of the card's blocks
    assert [ffn.waves(ffn.train_plan(n, 768, 3072, 132)[1]) for n in (5120, 9216, 12288)] == \
        [2, 4, 5]


@pytest.mark.parametrize("backward", [False, True])
@pytest.mark.parametrize("sms", SMS)
@pytest.mark.parametrize("n,d,f", SHAPES)
def test_the_plans_stated_rule(n, d, f, sms, backward):
    """B1 takes "fast" at every shape, F1 "table" where D is at least
    TABLE_MIN_DEPTH and "legacy" below it, on plan's tiles and grid; the
    second GEMM keeps plan's Legacy GEMM (and its split); forcing "legacy"
    gives plan's numbers whole."""
    first, second = ffn.train_plan(n, d, f, sms, backward)
    legacy = ffn.plan(n, d, f, sms)
    want = "fast" if backward else ("table" if d >= ffn.TABLE_MIN_DEPTH else "legacy")
    assert first.layout == want
    assert first._replace(layout="legacy") == legacy[0]   # Fast and Table keep its tiles
    assert second == legacy[1]
    assert ffn.train_plan(n, d, f, sms, backward, "legacy") == legacy
    assert ffn.TRAIN_FIRST == {False: "table", True: "fast"}


def test_the_rule_at_the_measured_depths():
    """D 768 and 1024 (measured faster on Table) take it, D 32 (measured
    slower) keeps Legacy; the main path's rows all take Table."""
    assert ffn.TABLE_MIN_DEPTH == 768
    for n, d, f, want in ((9216, 768, 3072, "table"), (1000, 1024, 4096, "table"),
                          (37, 32, 64, "legacy"), (5157, 704, 3072, "legacy")):
        assert ffn.train_plan(n, d, f, 132)[0].layout == want
        assert ffn.train_plan(n, d, f, 132, backward=True)[0].layout == "fast"


def test_a_forced_layout_is_one_the_direction_runs():
    with pytest.raises(ValueError):
        ffn.train_plan(9216, 768, 3072, 132, backward=False, layout="fast")
    with pytest.raises(ValueError):
        ffn.train_plan(9216, 768, 3072, 132, backward=True, layout="table")
    with pytest.raises(ValueError):
        ffn.train_plan(9216, 768, 3072, 132, layout="pair256")
    assert ffn.train_plan(37, 32, 64, 132, layout="table")[0].layout == "table"


def test_each_entry_takes_legacy_and_its_own_layout():
    """kmb_ffn_fwd's first GEMM runs Legacy or Table, kmb_ffn_bwd's Legacy
    or Fast; any other code is refused (cudaErrorInvalidValue), and the
    codes are the source's."""
    src = (CSRC / "wgmma_gemm.cuh").read_text()
    codes = dict((name.lower(), int(v)) for name, v in re.findall(r"TRAIN_(\w+) = (\d+)", src))
    assert codes == ffn.TRAIN_LAYOUTS
    for name, own in (("ffn.cu", "Table"), ("ffn_bwd.cu", "Fast")):
        body = (CSRC / name).read_text().split("cudaError_t gemm_first(")[1].split("\n}\n")[0]
        assert re.findall(r"if \(layout == TRAIN_(\w+)\)", body) == ["LEGACY", own.upper()]
        assert body.rstrip().endswith("return cudaErrorInvalidValue;")
        assert f", {own}>(" in body


def test_without_a_the_partials_route_keeps_legacy(monkeypatch):
    """kmb_ffn_fwd without a (fused_ffn_partials) gets plan's Legacy
    numbers at the inference split, layout code 0, which the entry point
    requires of a call without a."""
    monkeypatch.setattr(ffn, "sm_count", lambda device: 132)
    for n in (320, 4608, 9216):
        first, second = ffn.plan(n, 768, 3072, 132, True)
        splits, args = ffn._plan_args.__wrapped__(n, 768, 3072, "card", invariant=True)
        assert args == (first.ctas, second.ctas, second.splits, second.kper, 0)
        assert splits == second.splits == 6
        # with a: train_plan's numbers and code, or Legacy's when asked
        for backward in (False, True):
            fwd = ffn.train_plan(n, 768, 3072, 132, backward)
            _, args = ffn._plan_args.__wrapped__(n, 768, 3072, "card", backward=backward)
            assert args == (fwd[0].ctas, fwd[1].ctas, fwd[1].splits, fwd[1].kper,
                            ffn.TRAIN_LAYOUTS[ffn.TRAIN_FIRST[backward]])
            _, args = ffn._plan_args.__wrapped__(n, 768, 3072, "card", backward=backward,
                                                 layout="legacy")
            assert args[4] == 0
    src = (CSRC / "ffn.cu").read_text()
    assert "(a_out == nullptr && lay1)" in src


# ---------------------------------------------------------------------------
# the Table layout's index (csrc/wgmma_gemm.cuh lut_index, lut_build)


def _lut_constants():
    src = (CSRC / "wgmma_gemm.cuh").read_text()
    m = re.search(r"constexpr int LUT_E0 = 127 - (\d+), LUT_NE = (\d+);", src)
    assert m, "LUT_E0 / LUT_NE moved"
    return 127 - int(m.group(1)), int(m.group(2))


def _lut_index(u, e0, ne):
    """lut_index: a's bits less e0 << 7, the sign's half after the other, or
    -1 outside [0, ne · 128)."""
    half = ne * 128
    w = (u & 0x7FFF) - (e0 << 7)
    return np.where((w >= 0) & (w < half), w + (u >> 15) * half, -1)


def _lut_entry_bits(i, e0, ne):
    """lut_build: the bf16 bits of entry i."""
    half = ne * 128
    return np.where(i >= half, 0x8000, 0) | (i % half + (e0 << 7))


def test_table_index_is_a_bijection_onto_its_range():
    e0, ne = _lut_constants()
    u = np.arange(1 << 16, dtype=np.int64)
    idx = _lut_index(u, e0, ne)
    held = idx >= 0
    assert held.sum() == 2 * ne * 128
    assert np.array_equal(np.sort(idx[held]), np.arange(2 * ne * 128))
    assert np.array_equal(_lut_entry_bits(idx[held], e0, ne), u[held])   # the build's inverse
    # the held a: magnitudes in [2^(e0 - 127), 2^(e0 - 127 + ne)), both signs
    a = torch.from_numpy(u.astype(np.int32) << 16).view(torch.float32).numpy()
    mag = np.abs(a)
    with np.errstate(invalid="ignore"):
        want = (mag >= 2.0 ** (e0 - 127)) & (mag < 2.0 ** (e0 - 127 + ne))
    assert np.array_equal(held, want)
    assert (e0 - 127, e0 - 127 + ne) == (-16, 4)
    # zeros, tiny and huge a, inf and nan take the formula
    for v in (0.0, -0.0, 1e-6, -1e-6, 16.0, -16.0, 1e30, float("inf"), float("nan")):
        bits = int(torch.tensor([v], dtype=torch.bfloat16).view(torch.int16).item()) & 0xFFFF
        assert _lut_index(np.int64(bits), e0, ne) == -1, v
