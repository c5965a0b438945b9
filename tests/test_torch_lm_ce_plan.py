"""K8's launch plan (kmbart_tpu_torch/ops/lm_ce.py bwd_plan), whose vocab
parts K10's second pass shares on units of its own (dh_plan), and the
padded row pitch of their dlogits buffer; the projection plan of K7, K9
and K10's first pass (coop_plan) with its rows-fastest tile order; the
shared-memory and register budgets of their layouts and of K10's second
pass, read from their sources; emulations of K7's (and K9's)
statistics epilogue and merge and of K10's dlogits epilogue against the
JAX package's Pallas kernels.

csrc/lm_ce_bwd.cu walks the vocab in 32-deep slices for 64-row units
across 768-column groups of D, read through TMA maps whose row pitch must
be a multiple of 16 bytes. These tests hold on the CPU what the kernel
decodes from the plan: every (part, row block, column group) unit is one
persistent block's, each output element is summed once in each part, the
parts walk the whole vocab (its ragged last slice included) in order, the
persistent blocks walk it in step, and the pitch is the least multiple of
8 bf16 columns that holds the vocab.
"""

import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kmbart_tpu.ops.pallas_lm_ce import (_fwd_project_stats_call, _fwd_stats_call,
                                         _recompute_bwd_call)
from kmbart_tpu_torch.ops import _cuda, ffn, lm_ce
from tests._torch_port import bf16_tol, to_jax, to_np, to_torch
from tests.test_torch_beam_plan import _bf16, _butterfly

# (rows, d_model, vocab): the fine-tune head (N 128 x 40), the pretraining
# head (N 128 x 72), the 12288-row head of the K2 rows, chip_smoke.py's
# edge (ragged rows, a small ragged vocab), the CPU tests' heads, a vocab
# that is a multiple of 8 but not of 64, and a 1024-wide head (two column
# groups of K8's units)
SHAPES = [(5120, 768, 50320), (9216, 768, 50320), (12288, 768, 50320), (24, 128, 1100),
          (48, 128, 1100), (64, 128, 2500), (1000, 768, 50264), (4608, 1024, 50265)]


@pytest.mark.parametrize("vocab,pitch", [(50320, 50320), (1100, 1104), (2500, 2504),
                                         (1024, 1024), (1, 8), (50265, 50272)])
def test_padded_vocab(vocab, pitch):
    assert lm_ce.padded_vocab(vocab) == pitch
    assert pitch >= vocab and pitch - vocab < 8
    assert (2 * pitch) % 16 == 0   # TMA's row pitch in bytes


def bwd_unit(t, g):
    """K8's unit t as (part, row block, column group), decoded as
    csrc/lm_ce_bwd.cu unit_at does: parts slowest, then row blocks, then
    column groups."""
    per = g.row_blocks * g.groups
    return t // per, t % per // g.groups, t % g.groups


def bwd_parts(g):
    """The vocab slices [kb, kb + nk) of each part, as unit_at takes them."""
    ksteps = -(-g.depth // lm_ce.BWD_SLICE)
    return [(s * g.kper, min(ksteps, (s + 1) * g.kper)) for s in range(g.splits)]


@pytest.mark.parametrize("sms", [132, 114])
@pytest.mark.parametrize("n,d,v", SHAPES)
def test_bwd_plan_covers_each_unit_once_in_split_order(n, d, v, sms):
    g = lm_ce.bwd_plan(n, d, v, sms)
    assert (g.rows, g.cols, g.depth) == (n, d, v)
    assert g.row_blocks == -(-n // lm_ce.BWD_ROWS) and g.groups == -(-d // lm_ce.BWD_GROUP)
    ksteps = -(-v // lm_ce.BWD_SLICE)
    # the parts partition the vocab slices in order, none empty, and cover
    # the ragged last slice
    parts = bwd_parts(g)
    assert parts[0][0] == 0 and parts[-1][1] == ksteps
    assert all(lo < hi for lo, hi in parts)
    assert all(a[1] == b[0] for a, b in zip(parts, parts[1:]))
    assert (ksteps - 1) * lm_ce.BWD_SLICE < v <= ksteps * lm_ce.BWD_SLICE
    assert 1 <= g.ctas <= min(sms, g.units)
    visits = np.zeros(g.units, np.int64)
    for b in range(g.ctas):
        visits[b::g.ctas] += 1
    assert (visits == 1).all()
    # each (part, row block, group) once; within each part every output
    # element is summed by exactly one unit
    seen = {bwd_unit(t, g) for t in range(g.units)}
    assert len(seen) == g.units
    count = np.zeros((g.splits, n, d), np.uint8)
    for s, r, c in seen:
        row0, col0 = r * lm_ce.BWD_ROWS, c * lm_ce.BWD_GROUP
        assert row0 < n and col0 < d
        count[s, row0:row0 + lm_ce.BWD_ROWS, col0:col0 + lm_ce.BWD_GROUP] += 1
    assert (count == 1).all()


def test_bwd_plan_at_the_heads():
    # fine-tune head: 80 row blocks, the 1573-slice vocab walk (1572 full
    # slices and one of 16 columns) in three parts: 240 units in two waves
    g = lm_ce.bwd_plan(5120, 768, 50320, 132)
    assert (g.row_blocks, g.groups, g.splits, g.kper, g.ctas) == (80, 1, 3, 525, 132)
    assert 50320 - 1572 * lm_ce.BWD_SLICE == 16
    # pretraining head: 144 row blocks in seven parts (1008 units)
    g = lm_ce.bwd_plan(9216, 768, 50320, 132)
    assert (g.row_blocks, g.groups, g.splits, g.kper, g.ctas) == (144, 1, 7, 225, 132)
    # 132 row blocks fill the card at once: no split, no partials
    g = lm_ce.bwd_plan(8448, 768, 50320, 132)
    assert (g.splits, g.ctas) == (1, 132)
    # the edge: one unit, so the 35-slice vocab walk splits fully
    g = lm_ce.bwd_plan(24, 128, 1100, 132)
    assert (g.row_blocks, g.groups, g.splits, g.kper, g.ctas) == (1, 1, 35, 1, 35)
    # a 1024-wide head takes two column groups
    assert lm_ce.bwd_plan(4608, 1024, 50265, 132).groups == 2
    # a forced part count (the chip check's one-part launch)
    g = lm_ce.bwd_plan(5120, 768, 50320, 132, splits=1)
    assert (g.splits, g.kper, g.ctas) == (1, 1573, 80)


@pytest.mark.parametrize("n", [5120, 9216])
def test_bwd_units_walk_the_vocab_in_step(n):
    """Parts slowest: at any moment the persistent blocks hold units of at
    most two neighbouring parts, so they read the same W slices at about
    the same time and each comes from HBM about once, and a part's row
    blocks are consecutive."""
    g = lm_ce.bwd_plan(n, 768, 50320, 132)
    order = [bwd_unit(t, g) for t in range(g.units)]
    for s in range(g.splits):
        block = order[s * g.row_blocks:(s + 1) * g.row_blocks]
        assert block == [(s, r, 0) for r in range(g.row_blocks)]
    for w0 in range(0, g.units, g.ctas):
        wave = sorted({s for s, _, _ in order[w0:w0 + g.ctas]})
        assert len(wave) <= 2 and wave == list(range(wave[0], wave[-1] + 1))


@pytest.mark.parametrize("sms", [132, 114])
@pytest.mark.parametrize("n,d,v", SHAPES)
def test_coop_plan_covers_each_tile_once_rows_fastest(n, d, v, sms):
    """The plan of K7, K9 and K10's first pass: the rows-fastest order on
    256 x 128 tiles, each consumer warpgroup on 128 of a tile's
    rows; every (row tile, column tile) is one persistent block's once, and
    each row's partial at column index col0 / 128 (or its dlogits in the
    tile's columns) is written exactly once, by the consumer that holds the
    row."""
    g = lm_ce.coop_plan(n, d, v, sms)
    assert (g.rows, g.cols, g.depth, g.splits) == (n, v, d, 1)
    assert g.tile_rows == lm_ce.COOP_ROWS and g.row_tiles == -(-n // lm_ce.COOP_ROWS)
    assert g.col_tiles == -(-v // lm_ce.TILE_V)
    tiles = g.row_tiles * g.col_tiles
    assert 1 <= g.ctas <= min(sms, tiles)
    visits = np.zeros(tiles, np.int64)
    for b in range(g.ctas):
        visits[b::g.ctas] += 1
    assert (visits == 1).all()
    partial = np.zeros((n, g.col_tiles), np.uint8)
    for t in range(tiles):
        r, c = _tile_rows_first(t, g)
        for cw in range(2):
            row0 = r * lm_ce.COOP_ROWS + 128 * cw
            partial[row0:min(n, row0 + 128), c] += 1
    assert (partial == 1).all()


def test_coop_plan_at_the_heads():
    # pretraining head: 36 row tiles of 256 x 394 column tiles on every SM
    g = lm_ce.coop_plan(9216, 768, 50320, 132)
    assert (g.row_tiles, g.col_tiles, g.kper, g.ctas) == (36, 394, 12, 132)
    # the edge: one row tile (24 rows, consumer 1's all past N), nine columns
    g = lm_ce.coop_plan(24, 128, 1100, 132)
    assert (g.row_tiles, g.col_tiles, g.ctas) == (1, 9, 9)
    # the fine-tune head (K7's): 20 row tiles of 256
    assert lm_ce.coop_plan(5120, 768, 50320, 132).row_tiles == 20


def dh_unit(t, g):
    """K10's second-pass unit t as (part, row block, column block), decoded
    as csrc/lm_ce_bwd.cu unit_at<DH_ROWS, DH_COLS> does: parts slowest, then
    row blocks of 128, then the 384-column blocks of D."""
    per = g.row_blocks * g.groups
    return t // per, t % per // g.groups, t % g.groups


@pytest.mark.parametrize("sms", [132, 114])
@pytest.mark.parametrize("n,d,v", SHAPES)
def test_dh_plan_covers_each_row_column_and_slice_once(n, d, v, sms):
    """K10's second pass: every (row, column of D, vocab slice) is summed by
    exactly one unit, whose part holds the slice, and every unit is one
    persistent block's."""
    g = lm_ce.dh_plan(n, d, v, sms)
    assert (g.rows, g.cols, g.depth) == (n, d, v)
    assert g.row_blocks == -(-n // lm_ce.DH_ROWS) and g.groups == -(-d // lm_ce.DH_COLS)
    assert 1 <= g.ctas <= min(sms, g.units)
    visits = np.zeros(g.units, np.int64)
    for b in range(g.ctas):
        visits[b::g.ctas] += 1
    assert (visits == 1).all()
    ksteps = -(-v // lm_ce.BWD_SLICE)
    parts = bwd_parts(g)
    assert parts[0][0] == 0 and parts[-1][1] == ksteps
    assert all(a[1] == b[0] for a, b in zip(parts, parts[1:]))
    # (row block, column block, slice) counts at the units' granularity,
    # then each row and column of D through its blocks
    count = np.zeros((g.row_blocks, g.groups, ksteps), np.uint8)
    for t in range(g.units):
        s, r, c = dh_unit(t, g)
        assert r * lm_ce.DH_ROWS < n and c * lm_ce.DH_COLS < d
        count[r, c, parts[s][0]:parts[s][1]] += 1
    assert (count == 1).all()
    rows = np.arange(n) // lm_ce.DH_ROWS
    cols = np.arange(d) // lm_ce.DH_COLS
    assert rows.max() == g.row_blocks - 1 and cols.max() == g.groups - 1


@pytest.mark.parametrize("sms", [132, 114])
@pytest.mark.parametrize("n,d,v", SHAPES + [(200, 768, 300), (70, 1024, 300)])
def test_dh_plan_takes_k8s_parts(n, d, v, sms):
    """K10's dh equals K8's bit for bit only if each element sums the same
    slices in the same parts: dh_plan's splits and kper are bwd_plan's at
    every shape (ragged rows over two 384-column halves and a 1024-wide head
    at a one-slice-a-part vocab among them), and where the rows fill 128-row
    blocks at D 768 (the fine-tune and pretraining heads) its unit count is
    K8's too. Within a part the sum is the wgmma chain over the same 192
    columns, which only the card can hold equal (chip_smoke.py's
    equal_to_k8)."""
    k8, dh = lm_ce.bwd_plan(n, d, v, sms), lm_ce.dh_plan(n, d, v, sms)
    assert (dh.splits, dh.kper) == (k8.splits, k8.kper)
    if n % lm_ce.DH_ROWS == 0 and d == 2 * lm_ce.DH_COLS:
        assert (dh.units, dh.ctas) == (k8.units, k8.ctas)


def test_dh_plan_at_the_heads():
    # pretraining head: 72 row blocks x 2 halves in K8's seven parts
    g = lm_ce.dh_plan(9216, 768, 50320, 132)
    assert (g.row_blocks, g.groups, g.splits, g.kper, g.units, g.ctas) == (72, 2, 7, 225, 1008,
                                                                          132)
    # fine-tune head: K8's three parts, 240 units
    g = lm_ce.dh_plan(5120, 768, 50320, 132)
    assert (g.row_blocks, g.groups, g.splits, g.kper, g.units) == (40, 2, 3, 525, 240)
    # the edge: one 128-row block, one column block, K8's 35 one-slice parts
    g = lm_ce.dh_plan(24, 128, 1100, 132)
    assert (g.row_blocks, g.groups, g.splits, g.kper, g.ctas) == (1, 1, 35, 1, 35)
    # a 1024-wide head: three 384-column blocks, the last two thirds empty
    g = lm_ce.dh_plan(136, 1024, 2100, 132)
    assert (g.row_blocks, g.groups) == (2, 3)


@pytest.mark.parametrize("n", [5120, 9216])
def test_dh_units_put_the_halves_of_a_row_block_side_by_side(n):
    """The two halves of each 128-row block are consecutive units (they
    read the same dlogits rows, which then come from L2), and a wave of the
    persistent grid spans at most two neighbouring parts."""
    g = lm_ce.dh_plan(n, 768, 50320, 132)
    order = [dh_unit(t, g) for t in range(g.units)]
    for t in range(0, g.units, 2):
        (s0, r0, c0), (s1, r1, c1) = order[t], order[t + 1]
        assert (s0, r0) == (s1, r1) and (c0, c1) == (0, 1)
    for w0 in range(0, g.units, g.ctas):
        wave = sorted({s for s, _, _ in order[w0:w0 + g.ctas]})
        assert len(wave) <= 2 and wave == list(range(wave[0], wave[-1] + 1))


def _constants(path, env=None):
    """The integer constexprs of a CUDA source, evaluated in order (``env``:
    those of a header it includes, its ``kmb_wg::`` names)."""
    env = dict(env or {})
    with open(os.path.join(_cuda.CSRC_DIR, path)) as f:
        text = f.read()
    for name, expr in re.findall(r"constexpr int (\w+) = ([^;]+);", text):
        try:
            expr = expr.replace("kmb_wg::", "").replace("/", "//")
            env[name] = int(eval(expr, {}, dict(env)))
        except (NameError, SyntaxError):
            pass
    return env, text


SMEM_LIMIT = 232448   # the 227 KB a block may use on an H100


def _layout_smem(c, text, name):
    """SMEM_BYTES of a Layout alias of csrc/wgmma_gemm.cuh, computed as the
    Layout template computes it from the alias's arguments."""
    m = re.search(rf"using {name} = Layout<([^>]*)>;", text)
    args = [a.strip() for a in m.group(1).split(",")]
    args += ["false"] * (10 - len(args))
    h, coop, _, stages, _, wide, _, lut, nobuf, halfbuf = args
    stages = c[stages] if stages in c else int(stages)
    h = int(h)
    wg_rows = 64 * h
    tile_rows = wg_rows * (2 if coop == "true" else 1)
    tile_cols = c["BN"] * (2 if wide == "true" else 1)
    stage = tile_rows * c["BK"] * 2 + tile_cols * c["BK"] * 2
    bufs = 0 if nobuf == "true" else 2
    buf_cols = c["BN"] // 2 if halfbuf == "true" else c["BN"]
    lut_bytes = c["LUT_BYTES"] if lut == "true" else 0
    return stages, stage, stages * stage + bufs * wg_rows * buf_cols * 2 + 8 * (
        2 * stages + 4) + lut_bytes + 1024


def test_coop_layouts_fit_and_their_registers_balance():
    """The layouts of K7 and K9 (csrc/lm_ce.cu K7Layout, K9Layout) and K10's
    first pass: 256 x 128 tiles shared by both consumers, their stages
    within the 227 KB a block may use with no room for another (Legacy:
    five 32 KB stages and two 32 KB buffers); K7 with half buffers (a
    consumer's 128 rows by 64 columns of bf16, its logits leaving in two
    halves) and K9's four stages; and the producer's setmaxnreg gives back
    what the two consumers take from the 168 registers a thread ptxas gives
    the 384 threads."""
    c, text = _constants("wgmma_gemm.cuh")
    with open(os.path.join(_cuda.CSRC_DIR, "lm_ce.cu")) as f:
        src = f.read()
    names = [re.search(rf"using K{k}Layout = kmb_wg::(\w+);", src).group(1) for k in (7, 9)]
    assert names == ["LogitsCoop", "StatsCoop"]
    # K9 without buffers, K10's first pass with its two 32 KB buffers (a
    # consumer's 128 rows of bf16), K7 with two of 16 KB, all with no room
    # for another stage
    for name, buf_bytes in (("StatsCoop", 0), ("DlogitsCoop", 2 * 32768),
                            ("LogitsCoop", 2 * 16384)):
        stages, stage, smem = _layout_smem(c, text, name)
        assert smem <= SMEM_LIMIT < smem + stage
        assert stage == (lm_ce.COOP_ROWS + lm_ce.TILE_V) * c["BK"] * 2
        assert smem == stages * stage + buf_bytes + 8 * (2 * stages + 4) + 1024
    assert _layout_smem(c, text, "LogitsCoop")[0] == _layout_smem(c, text, "StatsCoop")[0] == 4
    _, _, legacy = _layout_smem(c, text, "Legacy")
    assert legacy == c["SMEM_BYTES"]
    assert 128 * (168 - c["PRODUCER_REGS"]) >= 256 * (c["CONSUMER_REGS"] - 168)
    assert c["THREADS"] == 384 and 168 * c["THREADS"] <= 65536


def test_dh_units_fit_and_their_registers_balance():
    """K10's second pass: a stage of the [128, 32] dlogits slice and W's
    [32, 384] (8 + 24 KB, K8's 4 + 48), DH_NST stages within 227 KB, the
    stages 1024-byte aligned for the swizzled boxes, and setmaxnreg's counts
    balancing exactly at 168 registers a thread, K8's and the dh pass's
    (whose MMA warpgroups take 232: 192 accumulators and a slice's A
    fragments)."""
    c, _ = _constants("lm_ce_bwd.cu")
    assert (c["DH_ROWS"], c["DH_COLS"]) == (lm_ce.DH_ROWS, lm_ce.DH_COLS)
    assert (c["ROWS"], c["SK"], c["GROUP_COLS"]) == (lm_ce.BWD_ROWS, lm_ce.BWD_SLICE,
                                                     lm_ce.BWD_GROUP)
    assert c["DH_A_BYTES"] == 8192 and c["DH_STAGE_BYTES"] == 32768
    assert c["DH_STAGE_BYTES"] < c["STAGE_BYTES"] == 53248
    assert c["DH_STAGE_BYTES"] % 1024 == 0 and c["DH_NST"] >= 6
    assert c["DH_SMEM_BYTES"] <= SMEM_LIMIT
    assert 128 * (c["LAUNCH_REGS"] - c["AUX_REGS"]) == 256 * (c["MMA_REGS"] - c["LAUNCH_REGS"])
    assert (128 * (c["LAUNCH_REGS"] - c["DH_AUX_REGS"])
            == 256 * (c["DH_MMA_REGS"] - c["LAUNCH_REGS"]))


def _tile_rows_first(t, g):
    """K7's tile t as (row tile, column tile), decoded as csrc/wgmma_gemm.cuh
    tile_at does with ROWS_FIRST: rows fastest."""
    return t % g.row_tiles, t // g.row_tiles


def _legacy_tiles(n, v):
    """The 128 x 128 tiles K7 ran on before its cooperative layout, each as
    (first row, rows below n, column tile)."""
    return [(r * ffn.ROW_TILE, min(n, (r + 1) * ffn.ROW_TILE), c)
            for c in range(-(-v // lm_ce.TILE_V)) for r in range(-(-n // ffn.ROW_TILE))]


@pytest.mark.parametrize("sms", [132, 114])
@pytest.mark.parametrize("n,d,v", SHAPES)
def test_k7_coop_tiles_write_what_its_128_row_tiles_wrote(n, d, v, sms):
    """K7 on coop_plan: every 256 x 128 tile is one persistent block's once,
    with whole depth sums (the statistics need them), and its two
    consumers, 128 rows each, write the partials (column index col0 / 128)
    and the logits columns [col0, col0 + 128) of exactly the rows each 128 x
    128 tile of K7's earlier plan wrote: the same [n, col_tiles] partial
    matrix and the same logits blocks, each once."""
    g = lm_ce.coop_plan(n, d, v, sms)
    assert (g.rows, g.cols, g.depth) == (n, v, d)
    assert g.splits == 1 and g.kper == -(-d // ffn.K_TILE)   # whole sums for the statistics
    assert g.col_tiles == -(-v // lm_ce.TILE_V) and lm_ce.TILE_V == ffn.COL_TILE
    tiles = g.row_tiles * g.col_tiles
    assert 1 <= g.ctas <= min(sms, tiles)
    visits = np.zeros(tiles, np.int64)
    for b in range(g.ctas):
        visits[b::g.ctas] += 1
    assert (visits == 1).all()
    written = []
    for t in range(tiles):
        r, c = _tile_rows_first(t, g)
        col0 = c * lm_ce.TILE_V
        assert col0 < v
        for cw in range(2):
            row0 = r * lm_ce.COOP_ROWS + ffn.ROW_TILE * cw
            if row0 < n:
                written.append((row0, min(n, row0 + ffn.ROW_TILE), col0 // lm_ce.TILE_V))
    assert sorted(written) == sorted(_legacy_tiles(n, v))
    assert len(set(written)) == len(written)


@pytest.mark.parametrize("n", [5120, 9216])
def test_k7_tile_order_keeps_a_column_block_together(n):
    """Rows fastest: the row tiles of one column block are consecutive, so a
    wave of the persistent grid spans a few column blocks and each 196 KB W
    slice is read from HBM about once while h stays in L2 (at 50320 / 128 =
    394 column blocks, columns fastest would stream all 77 MB of W once per
    row block)."""
    g = lm_ce.coop_plan(n, 768, 50320, 132)
    order = [_tile_rows_first(t, g) for t in range(g.row_tiles * g.col_tiles)]
    for c in range(g.col_tiles):
        assert order[c * g.row_tiles:(c + 1) * g.row_tiles] == [(r, c) for r in
                                                                range(g.row_tiles)]
    wave = {c for _, c in order[:g.ctas]}
    assert len(wave) <= -(-g.ctas // g.row_tiles) + 1
    assert (g.row_tiles, g.col_tiles, g.ctas) == (n // lm_ce.COOP_ROWS, 394, 132)


def emulate_k7_stats(logits, labels):
    """K7's statistics from the bf16-rounded logits [N, V] (fp32 values), as
    the EPI_STATS epilogue and lm_ce_merge_kernel take them: per 128-column
    tile and row, lane l of the four that share the row owns columns 2l +
    8j + {0, 1}; the tile max, then each lane's exp-sum in j order, joined
    by xor 1 then xor 2; the label logit where the label falls. Then the
    merge: lane L of a warp takes tiles L, L + 32, ... in order, rescales
    each exp-sum to the row max and adds, and a butterfly (warp_sum: xor
    16, 8, 4, 2, 1) joins the lanes.
    Returns (m, se, ll) fp32 [N] and the partials [3, N, tiles]."""
    N, V = logits.shape
    nvt = -(-V // 128)
    padded = np.full((N, nvt * 128), -np.inf, np.float32)
    padded[:, :V] = logits
    tiles = padded.reshape(N, nvt, 16, 4, 2)             # [row, tile, j, lane, pair]
    pm = tiles.max(axis=(2, 3, 4))
    e = np.exp((tiles - pm[:, :, None, None, None]).astype(np.float32)).astype(np.float32)
    lane_se = np.zeros((N, nvt, 4), np.float32)
    for j in range(16):
        for k in range(2):
            lane_se = (lane_se + e[:, :, j, :, k]).astype(np.float32)
    x = (lane_se + lane_se[..., [1, 0, 3, 2]]).astype(np.float32)
    pse = (x[..., 0] + x[..., 2]).astype(np.float32)
    pll = np.zeros((N, nvt), np.float32)
    rows = np.arange(N)
    pll[rows, labels // 128] = logits[rows, labels]
    mx = pm.max(axis=1)
    lanes_se = np.zeros((N, 32), np.float32)
    lanes_ll = np.zeros((N, 32), np.float32)
    for t in range(nvt):
        term = (pse[:, t] * np.exp((pm[:, t] - mx).astype(np.float32))).astype(np.float32)
        lanes_se[:, t % 32] = (lanes_se[:, t % 32] + term).astype(np.float32)
        lanes_ll[:, t % 32] = (lanes_ll[:, t % 32] + pll[:, t]).astype(np.float32)
    return mx, _butterfly(lanes_se), _butterfly(lanes_ll), np.stack([pm, pse, pll])


def test_k7_stats_emulation_matches_pallas_kernel():
    """At a ragged vocab (1100 = 8 x 128 + 76) with labels in column 0, in
    column V - 1 and in the ragged last tile: the emulated partials and
    merge against _fwd_project_stats_call in interpret mode (which carries
    running statistics across its vocab tiles instead). Both take the
    statistics on the bf16 logits, so the max and the label logit agree
    exactly and the exp-sum within the order of the fp32 sums (1e-5
    relative), given the same logits; the projection itself (fp32 sums in
    another order) may differ by the last bf16 bit, so the logits are held
    within 2 bf16 ulps and the statistics are taken from the Pallas
    kernel's logits."""
    rng = np.random.default_rng(11)
    N, V, D = 24, 1100, 128
    h = rng.normal(size=(N, D)).astype(np.float32)
    w = (rng.normal(size=(V, D)) * 0.05).astype(np.float32)
    fbias = (rng.normal(size=(V,)) * 0.01).astype(np.float32)
    labels = rng.integers(0, V, N).astype(np.int32)
    labels[:3] = [0, V - 1, 1030]
    logits_j, m_j, se_j, ll_j = _fwd_project_stats_call(
        to_jax(h, "bfloat16"), to_jax(w, "bfloat16"), jnp.asarray(fbias).reshape(1, -1),
        jnp.asarray(labels).reshape(-1, 1), 128, jnp.bfloat16, True)
    lj = to_np(logits_j)
    # the kernel's projection: bf16(h @ W^T + bias) with fp32 sums
    hb, wb = _bf16(h), _bf16(w)
    mine = _bf16((hb @ wb.T).astype(np.float32) + fbias)
    np.testing.assert_allclose(mine, lj, rtol=0, atol=bf16_tol(lj))
    m, se, ll, parts = emulate_k7_stats(lj, labels)
    np.testing.assert_array_equal(m, to_np(m_j)[:, 0])
    np.testing.assert_array_equal(ll, to_np(ll_j)[:, 0])
    np.testing.assert_allclose(se, to_np(se_j)[:, 0], rtol=1e-5)
    # the ragged last tile's partials cover its 76 columns only
    last = lj[:, 8 * 128:]
    np.testing.assert_array_equal(parts[0][:, -1], last.max(axis=1))
    assert parts[2][1, -1] == lj[1, V - 1] and parts[2][0, 0] == lj[0, 0]
    # against the port's plain version: the same statistics from its logits,
    # and from the emulated projection's within the logits' 2 bf16 ulps
    bf = torch.bfloat16
    plain_logits, pm, pse, pll = lm_ce.lm_ce_fwd_plain(
        to_torch(h, bf), to_torch(w, bf), to_torch(fbias), torch.from_numpy(labels))
    plain_logits = plain_logits.float().numpy()
    m3, se3, ll3, _ = emulate_k7_stats(plain_logits, labels)
    np.testing.assert_array_equal(m3, pm.numpy())
    np.testing.assert_array_equal(ll3, pll.numpy())
    np.testing.assert_allclose(se3, pse.numpy(), rtol=1e-5)
    m2, se2, _, _ = emulate_k7_stats(mine, labels)
    np.testing.assert_allclose(np.log(se2) + m2, np.log(se3) + m3, rtol=0,
                               atol=bf16_tol(plain_logits))


def _head(seed):
    """h, W, bias and labels of a small ragged head (N 24, V 1100 = 8 x 128 +
    76, D 128) with labels in column 0, in column V - 1 and in the ragged
    last tile."""
    rng = np.random.default_rng(seed)
    N, V, D = 24, 1100, 128
    h = rng.normal(size=(N, D)).astype(np.float32)
    w = (rng.normal(size=(V, D)) * 0.05).astype(np.float32)
    fbias = (rng.normal(size=(V,)) * 0.01).astype(np.float32)
    labels = rng.integers(0, V, N).astype(np.int32)
    labels[:3] = [0, V - 1, 1030]
    return h, w, fbias, labels


def _jax_head(h, w, fbias, labels):
    return (to_jax(h, "bfloat16"), to_jax(w, "bfloat16"), jnp.asarray(fbias).reshape(1, -1),
            jnp.asarray(labels).reshape(-1, 1))


def test_k9_stats_emulation_matches_pallas_kernel():
    """K9 is K7's launch without the logits store, so its statistics are
    emulate_k7_stats of the same rounded logits. Held against
    _fwd_stats_call in interpret mode (online statistics over its vocab
    tiles, no logits out) on the logits _fwd_project_stats_call computes
    from the same inputs: the max and the label logit exactly, the exp-sum
    within the order of the fp32 sums (1e-5 relative)."""
    h, w, fbias, labels = _head(12)
    args = _jax_head(h, w, fbias, labels)
    lj = to_np(_fwd_project_stats_call(*args, 128, jnp.bfloat16, True)[0])
    m_j, se_j, ll_j = _fwd_stats_call(*args, 128, jnp.bfloat16, True)
    m, se, ll, _ = emulate_k7_stats(lj, labels)
    np.testing.assert_array_equal(m, to_np(m_j)[:, 0])
    np.testing.assert_array_equal(ll, to_np(ll_j)[:, 0])
    np.testing.assert_allclose(se, to_np(se_j)[:, 0], rtol=1e-5)


def emulate_k10_dlogits(acc, fbias, m, inv_se, scale, labels):
    """K10's first pass as the EPI_DLOGITS epilogue forms it, from the fp32
    sums acc [N, V]: the logits bf16(acc + bias) (bias added to each column
    pair before the rounding, as stats_epilogue does), then dlogit of each
    (csrc/wgmma_gemm.cuh), bf16(scale (exp(logit - m) inv_se - [the label's
    column])) with each product and difference rounded once in fp32, and 0
    past V. Returns the [N, padded_vocab(V)] buffer the TMA store fills, its
    pad columns included, as fp32 values."""
    N, V = acc.shape
    logits = _bf16((acc + fbias[None, :]).astype(np.float32))
    e = np.exp((logits - m[:, None]).astype(np.float32)).astype(np.float32)
    p = (e * inv_se[:, None]).astype(np.float32)
    onehot = (np.arange(V)[None, :] == labels[:, None]).astype(np.float32)
    out = np.zeros((N, lm_ce.padded_vocab(V)), np.float32)
    out[:, :V] = _bf16((scale[:, None] * (p - onehot).astype(np.float32)).astype(np.float32))
    return out


def test_k10_dlogits_emulation_matches_pallas_kernel():
    """At a ragged vocab with labels in column 0, in column V - 1 and in the
    ragged last tile, and with rows whose scale is 0 (ignored labels): the
    emulated epilogue against _recompute_bwd_call in interpret mode and
    against the port's plain version. The projections sum in other orders,
    so the emulation's logits are held within 2 bf16 ulps of the Pallas
    kernel's and of the plain version's; given the same logits, the
    dlogits agree exactly, and the buffer's pad columns are zero."""
    h, w, fbias, labels = _head(13)
    N, V = labels.shape[0], w.shape[0]
    args = _jax_head(h, w, fbias, labels)
    lj, m_j, se_j, _ = _fwd_project_stats_call(*args, 128, jnp.bfloat16, True)
    lj = to_np(lj)
    m = np.array(to_np(m_j)[:, 0])
    inv_se = (1.0 / to_np(se_j)[:, 0]).astype(np.float32)
    valid = np.ones(N, bool)
    valid[[1, 5, 6]] = False   # the label in column V - 1 among them
    scale = (valid / valid.sum()).astype(np.float32)
    col = lambda a: jnp.asarray(a).reshape(N, 1)  # noqa: E731
    dl_j, _ = _recompute_bwd_call(args[0], args[1], args[2], col(m), col(inv_se), col(scale),
                                  args[3], 128, jnp.bfloat16, True)
    dl_j = to_np(dl_j)
    zero = np.zeros(V, np.float32)
    # the epilogue on the Pallas kernel's logits: the same dlogits, bit for bit
    mine = emulate_k10_dlogits(lj, zero, m, inv_se, scale, labels)
    np.testing.assert_array_equal(mine[:, :V], dl_j)
    assert mine.shape == (N, 1104) and not mine[:, V:].any()
    assert not mine[~valid].any() and dl_j[0, 0] < 0 and dl_j[2, 1030] < 0
    # the epilogue on its own fp32 sums: logits within 2 bf16 ulps
    hb, wb = _bf16(h), _bf16(w)
    acc = (hb @ wb.T).astype(np.float32)
    own = emulate_k10_dlogits(acc, fbias, m, inv_se, scale, labels)
    np.testing.assert_allclose(_bf16(acc + fbias), lj, rtol=0, atol=bf16_tol(lj))
    np.testing.assert_allclose(own, mine, rtol=0, atol=bf16_tol(mine))
    # the port's plain version: its logits within 2 bf16 ulps, and its
    # dlogits those of the epilogue on its logits
    bf = torch.bfloat16
    th, tw, tb = to_torch(h, bf), to_torch(w, bf), to_torch(fbias)
    tl = torch.from_numpy(labels)
    plain_logits = lm_ce.lm_ce_fwd_plain(th, tw, tb, tl)[0].float().numpy()
    np.testing.assert_allclose(plain_logits, lj, rtol=0, atol=bf16_tol(lj))
    dl_p, _ = lm_ce.lm_ce_recompute_bwd_plain(th, tw, tb, torch.from_numpy(m),
                                              torch.from_numpy(inv_se),
                                              torch.from_numpy(scale), tl)
    on_plain = emulate_k10_dlogits(plain_logits, zero, m, inv_se, scale, labels)
    np.testing.assert_array_equal(on_plain[:, :V], dl_p.float().numpy())
