"""K1 and K1b: the route plan (kmbart_tpu_torch/ops/train_attention.py plan)
and the persistent schedule of the "wg" kernels, on the CPU.

csrc/train_attention_wg.cu and train_attention_wg_bwd.cu take bf16 at
head_dim 64 and lengths up to 128; each block walks the (b, h) pairs
blockIdx.x, + gridDim.x, ... and carves its shared memory as
train_attention_wg.cuh geometry does, which the plan mirrors (the launch
refuses a plan whose bytes differ from its own). These tests hold the plan
to the routes PERF.md gives, to the card's shared memory, the schedule to
covering every pair once, and the mirror's constants to the source. The
kernels run only on the card (chip_smoke.py holds both routes to the plain
versions and to each other there).
"""

import re
from pathlib import Path

import pytest
import torch

import chip_smoke
from kmbart_tpu_torch.ops import train_attention as ta

CSRC = Path(ta.__file__).resolve().parents[1] / "csrc"
BF16 = torch.bfloat16
MAIN_PATH = [row for row in chip_smoke.K1_SHAPES if row[-1]]  # the timed rows


def _plan(row, backward):
    B, Tq, Tk, D, H, pad, causal, fused, timed = row
    return ta.plan(Tq, Tk, D // H, BF16, causal, backward=backward)


def _smem_resident(p):
    # blocks an SM holds by shared memory (228 KB, 1 KB more reserved a
    # block) and threads (2048); registers may bind first on the card
    return min(233472 // (p.smem_bytes + 1024), 2048 // (128 * p.consumers + 32))


def _schedule(pairs, blocks):
    # the kernels' loops: block x walks x, x + blocks, ...
    return [list(range(x, pairs, blocks)) for x in range(blocks)]


@pytest.mark.parametrize("row", MAIN_PATH, ids=lambda r: "x".join(map(str, r[:5])) +
                         ("c" if r[6] else ""))
def test_main_path_shapes_take_the_wg_kernels(row):
    # PERF.md section 6: every main-path shape (G, F, P, T, G-TP) on "wg"
    for backward in (False, True):
        p = _plan(row, backward)
        assert p.kernel == "wg"
        assert p.stages == ta.STAGES >= 2
        assert p.consumers == (2 if backward and max(row[1], row[2]) > 64 else 1)


def test_main_path_shapes_cover_every_callers_shape():
    # G 72², F 72² / causal 40² / 40x72, P 96² / causal 72² / 72x96, a TP 2
    # rank's six heads (T, G-TP)
    got = {(Tq, Tk, causal, D // H) for B, Tq, Tk, D, H, pad, causal, fused, t in MAIN_PATH}
    assert got == {(72, 72, False, 64), (40, 40, True, 64), (40, 72, False, 64),
                   (96, 96, False, 64), (72, 72, True, 64), (72, 96, False, 64)}
    assert {row[3] // row[4] for row in MAIN_PATH} == {64}
    assert {row[4] for row in MAIN_PATH} == {12, 6}


def _legacy_smem(Tq, Tk, hd, backward):
    # train_attention_tc.cuh fwd_tc_smem_bytes / bwd_tc_smem_bytes (bf16)
    ld = ta._round(hd, 16) + 8
    tqp, tkp = ta._round(Tq, 16), ta._round(Tk, 16)
    if not backward:
        return 2 * ld * (tqp + 2 * tkp) + 4 * tkp
    warps = min(ta._round(max(Tq, Tk), 16) // 16, 8)
    return 2 * ld * (2 * tqp + 2 * tkp + 16 * warps) + 4 * (4 * tqp + tkp)


@pytest.mark.parametrize("backward", [False, True])
def test_shared_memory_of_every_length_fits(backward):
    # every bf16 head_dim-64 shape K1 takes (<= 256 tokens), causal ones
    # square, in the 232,448 bytes a block may use
    for Tq in range(1, ta.MAX_LEN + 1):
        for Tk in range(1, ta.MAX_LEN + 1):
            p = ta.plan(Tq, Tk, 64, BF16, False, backward=backward)
            if p.kernel == "wg":
                assert p.smem_bytes <= ta.SMEM_MAX, (Tq, Tk)
                assert _smem_resident(p) >= 1
            else:
                assert max(Tq, Tk) > ta.WG_MAX_LEN
                assert _legacy_smem(Tq, Tk, 64, backward) <= ta.SMEM_MAX
        assert ta.plan(Tq, Tq, 64, BF16, True, backward=backward).kernel == (
            "wg" if Tq <= ta.WG_MAX_LEN else "legacy")


def test_blocks_an_sm_holds_at_the_main_path_shapes():
    # the forward leaves three blocks on an SM at every main-path shape but
    # the causal 40² (more), the backward one (two at 40²)
    fwd = {(r[1], r[2]): _smem_resident(_plan(r, False)) for r in MAIN_PATH}
    bwd = {(r[1], r[2]): _smem_resident(_plan(r, True)) for r in MAIN_PATH}
    assert all(n >= 3 for n in fwd.values()), fwd
    assert bwd[40, 40] == 2 and all(n == 1 for k, n in bwd.items() if k != (40, 40)), bwd


@pytest.mark.parametrize("pairs,sms,resident", [
    (1536, 132, 3), (1536, 132, 1), (768, 132, 3), (384, 132, 2), (192, 132, 1),
    (100, 132, 3), (7, 132, 2), (1, 132, 1), (1536, 114, 2), (12, 16, 1)])
def test_schedule_visits_each_pair_once(pairs, sms, resident):
    blocks = ta.grid(pairs, sms, resident)
    assert blocks == min(pairs, sms * resident)
    walks = _schedule(pairs, blocks)
    assert len(walks) == blocks and all(walks)       # no block without a pair
    seen = sorted(pr for walk in walks for pr in walk)
    assert seen == list(range(pairs))                # each pair exactly once
    assert all(walk == sorted(walk) for walk in walks)
    waves = max(len(walk) for walk in walks)
    assert waves == -(-pairs // blocks) and min(len(w) for w in walks) >= waves - 1


def test_kernels_walk_the_planned_schedule():
    # the producer and the consumers of both kernels loop as _schedule does
    src = (CSRC / "train_attention_wg.cuh").read_text()
    loop = "for (int pr = blockIdx.x; pr < a.pairs; pr += gridDim.x, ++n)"
    assert src.count(loop) == 3                       # producer, forward, backward
    assert "b = pr / a.H, c = (pr % a.H) * kHd" in src


@pytest.mark.parametrize("case", [
    dict(dtype=torch.float32), dict(head_dim=128), dict(head_dim=32), dict(head_dim=72),
    dict(Tq=129), dict(Tk=256), dict(Tq=40, Tk=72, causal=True)])
def test_other_shapes_keep_pr4s_kernels(case):
    kw = dict(Tq=72, Tk=72, head_dim=64, dtype=BF16, causal=False)
    kw.update(case)
    for backward in (False, True):
        assert ta.plan(kw["Tq"], kw["Tk"], kw["head_dim"], kw["dtype"], kw["causal"],
                       backward=backward).kernel == "legacy"
        with pytest.raises(ValueError):
            ta.plan(kw["Tq"], kw["Tk"], kw["head_dim"], kw["dtype"], kw["causal"],
                    backward=backward, kernel="wg")


def test_plan_can_force_pr4s_kernel():
    assert ta.plan(96, 96, 64, BF16, False, kernel="legacy").kernel == "legacy"
    with pytest.raises(ValueError):
        ta.plan(96, 96, 64, BF16, False, kernel="mma")


def test_geometry_mirror_matches_the_source():
    src = (CSRC / "train_attention_wg.cuh").read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))

    assert const("kHd") == ta.WG_HEAD_DIM
    assert const("kMaxLen") == ta.WG_MAX_LEN
    assert const("kStages") == ta.STAGES
    assert const("kSmemMax") == ta.SMEM_MAX
    # spot values of the carve-up (bytes), worked by hand from the source
    assert ta._geometry(72, 72, False) == (2 * 30720 + 1024 + 32 + 1024, 1)
    assert ta._geometry(96, 96, False) == (2 * 36864 + 1024 + 32 + 1024, 1)
    assert ta._geometry(8, 16, False) == (2 * 8192 + 1024 + 32 + 1024, 1)
    assert ta._geometry(40, 40, True) == (2 * 28672 + 1024 + 2 * 8192 + 8192 + 32 + 1024, 1)
    assert ta._geometry(96, 96, True) == (2 * 57344 + 1024 + 4 * 16384 + 2 * 8192 + 32
                                          + 1024, 2)
