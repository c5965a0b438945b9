"""The control and the faults come out not correct under each cell's own
limits and the run's own comparison, while the system comes out correct:
at a tiny size on the CPU, and at the cell's size on the card."""

import contextlib
import io
import json
import subprocess
import sys

import pytest
import torch

from conftest import ROOT, SEED, TINY, tiny_mix
from gpubench import control
from test_gpubench_faults import FINETUNE, GEN, GEN_TINY, PRETRAIN

CELLS = [GEN, FINETUNE, PRETRAIN]


def _sides(line):
    return {k: v for k, v in line.items() if isinstance(v, dict)}


@pytest.mark.parametrize("cell", CELLS)
def test_control_and_faults_fail_where_the_system_passes(cell):
    with contextlib.redirect_stdout(io.StringIO()):
        (line,) = control.main(["--workload", cell, "--seeds", str(SEED), "--units", "1",
                                "--faults", "1"], device=torch.device("cpu"),
                               cfg_override=GEN_TINY if cell == GEN else TINY,
                               mix_override=tiny_mix(cell))
    sides = _sides(line)
    want = {"system", "control"} | (set(control.FAULTS["generate"]) if cell == GEN
                                     else {"half_batch"})
    assert set(sides) == want
    assert sides.pop("system")["correct"] is True
    assert all(side["correct"] is False for side in sides.values()), sides


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_at_the_cells_size_on_the_card(cell, card):
    seeds = ",".join(str(SEED + i) for i in range(3))
    proc = subprocess.run([sys.executable, "gpubench/control.py", "--workload", cell,
                           "--seeds", seeds], cwd=ROOT, capture_output=True, text=True,
                          timeout=3000)
    assert proc.returncode == 0, proc.stderr[-2000:]
    lines = [json.loads(x) for x in proc.stdout.strip().splitlines()]
    assert len(lines) == 3
    for line in lines:
        sides = _sides(line)
        assert sides.pop("system")["correct"] is True
        assert all(side["correct"] is False for side in sides.values()), sides
