"""The check catches a broken timed path: each cell's whole run (past the
look for a card) at a tiny size on the CPU, with the cell's own limits,
comes out correct as it stands and not correct with each fault the cell
can have planted underneath."""

import contextlib
import io
import json

import pytest
import torch

from conftest import ROOT, SEED, TINY, tiny_mix
from gpubench import control
from gpubench.harness import runner

GEN, FINETUNE, PRETRAIN = "vcg-gen-beam5-b2048", "vcg-finetune-b1024", "pretrain-nomat-b768"
# generation draws its tiny weights at the logit scale of the full size
# (0.1 * sqrt(32) ~ 0.02 * sqrt(768)): at these widths a layer drawn at 0.02
# barely moves the residual stream, so a decode step that skipped its layers
# would serve nearly the same tokens with nearly the same scores
GEN_TINY = dict(TINY, init_std=0.1)


def _run(cell):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = runner.main(["--workload", cell, "--seed", str(SEED), "--seconds", "0.3",
                          "--trace", "0"], root=ROOT, device=torch.device("cpu"),
                         cfg_override=GEN_TINY if cell == GEN else TINY,
                         mix_override=tiny_mix(cell))
    assert rc == 0
    return json.loads(out.getvalue().strip().splitlines()[-1])


@pytest.mark.parametrize("cell", [GEN, FINETUNE, PRETRAIN])
def test_sound_run_is_correct(cell):
    assert _run(cell)["correct"] is True


def _token_altered(mp):
    control.token_altered(mp.setattr, GEN_TINY)


def _decode_step_unchanged(mp):
    control.decode_step_unchanged(mp.setattr, GEN_TINY)


def _state_unchanged(mp):
    from kmbart_tpu_torch.training.adamw import AdamW
    mp.setattr(AdamW, "update", lambda self, grads, state, params, **k: state)


def _half_batch(mp):
    from kmbart_tpu_torch.models import conditional, pretraining
    for mod, name in ((conditional, "conditional_loss"), (pretraining, "pretraining_loss")):
        orig = getattr(mod, name)

        def half(model, cfg, batch, *a, _orig=orig, **k):
            rows = batch["input_ids"].shape[0] // 2
            return _orig(model, cfg, {key: v[:rows] for key, v in batch.items()}, *a, **k)
        mp.setattr(mod, name, half)


@pytest.mark.parametrize("cell,fault", [
    (GEN, _token_altered), (GEN, _decode_step_unchanged),
    (FINETUNE, _state_unchanged), (FINETUNE, _half_batch),
    (PRETRAIN, _state_unchanged), (PRETRAIN, _half_batch)],
    ids=["gen-token-altered", "gen-step-unchanged", "finetune-state-unchanged",
         "finetune-half-batch", "pretrain-state-unchanged", "pretrain-half-batch"])
def test_fault_is_caught(cell, fault, monkeypatch):
    fault(monkeypatch)
    assert _run(cell)["correct"] is False


@pytest.mark.card
def test_a_cell_runs_correct_on_the_card(card):
    import subprocess
    import sys
    proc = subprocess.run([sys.executable, "gpubench/run.py", "--workload", GEN, "--seed",
                           str(SEED), "--seconds", "5", "--trace", "0"], cwd=ROOT,
                          capture_output=True, text=True, timeout=1200)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert json.loads(proc.stdout.strip().splitlines()[-1])["correct"] is True
