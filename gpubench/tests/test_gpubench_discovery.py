"""The harness finds a configuration, a traffic mix, a cell and a metric that
are added as new files, in a copy of the checkout, with no file edited."""

import contextlib
import io
import json
import os
import shutil

import torch

from conftest import ROOT, SEED, TINY
from gpubench.harness import runner


def _write(path, obj):
    with open(path, "w") as f:
        json.dump(obj, f)


def test_added_files_run_without_an_edit(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(os.path.join(ROOT, "gpubench"), root / "gpubench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        manifest = json.load(f)
    bench = root / "gpubench"
    with open(bench / "configs" / "kmbart-base-vcg.json") as f:
        cfg = dict(json.load(f), **TINY)
    _write(bench / "configs" / "kmbart-tiny.json", cfg)
    _write(bench / "traffic" / "beam-tiny.json",
           {"loop": "generate", "batch": 3, "enc_len": 12, "real_len": [8, 12],
            "image_slots": 4, "generate": {"num_beams": 2, "max_length": 5,
                                           "early_stopping": False, "do_sample": False},
            "pool": 2, "check_rows": 4, "traced_units": 1})
    _write(bench / "workloads" / "tiny-beam.json",
           {"config": "kmbart-tiny", "traffic": "beam-tiny", "env": {},
            "limits": {"score_gap": 1.0, "served_token_gap": 1.0}})
    (bench / "metrics" / "calls_done.py").write_text(
        "def read(run):\n    return float(run.window['units'])\n")
    manifest["configs"].append({"name": "kmbart-tiny", "source": cfg["source"],
                                "file": "gpubench/configs/kmbart-tiny.json", "reduced": [],
                                "why": "a test"})
    manifest["workloads"].append({"name": "tiny-beam", "config": "kmbart-tiny",
                                  "traffic": "beam-tiny", "chips": 1, "why": "a test"})
    manifest["end_to_end"].append({"name": "calls_done", "unit": "calls", "better": "higher",
                                   "bound": 0.05, "source": "host_clock",
                                   "workloads": ["tiny-beam"]})
    _write(root / "BENCHMARK.json", manifest)

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = runner.main(["--workload", "tiny-beam", "--seed", str(SEED), "--seconds", "0.5",
                          "--trace", "0"], root=str(root), device=torch.device("cpu"))
    assert rc == 0
    result = json.loads(out.getvalue().strip().splitlines()[-1])
    assert result["correct"] is True
    assert set(result["metrics"]) == {"setup_s", "calls_done"}
    assert result["metrics"]["calls_done"]["value"] >= 1
    assert list(result)[-1] == "checks"
