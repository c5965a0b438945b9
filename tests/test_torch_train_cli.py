"""PyTorch port, the ``vcg_train`` twin on the CPU: one epoch on the fixture
dataset with validation, ``model0/`` in the JAX package's format, a resume
with ``--continue_training`` to ``model1/``, and the ``vcg_generate`` twin
decoding from it, all in a fresh interpreter that never imports jax."""

import json
import os
import subprocess
import sys

import pytest
import torch

from kmbart_tpu.checkpoint.io import load_pretrained, load_training_data
from kmbart_tpu.models.conditional import init_conditional_params
from kmbart_tpu.training.state import TrainState

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    from tests.fixtures.make_dataset import make_dataset
    d = str(tmp_path_factory.mktemp("torchtrain"))
    make_dataset(d)
    return d


def _train_args(data, ckpt_dir, *extra):
    return ["--data_dir", os.path.join(data, "vcg"), "--checkpoint_dir", ckpt_dir,
            "--tokenizer_dir", os.path.join(data, "tokenizer"), "--batch_size", "4",
            "--max_length", "8", "--device", "cpu", *extra]


def test_vcg_train_twin_trains_resumes_and_generates(data, tmp_path):
    ckpt1, ckpt2, logs = (str(tmp_path / n) for n in ("ckpt1", "ckpt2", "logs"))
    gen_out = str(tmp_path / "gen.json")
    first = _train_args(data, ckpt1, "--model_config", os.path.join(data, "config.json"),
                        "--epochs", "1", "--validate_loss", "--validate_score",
                        "--save_every_steps", "2", "--log_dir", logs)
    code = (
        "import json, os, sys\n"
        "from kmbart_tpu_torch import vcg_generate, vcg_train\n"
        f"run1 = vcg_train.main(vcg_train.parse_args({first!r}))\n"
        "model0 = os.path.join(run1, 'model0')\n"
        f"resume = {_train_args(data, ckpt2, '--epochs', '2', '--continue_training')!r}\n"
        "run2 = vcg_train.main(vcg_train.parse_args(resume + ['--checkpoint', model0]))\n"
        "model1 = os.path.join(run2, 'model1')\n"
        f"gen = {['--data_dir', os.path.join(data, 'vcg'), '--output_file', gen_out, '--tokenizer_dir', os.path.join(data, 'tokenizer'), '--num_beams', '2', '--batch_size', '6', '--max_length', '10', '--device', 'cpu']!r}\n"
        "vcg_generate.main(vcg_generate.parse_args(gen + ['--checkpoint', model1]))\n"
        "assert 'jax' not in sys.modules, 'jax was imported'\n"
        "print(json.dumps({'run1': run1, 'run2': run2}))\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    runs = json.loads(proc.stdout.strip().splitlines()[-1])
    model0 = os.path.join(runs["run1"], "model0")
    model1 = os.path.join(runs["run2"], "model1")
    assert not os.path.exists(os.path.join(runs["run2"], "model0"))   # resumed at epoch 1
    steps = [n for n in os.listdir(runs["run1"]) if n.startswith("step")]
    assert steps, "no --save_every_steps checkpoint"
    with open(os.path.join(logs, os.listdir(logs)[0], "log.txt")) as f:
        log = f.read()
    assert "Val loss" in log and "CIDEr" in log

    # both checkpoints load in the JAX package as a TrainState
    for path, epoch in ((model0, 0), (model1, 1)):
        _, params, _ = load_pretrained(path, init_conditional_params)
        td = load_training_data(path, TrainState.create(params).opt_state)
        assert td["epoch"] == epoch and td["step"] > 0
        assert int(td["opt_state"].step) == td["step"]
    with open(gen_out) as f:
        gen = json.load(f)
    assert len(gen) == 18 and all(len(g["generations"]) == 1 for g in gen)


def test_train_twin_device_and_flags(data, tmp_path, monkeypatch):
    from kmbart_tpu_torch import vcg_train
    base = _train_args(data, str(tmp_path), "--model_config",
                       os.path.join(data, "config.json"))
    base[base.index("cpu")] = "cuda"
    args = vcg_train.parse_args(base)
    assert args.device == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            vcg_train.main(args)
    # the tensor, sequence and pipeline parallelism flags are taken, and the
    # grid refuses what the JAX CLI's mesh refuses (and a split model
    # without --multihost: one process a device)
    from kmbart_tpu_torch.cli_common import make_grid_from_args
    monkeypatch.setenv("KMBART_NO_FUSED_FFN", "")
    monkeypatch.delenv("KMBART_NO_FUSED_FFN")
    for flag in (["--model_parallel", "2"], ["--sequence_parallel"], ["--pipeline_stages", "2"],
                 ["--pipeline_microbatches", "4"], ["--pipeline_span_processes"]):
        vcg_train.parse_args(base + flag)
    with pytest.raises(ValueError, match="cannot be combined with --sequence_parallel"):
        make_grid_from_args(vcg_train.parse_args(base + ["--pipeline_stages", "2",
                                                         "--sequence_parallel", "--multihost"]))
    with pytest.raises(ValueError, match="need --multihost"):
        make_grid_from_args(vcg_train.parse_args(base + ["--model_parallel", "2"]))
    args = vcg_train.parse_args(base + ["--multihost", "--zero1", "--sharded_checkpoints",
                                        "--model_parallel", "1"])
    assert args.multihost and args.zero1 and args.sharded_checkpoints
    with pytest.raises(ValueError, match="divisible"):
        vcg_train.main(vcg_train.parse_args(
            [a if a != "cuda" else "cpu" for a in base] + ["--grad_accum_steps", "3"]))
