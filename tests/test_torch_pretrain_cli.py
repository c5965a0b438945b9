"""PyTorch port, the ``pretrain`` twin on the CPU: one epoch of multi-task
pretraining on the fixture's coco, vg, vcg and reason datasets with a
mid-epoch checkpoint and TensorBoard logs, a resume with
``--continue_training`` to ``model1/``, all in a fresh interpreter that
never imports jax; its checkpoints load in the JAX package as a pretraining
TrainState and in the port's fine-tune model."""

import json
import os
import subprocess
import sys

import pytest
import torch

from kmbart_tpu.checkpoint.io import load_pretrained as jax_load_pretrained
from kmbart_tpu.checkpoint.io import load_training_data as jax_load_training_data
from kmbart_tpu.models.pretraining import init_pretraining_params
from kmbart_tpu.training.state import TrainState as JaxTrainState
from kmbart_tpu_torch import pretrain
from kmbart_tpu_torch.checkpoint.io import load_pretrained

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    from tests.fixtures.make_dataset import make_dataset
    d = str(tmp_path_factory.mktemp("torchpretrain"))
    make_dataset(d)
    return d


def _args(data, ckpt_dir, *extra):
    return ["--dataset", "coco_train", os.path.join(data, "coco"),
            "--dataset", "vg_train", os.path.join(data, "vg"),
            "--dataset", "vcg_train", os.path.join(data, "vcg"),
            "--dataset", "coco_reason_train", os.path.join(data, "reason"),
            "--checkpoint_dir", ckpt_dir, "--tokenizer_dir", os.path.join(data, "tokenizer"),
            "--batch_size", "8", "--max_img_num", "4", "--lr", "1e-3", "--device", "cpu",
            *extra]


def test_pretrain_twin_trains_resumes_and_loads_in_jax(data, tmp_path):
    ckpt1, ckpt2, logs = (str(tmp_path / n) for n in ("ckpt1", "ckpt2", "logs"))
    first = _args(data, ckpt1, "--model_config", os.path.join(data, "config.json"),
                  "--epochs", "1", "--save_every_steps", "3", "--log_dir", logs)
    code = (
        "import json, os, sys\n"
        "from kmbart_tpu_torch import pretrain\n"
        f"run1 = pretrain.main(pretrain.parse_args({first!r}))\n"
        "model0 = os.path.join(run1, 'model0')\n"
        f"resume = {_args(data, ckpt2, '--epochs', '2', '--continue_training')!r}\n"
        "run2 = pretrain.main(pretrain.parse_args(resume + ['--checkpoint', model0]))\n"
        "assert 'jax' not in sys.modules, 'jax was imported'\n"
        "print(json.dumps({'run1': run1, 'run2': run2}))\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    runs = json.loads(proc.stdout.strip().splitlines()[-1])
    model0 = os.path.join(runs["run1"], "model0")
    model1 = os.path.join(runs["run2"], "model1")
    assert not os.path.exists(os.path.join(runs["run2"], "model0"))   # resumed at epoch 1
    assert [n for n in os.listdir(runs["run1"]) if n.startswith("step")]
    with open(os.path.join(logs, os.listdir(logs)[0], "log.txt")) as f:
        log = f.read()
    assert "Generated:" in log and "Labels:" in log          # the step-0 sample decode

    # both checkpoints load strictly in the JAX package as a pretraining TrainState
    for path, epoch in ((model0, 0), (model1, 1)):
        _, params, _ = jax_load_pretrained(path, init_pretraining_params)
        assert set(params) == {"model", "final_logits_bias", "mrm_head", "attribute_head",
                               "relation_head"}
        td = jax_load_training_data(path, JaxTrainState.create(params).opt_state)
        assert td["epoch"] == epoch and td["step"] > 0
        assert int(td["opt_state"].step) == td["step"]
    # and model0 starts a fine-tune run in the port, its heads dropped
    _, model, report = load_pretrained(model0, device="cpu")
    assert report == ["unused checkpoint keys: 12"]
    assert not hasattr(model, "mrm_head")
    assert all(torch.isfinite(t).all() for t in model.state_dict().values())


def test_pretrain_twin_flags(data, tmp_path, monkeypatch):
    base = _args(data, str(tmp_path), "--model_config", os.path.join(data, "config.json"))
    args = pretrain.parse_args(base)
    assert (args.mrm_enabled, args.ap_enabled, args.rp_enabled) == (True, True, True)
    assert (args.lm_max_len, args.max_img_num) == (30, 4)
    assert set(args.dataset) == {"coco_train", "vg_train", "vcg_train", "coco_reason_train"}
    with pytest.raises(ValueError, match="not a valid dataset"):
        pretrain.parse_args(base + ["--dataset", "bogus_name", "x"])
    with pytest.raises(ValueError, match="repeated"):
        pretrain.parse_args(base + ["--dataset", "coco_train", "x"])
    with pytest.raises(ValueError, match="--no_image"):
        pretrain.parse_args(base + ["--no_image"])
    # the tensor, sequence and pipeline parallelism flags are taken, and the
    # grid refuses what the JAX CLI's mesh refuses
    from kmbart_tpu_torch.cli_common import make_grid_from_args
    monkeypatch.setenv("KMBART_NO_FUSED_FFN", "")
    monkeypatch.delenv("KMBART_NO_FUSED_FFN")
    for flag in (["--model_parallel", "2"], ["--sequence_parallel"], ["--pipeline_stages", "2"]):
        pretrain.parse_args(base + flag)
    with pytest.raises(ValueError, match="cannot be combined with --sequence_parallel"):
        make_grid_from_args(pretrain.parse_args(base + ["--pipeline_stages", "2",
                                                        "--sequence_parallel", "--multihost"]))
    assert pretrain.parse_args(base + ["--multihost", "--zero1", "--sharded_checkpoints"]).zero1
    assert pretrain.parse_args(base + ["--device", "cuda", "--cpu"]).device == "cpu"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            pretrain.main(pretrain.parse_args(
                [a if a != "cpu" else "cuda" for a in base]))
