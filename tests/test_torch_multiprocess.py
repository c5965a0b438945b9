"""PyTorch port, multi-process data parallelism on the CPU: two gloo ranks,
each a process of its own, against one process on their rows side by side.

- The data-parallel step (tests/_torch_dp_workers.py): the ranks hold
  unequal numbers of labels, and their summed gradients equal the one
  process's at fp32 (atol 1e-5), where DDP's average of per-rank means
  would not; under two accumulation micro-batches the one process groups
  the rows as the ranks do (the difference from the JAX package's grouping,
  ROADMAP.md). ZeRO-1 after three AdamW steps is bit-equal to the
  replicated run, its moments shard on the axes the JAX package picks, and
  its state saved sharded by the two ranks loads into this process, equals
  the npz of the same state and decodes.
- The ``vcg_train`` twin with ``--multihost``, the counterpart of
  tests/test_multiprocess.py:113: per-process batch 4 on two ranks against
  batch 8 in one process, train and validation losses within rtol and atol
  2e-3, rank 1 silent, rank 0 writing ``params.npz``; then a resume under
  ``--multihost --zero1 --sharded_checkpoints`` that runs epoch 2.
- The ``pretrain`` twin at two ranks with ZeRO-1 and sharded checkpoints;
  it accepts the tensor, sequence and pipeline parallelism flags and
  refuses the combinations the JAX CLIs refuse (tests/test_torch_tp.py,
  test_torch_sp.py and test_torch_pp.py run them).
"""

import os
import re
import socket
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from kmbart_tpu.config import tiny_config as jax_tiny_config
from kmbart_tpu.models.conditional import init_conditional_params
from kmbart_tpu.models.pretraining import init_pretraining_params
from kmbart_tpu.parallel.tp import param_partition_specs, zero1_moment_specs
from kmbart_tpu_torch.checkpoint.io import _flatten, load_pretrained, load_training_data
from kmbart_tpu_torch.checkpoint.sharded import load_params_into, load_sharded
from kmbart_tpu_torch.config import tiny_config
from kmbart_tpu_torch.generation.api import generate
from kmbart_tpu_torch.models.conditional import init_conditional_model
from kmbart_tpu_torch.models.pretraining import init_pretraining_model
from kmbart_tpu_torch.parallel.zero1 import leaf_axes
from kmbart_tpu_torch.training.state import model_tensors
from tests._torch_dp_workers import make_batch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TRAIN_LOSS_RE = re.compile(r"Epoch \[\d+/\d+\], Step \[\d+/\d+\], Loss: ([0-9.eE+-]+)")
VAL_LOSS_RE = re.compile(r"Val loss: ([0-9.eE+-]+)")


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _run(argv, nprocs, timeout=300):
    """``python argv`` as ``nprocs`` ranks (one process: no rendezvous);
    returns each rank's output."""
    port = _free_port()
    procs = []
    for r in range(nprocs):
        env = dict(os.environ, OMP_NUM_THREADS="2")
        for k in ("KMBART_COORDINATOR_ADDRESS", "KMBART_NUM_PROCESSES", "KMBART_PROCESS_ID",
                  "MASTER_ADDR"):
            env.pop(k, None)
        if nprocs > 1:
            env.update(KMBART_COORDINATOR_ADDRESS=f"127.0.0.1:{port}",
                       KMBART_NUM_PROCESSES=str(nprocs), KMBART_PROCESS_ID=str(r))
        procs.append(subprocess.Popen([sys.executable] + argv, cwd=REPO, env=env, text=True,
                                      stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
    outs = [None] * nprocs
    try:
        for r, p in enumerate(procs):
            outs[r], _ = p.communicate(timeout=timeout)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, p in enumerate(procs):
        assert p.returncode == 0, f"rank {r} exited {p.returncode}:\n{outs[r][-4000:]}"
    return outs


@pytest.fixture(scope="module")
def step_runs(tmp_path_factory):
    """The worker at two ranks and in one process."""
    runs = {}
    for world in (2, 1):
        out = tmp_path_factory.mktemp(f"dp{world}")
        _run(["-m", "tests._torch_dp_workers", str(out)], world)
        runs[world] = (out, [torch.load(out / f"rank{r}.pt") for r in range(world)])
    return runs


def test_dp_gradients_equal_one_process_with_unequal_label_counts(step_runs):
    (_, two), (_, one) = step_runs[2], step_runs[1]
    labels = make_batch(tiny_config())["labels"]
    counts = [(labels[4 * r:4 * r + 4] != -100).sum().item() for r in (0, 1)]
    assert counts[0] > 3 * counts[1]
    for key in ("grads", "grads_accum"):
        want = one[0][key]
        for rank in (0, 1):
            got = two[rank][key]
            # the ranks sum a gradient that no rank has as zeros
            assert set(got) >= set(want)
            assert all(not got[n].any() for n in set(got) - set(want))
            for n in want:
                torch.testing.assert_close(got[n], want[n], rtol=0, atol=1e-5, msg=n)
        torch.testing.assert_close(two[0][key + "_loss"], one[0][key + "_loss"], rtol=1e-6,
                                   atol=0)
    # the JAX package's grouping of the global rows into micro-batches gives
    # another gradient when the micro-batches hold unequal label counts
    jax_grouping = one[0]["grads_accum_contiguous"]["model.shared.weight"]
    assert (jax_grouping - one[0]["grads_accum"]["model.shared.weight"]).abs().max() > 1e-3


def test_nonfinite_guard_is_global(step_runs):
    """NaN features on rank 1 alone: both ranks skip the update."""
    for rank in (0, 1):
        out = step_runs[2][1][rank]
        assert out["skipped"] == 1.0 and out["unchanged_after_skip"], rank


def test_zero1_is_bit_equal_to_replicated(step_runs):
    _, two = step_runs[2]
    for rank in (0, 1):
        rep, z1 = two[rank]["replicated"], two[rank]["zero1"]
        for n in rep:
            assert torch.equal(rep[n], z1[n]), n
    init = model_tensors(init_conditional_model(tiny_config(), seed=0, device="cpu"))
    assert not torch.equal(two[0]["zero1"]["model.shared.weight"], init["model.shared.weight"])
    for n in two[0]["zero1"]:
        assert torch.equal(two[0]["zero1"][n], two[1]["zero1"][n]), n


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("heads", [False, True])
def test_zero1_shard_axes_match_jax(heads, world):
    """At 2 ranks the tiny model's leaves shard on axis 0 (the layer axis
    where they have one); at 4 the two layers do not divide, and the widths
    do."""
    jcfg, cfg = jax_tiny_config(), tiny_config()
    init = init_pretraining_params if heads else init_conditional_params
    params = init(jax.random.PRNGKey(0), jcfg)
    specs = zero1_moment_specs(param_partition_specs(params), params, world)
    flat_specs = {"/".join(str(getattr(p, "key", p)) for p in path): spec
                  for path, spec in jax.tree_util.tree_flatten_with_path(
                      specs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]}
    want = {k: (list(s).index("data") if "data" in s else None) for k, s in flat_specs.items()}
    model = (init_pretraining_model if heads else init_conditional_model)(cfg, device="cpu")
    got = leaf_axes(cfg, {n: t.shape for n, t in model_tensors(model).items()}, world,
                    heads=heads)
    assert set(got) == set(_flatten(jax.tree.map(np.asarray, params)))
    assert got == {k: want[k] for k in got}
    assert set(got.values()) >= ({0} if world == 2 else {0, 1, 2, None})


def test_sharded_checkpoint_of_two_ranks_loads_into_one_process(step_runs):
    out, two = step_runs[2]
    cfg = tiny_config()
    loaded = load_sharded(str(out / "sharded"))
    _, npz_model, _ = load_pretrained(str(out / "npz"), device="cpu")
    td = load_training_data(str(out / "npz"), cfg, device="cpu")
    want = model_tensors(npz_model)
    for n, t in loaded["params"].items():
        assert torch.equal(t, want[n]), n
        assert torch.equal(t, two[0]["zero1"][n]), n
    for field in ("mu", "nu"):
        a, b = getattr(loaded["opt_state"], field), getattr(td["opt_state"], field)
        assert a.keys() == b.keys()
        for n in a:
            assert torch.equal(a[n], b[n]), (field, n)
    assert loaded["opt_state"].leaf_steps.keys() == td["opt_state"].leaf_steps.keys()
    assert int(loaded["opt_state"].step) == int(td["opt_state"].step) == 3
    assert (loaded["epoch"], loaded["step"]) == (0, 3)
    model = init_conditional_model(cfg, seed=1, device="cpu")
    load_params_into(model, loaded["params"])
    batch = make_batch(cfg)
    tokens = generate(model, cfg, {k: batch[k] for k in ("input_ids", "attention_mask",
                                                         "image_features")},
                      num_beams=2, max_length=8)
    ref = generate(npz_model, cfg, {k: batch[k] for k in ("input_ids", "attention_mask",
                                                          "image_features")},
                   num_beams=2, max_length=8)
    assert tokens.shape[0] == 8 and np.array_equal(tokens, ref)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    from tests.fixtures.make_dataset import make_dataset
    d = str(tmp_path_factory.mktemp("dpdata"))
    make_dataset(d)
    return d


def _train_argv(data, ckpt_dir, batch_size, *extra):
    return ["-m", "kmbart_tpu_torch.vcg_train", "--data_dir", os.path.join(data, "vcg"),
            "--checkpoint_dir", ckpt_dir, "--tokenizer_dir", os.path.join(data, "tokenizer"),
            "--epochs", "1", "--batch_size", str(batch_size), "--lr", "1e-3",
            "--max_length", "8", "--device", "cpu", "--dropout", "0", "--attention_dropout",
            "0", "--activation_dropout", "0", "--classif_dropout", "0", *extra]


def test_vcg_train_multihost_matches_one_process_and_resumes(data, tmp_path):
    cfg = ["--model_config", os.path.join(data, "config.json"), "--validate_loss"]
    multi = _run(_train_argv(data, str(tmp_path / "multi"), 4, "--multihost", *cfg), 2)
    single = _run(_train_argv(data, str(tmp_path / "single"), 8, *cfg), 1)
    lm = [float(x) for x in TRAIN_LOSS_RE.findall(multi[0])]
    ls = [float(x) for x in TRAIN_LOSS_RE.findall(single[0])]
    assert len(lm) >= 2 and len(lm) == len(ls)
    np.testing.assert_allclose(lm, ls, rtol=2e-3, atol=2e-3)
    assert not TRAIN_LOSS_RE.findall(multi[1])     # only rank 0 logs
    vm = [float(x) for x in VAL_LOSS_RE.findall(multi[0])]
    vs = [float(x) for x in VAL_LOSS_RE.findall(single[0])]
    assert vm and len(vm) == len(vs)
    np.testing.assert_allclose(vm, vs, rtol=2e-3, atol=2e-3)
    runs = os.listdir(tmp_path / "multi")
    assert len(runs) == 1      # one run directory for both ranks
    model0 = tmp_path / "multi" / runs[0] / "model0"
    assert (model0 / "params.npz").exists() and (model0 / "training_data.npz").exists()

    resumed = _run(_train_argv(data, str(tmp_path / "resumed"), 4, "--multihost", "--zero1",
                               "--sharded_checkpoints", "--continue_training", "--checkpoint",
                               str(model0), "--epochs", "2"), 2)
    assert "Epoch 2" in resumed[0] and "Epoch 1" not in resumed[0].split("Start training")[1]
    run = tmp_path / "resumed" / os.listdir(tmp_path / "resumed")[0]
    loaded = load_sharded(str(run / "model1"))
    assert loaded["epoch"] == 1 and loaded["step"] == 8


def test_pretrain_multihost_zero1_sharded_and_refused_flags(data, tmp_path, monkeypatch):
    """The ``pretrain`` twin at two ranks with ZeRO-1 (the heads' leaves
    too) writes a sharded checkpoint that loads into one process; its
    tensor, sequence and pipeline parallelism flags are accepted, and the
    combinations the JAX CLIs refuse are refused (``make_grid_from_args``,
    kmbart_tpu/cli_common.py:296-319), as is a split model without
    --multihost."""
    from kmbart_tpu_torch import pretrain
    from kmbart_tpu_torch.cli_common import make_grid_from_args
    argv = ["--dataset", "coco_train", os.path.join(data, "coco"),
            "--dataset", "vg_train", os.path.join(data, "vg"),
            "--checkpoint_dir", str(tmp_path / "ckpt"),
            "--tokenizer_dir", os.path.join(data, "tokenizer"),
            "--model_config", os.path.join(data, "config.json"), "--epochs", "1",
            "--batch_size", "4", "--max_img_num", "4", "--lr", "1e-3", "--device", "cpu"]
    flags = ["--model_parallel", "2", "--pipeline_stages", "2", "--sequence_parallel",
             "--pipeline_microbatches", "4", "--pipeline_span_processes"]
    args = pretrain.parse_args(argv + flags)
    assert (args.model_parallel, args.pipeline_stages, args.pipeline_microbatches) == (2, 2, 4)
    assert args.sequence_parallel and args.pipeline_span_processes
    monkeypatch.setenv("KMBART_NO_FUSED_FFN", "")
    monkeypatch.delenv("KMBART_NO_FUSED_FFN")
    with pytest.raises(ValueError, match="cannot be combined with --sequence_parallel"):
        make_grid_from_args(pretrain.parse_args(argv + flags + ["--multihost"]))
    for flag in (["--model_parallel", "2"], ["--pipeline_stages", "2"]):
        with pytest.raises(ValueError, match="need --multihost"):
            make_grid_from_args(pretrain.parse_args(argv + flag))
    out = _run(["-m", "kmbart_tpu_torch.pretrain"] + argv
               + ["--multihost", "--zero1", "--sharded_checkpoints"], 2)
    assert "Loss" in out[0] and "Loss" not in out[1]
    run = tmp_path / "ckpt" / os.listdir(tmp_path / "ckpt")[0]
    loaded = load_sharded(str(run / "model0"))
    from kmbart_tpu_torch.config import MultiModalBartConfig
    cfg = MultiModalBartConfig.from_json(os.path.join(data, "config.json"))
    model = init_pretraining_model(cfg, device="cpu")
    names = set(model_tensors(model))
    assert set(loaded["params"]) == names and set(loaded["opt_state"].mu) == names
    assert any(n.startswith("relation_head") for n in names) and loaded["step"] > 0
    for n, t in model_tensors(model).items():
        assert loaded["opt_state"].mu[n].shape == t.shape, n
