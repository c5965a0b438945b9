"""PyTorch port, tensor parallelism (parallel/tp.py, parallel/mesh.py) on the
CPU, held against the JAX package.

- Two gloo ranks at TP 2 (tests/_torch_parallel_workers.py): the loss and
  every gradient of one fp32 step on the tiny model equal JAX's
  ``conditional_loss`` under ``param_partition_specs`` on a 2-device mesh,
  within 1e-5 relative (loss) and 1e-4 (gradients); so do four ranks at
  DP 2 x TP 2 (the feed groups' rows side by side) and at PP 2 x TP 2.
- The port's partition table names the axis the JAX rules name, leaf by
  leaf, for every stacked layer leaf; the ends stay whole (a known
  difference).
- AdamW's "used" flag of a leaf split over two ranks stays global when one
  rank's part got no gradient.
- The grid's layouts and its errors, as ``make_mesh`` / ``make_pp_mesh``
  lay out and refuse devices.
- The ``vcg_train`` twin at TP 2 with ZeRO-1 on two ranks against one
  process (fp32 config, losses within 2e-3), its npz written by rank 0 from
  gathered parts, then resumed (the counterpart of
  tests/test_multiprocess.py:174).
- ``vcg_train --validate_score`` at TP 2: each rank decodes on its part
  (no call to ``cli_common.whole_model``), and the generations and scores
  equal one process's.
"""

import json
import os

import jax
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding

from kmbart_tpu.models.conditional import conditional_loss as jax_conditional_loss
from kmbart_tpu.parallel.mesh import make_mesh
from kmbart_tpu.parallel.tp import param_partition_specs
from kmbart_tpu_torch.checkpoint.io import _flatten, _leaf_map, params_from_jax
from kmbart_tpu_torch.config import tiny_config
from kmbart_tpu_torch.parallel.mesh import grid_ranks
from kmbart_tpu_torch.parallel.tp import tp_axis
from tests._torch_parallel_workers import make_batch, spawn, write_params

LOSS_RTOL, GRAD_RTOL, GRAD_ATOL = 1e-5, 1e-4, 1e-6


def jax_grads_by_port_name(grads, cfg):
    """JAX gradients -> {port name: fp32 numpy}, without the tied copies and
    the LM head's bias (a buffer without gradient in both packages)."""
    sd = params_from_jax(_flatten(jax.tree.map(np.asarray, grads)), cfg)
    return {n: t.numpy() for n, t in sd.items()
            if not n.endswith("embed_tokens.weight") and n != "final_logits_bias"}


def assert_step_matches(got, loss, grads, loss_rtol=LOSS_RTOL):
    np.testing.assert_allclose(got["loss"], float(loss), rtol=loss_rtol)
    assert set(got["grads"]) - {"final_logits_bias"} == set(grads)
    for n, want in grads.items():
        np.testing.assert_allclose(got["grads"][n].numpy(), want, rtol=GRAD_RTOL, atol=GRAD_ATOL,
                                   err_msg=n)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = tmp_path_factory.mktemp("tp")
    jcfg, params, _ = write_params(str(out))
    spawn(out, 2, "tp", "used")
    spawn(out, 4, "dp_tp", "pp_tp")
    batch = make_batch(tiny_config(dtype="float32"))
    mesh = make_mesh(devices=jax.devices()[:2], model_parallel=2)
    sharded = jax.tree.map(lambda x, s: jax.device_put(x, NamedSharding(mesh, s)), params,
                           param_partition_specs(params))
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p, b: jax_conditional_loss(p, jcfg, b)[0]))(sharded, batch)
    return out, float(loss), jax_grads_by_port_name(grads, tiny_config(dtype="float32"))


@pytest.mark.parametrize("case", ["tp", "dp_tp", "pp_tp"])
def test_tp_step_matches_jax_partitioned(runs, case):
    out, loss, grads = runs
    assert_step_matches(torch.load(out / f"{case}.pt"), loss, grads)


def test_tp_ranks_hold_their_slices(runs):
    out, _, _ = runs
    got = torch.load(out / "tp.pt")
    assert got["partial"] == 0          # no sequence parallelism: no parts to sum
    # rank 0 of TP 2 holds every tensor name; its split ones are half-size
    # (checked through the gathered gradients' shapes in the step test)
    assert "model.encoder.layers.0.fc1.weight" in got["local_names"]
    pp_tp = torch.load(out / "pp_tp.pt")
    assert "model.encoder.layers.1.fc1.weight" not in pp_tp["local_names"]


def test_partition_table_matches_jax():
    """The axis "model" takes in each JAX stacked-layer leaf is the port
    tensor's split axis ([in, out] kernels transposed, the layer axis
    unstacked); the JAX package's d_model split of the ends is not taken."""
    from kmbart_tpu.config import tiny_config as jax_tiny_config
    from kmbart_tpu.models.pretraining import init_pretraining_params
    jcfg, cfg = jax_tiny_config(), tiny_config()
    params = init_pretraining_params(jax.random.PRNGKey(0), jcfg)
    specs = param_partition_specs(params)
    flat = {"/".join(str(getattr(p, "key", p)) for p in path): tuple(spec)
            for path, spec in jax.tree_util.tree_flatten_with_path(
                specs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]}
    seen = set()
    for name, key, layer, transpose in _leaf_map(cfg, heads=True):
        spec = flat[key]
        jax_axis = spec.index("model") if "model" in spec else None
        if layer is None:
            assert tp_axis(name) is None, name
            continue
        seen.add(key)
        if jax_axis is None:
            assert tp_axis(name) is None, name
            continue
        port_axis = jax_axis - 1
        if transpose:
            port_axis = 1 - port_axis
        assert tp_axis(name) == port_axis, (name, spec)
    assert len(seen) == len({k for k in flat if "/layers/" in k})
    assert {k for k in flat if "model" in flat[k] and "/layers/" not in k} >= {
        "model/shared", "model/encoder/embed_positions"}


def test_used_flag_stays_global(runs):
    out, _, _ = runs
    got = torch.load(out / "used.pt")
    assert [g["or"] for g in got] == [1, 1]
    assert [g["local"] for g in got] == [0, 1]


def test_grid_layouts_and_errors():
    """make_mesh / make_pp_mesh's layouts with one device a process: model
    innermost, then stage, then data; span_processes puts the stage axis
    outermost (pp.py:111 ``_span_process_grid``)."""
    assert grid_ranks(4, model_parallel=2).tolist() == [[[0, 1]], [[2, 3]]]
    assert grid_ranks(8, 2, 2).tolist() == [[[0, 1], [2, 3]], [[4, 5], [6, 7]]]
    assert grid_ranks(8, 2, 2, span_processes=True).tolist() == [[[0, 1], [4, 5]],
                                                                 [[2, 3], [6, 7]]]
    with pytest.raises(ValueError, match="not divisible by model_parallel=2"):
        grid_ranks(3, model_parallel=2)
    with pytest.raises(ValueError, match="not divisible by stages=2"):
        grid_ranks(3, stages=2)
    with pytest.raises(ValueError, match="stages=2 x model_parallel=2"):
        grid_ranks(6, model_parallel=2, stages=2)


def test_heads_must_divide():
    from kmbart_tpu_torch.parallel.distributed import Axis
    from kmbart_tpu_torch.parallel.tp import TensorParallel
    tp = TensorParallel(Axis(3, 0, range(3)))
    with pytest.raises(ValueError, match="does not divide the 4 attention heads"):
        tp.heads(4)


def test_vcg_train_tp_zero1_matches_one_process_and_resumes(fixture_f32, tmp_path):
    from tests.test_torch_multiprocess import TRAIN_LOSS_RE, VAL_LOSS_RE, _run, _train_argv
    data, cfg_path, single = fixture_f32
    multi = _run(_train_argv(data, str(tmp_path / "tp"), 4, "--model_config", cfg_path,
                             "--validate_loss", "--multihost", "--model_parallel", "2",
                             "--zero1"), 2)
    lm = [float(x) for x in TRAIN_LOSS_RE.findall(multi[0])]
    ls = [float(x) for x in TRAIN_LOSS_RE.findall(single)]
    assert len(lm) >= 2 and len(lm) == len(ls)
    np.testing.assert_allclose(lm, ls, rtol=2e-3, atol=2e-3)
    vm = [float(x) for x in VAL_LOSS_RE.findall(multi[0])]
    vs = [float(x) for x in VAL_LOSS_RE.findall(single)]
    assert vm and len(vm) == len(vs)
    np.testing.assert_allclose(vm, vs, rtol=2e-3, atol=2e-3)
    # rank 0 wrote the whole model from both ranks' halves
    run = tmp_path / "tp" / os.listdir(tmp_path / "tp")[0]
    model0 = run / "model0"
    with np.load(model0 / "params.npz") as f:
        assert f["model/encoder/layers/fc1_kernel"].shape[-1] == 64
    with np.load(model0 / "training_data.npz") as f:
        assert f["mu/model/encoder/layers/fc1_kernel"].shape[-1] == 64
    resumed = _run(_train_argv(data, str(tmp_path / "resumed"), 4, "--multihost",
                               "--model_parallel", "2", "--zero1", "--continue_training",
                               "--sharded_checkpoints", "--checkpoint", str(model0),
                               "--epochs", "2"), 2)
    assert "Epoch 2" in resumed[0]
    # each rank wrote its half of the split tensors; they load whole
    from kmbart_tpu_torch.checkpoint.sharded import load_sharded
    run = tmp_path / "resumed" / os.listdir(tmp_path / "resumed")[0]
    loaded = load_sharded(str(run / "model1"))
    assert loaded["params"]["model.encoder.layers.0.fc1.weight"].shape == (64, 32)
    assert loaded["opt_state"].mu["model.decoder.layers.1.fc2.weight"].shape == (32, 64)
    assert loaded["epoch"] == 1


def test_vcg_train_tp_validate_score_decodes_on_parts(fixture_f32, tmp_path):
    """``--validate_score`` at TP 2 without pipeline stages: both ranks
    decode on their parts (``whole_model`` raises if called), and rank 0's
    generations and scores equal one process's."""
    from tests.test_torch_multiprocess import _run, _train_argv
    data, cfg_path, _ = fixture_f32

    def argv(name, *extra):
        flags = _train_argv(data, str(tmp_path / name), 4, "--model_config", cfg_path,
                            "--validate_score", "--num_beams", "3", "--num_gen", "2", *extra)[2:]
        return ["-m", "tests._torch_generate_workers", "cli", str(tmp_path / f"{name}.json"),
                *flags]

    _run(argv("tp", "--multihost", "--model_parallel", "2"), 2)
    _run(argv("single"), 1)
    with open(tmp_path / "tp.json") as f:
        tp = json.load(f)
    with open(tmp_path / "single.json") as f:
        single = json.load(f)
    assert tp["tokens"] and tp["generated"] and tp["generated"][0], tp
    assert tp["tokens"] == single["tokens"]
    assert tp["generated"] == single["generated"]
    assert tp["scores"] == single["scores"] and "CIDEr" in tp["scores"][0]


@pytest.fixture(scope="module")
def fixture_f32(tmp_path_factory):
    """The fixture dataset, its config at fp32, and the train log of one
    process at batch 4 on it."""
    from tests.fixtures.make_dataset import make_dataset
    from tests.test_torch_multiprocess import _run, _train_argv
    d = tmp_path_factory.mktemp("tpdata")
    make_dataset(str(d))
    with open(d / "config.json") as f:
        cfg = json.load(f)
    cfg["dtype"] = "float32"
    cfg_path = str(d / "config_f32.json")
    with open(cfg_path, "w") as f:
        json.dump(cfg, f)
    single = _run(_train_argv(str(d), str(d / "single"), 4, "--model_config", cfg_path,
                              "--validate_loss"), 1)[0]
    return str(d), cfg_path, single
