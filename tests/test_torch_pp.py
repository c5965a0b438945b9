"""PyTorch port, pipeline parallelism (parallel/pp.py) on the CPU, held
against the JAX package and against the port's own sequential path.

- Two gloo ranks at PP 2 (tests/_torch_parallel_workers.py): one fp32 step
  at 1, 2 and 4 micro-batches has the loss of JAX's
  ``pipelined_conditional_loss`` on ``make_stage_mesh(2)`` (1e-5 relative)
  and its gradients (1e-4), and exactly the port's sequential loss (each
  layer runs whole on one stage; only transport changes); remat gives the
  same gradients bit for bit; the pretraining loss's four heads run whole
  on every stage and match ``pipelined_pretraining_loss``. The shared
  embedding's gradient (lookup on stage 0, LM head on every stage) is
  counted once.
- Four ranks at DP 2 x PP 2 with the stage axis spanning process blocks
  (``--pipeline_span_processes``): the grid's layout and the step.
- The refusals and layouts: twins of tests/test_parallel_pp.py:106
  (LayerDrop, indivisible layer counts, n_micro), :162 (the mesh flags'
  combination errors), :179 (``validate_batch_layout``), :365 (the span
  layout).
- The ``vcg_train`` twin at PP 2 on two ranks, and with the stage ring
  across process blocks, against one process (fp32 config, losses within
  2e-3), rank 0 writing the gathered npz; the PP run resumes (twins of
  tests/test_multiprocess.py:229 and :285).
"""

import argparse
import os
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

from kmbart_tpu.parallel import pp as jax_pp
from kmbart_tpu_torch.cli_common import (make_grid_from_args, pipeline_microbatches,
                                         validate_batch_layout)
from kmbart_tpu_torch.config import tiny_config
from kmbart_tpu_torch.models.conditional import conditional_loss, init_conditional_model
from kmbart_tpu_torch.models.pretraining import init_pretraining_model, pretraining_loss
from kmbart_tpu_torch.parallel.distributed import Axis
from kmbart_tpu_torch.parallel.pp import check_pipeline
from tests._torch_parallel_workers import make_batch, spawn, to_torch, write_params
from tests.test_torch_tp import assert_step_matches, fixture_f32, jax_grads_by_port_name  # noqa: F401


def _sequential(model, fn, cfg, batch):
    loss, _ = fn(model, cfg, to_torch(batch))
    loss.backward()
    return float(loss.detach()), {n: p.grad for n, p in model.named_parameters() if p.grad is not None}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = tmp_path_factory.mktemp("pp")
    jcfg, params, pre = write_params(str(out))
    spawn(out, 2, "pp_m1", "pp_m2", "pp_m4", "pp_remat", "pp_pretrain")
    spawn(out, 4, "dp_pp_span")
    cfg = tiny_config(dtype="float32")
    batch, pbatch = make_batch(cfg), make_batch(cfg, pretrain=True)
    mesh = jax_pp.make_stage_mesh(2)
    refs = {}
    loss, grads = jax.jit(jax.value_and_grad(lambda p, b: jax_pp.pipelined_conditional_loss(
        p, jcfg, b, mesh, n_micro=2)[0]))(params, batch)
    refs["jax"] = (float(loss), jax_grads_by_port_name(grads, cfg))
    loss, grads = jax.jit(jax.value_and_grad(lambda p, b: jax_pp.pipelined_pretraining_loss(
        p, jcfg, b, mesh, n_micro=4)[0]))(pre, pbatch)
    refs["jax_pretrain"] = (float(loss), jax_grads_by_port_name(grads, cfg))
    model = init_conditional_model(cfg, device="cpu")
    from kmbart_tpu_torch.checkpoint.io import load_state_dict, params_from_jax
    with np.load(out / "params.npz") as f:
        load_state_dict(model, params_from_jax(dict(f), cfg))
    refs["seq"] = _sequential(model, conditional_loss, cfg, batch)
    model = init_pretraining_model(cfg, device="cpu")
    with np.load(out / "pretrain.npz") as f:
        load_state_dict(model, params_from_jax(dict(f), cfg))
    refs["seq_pretrain"] = _sequential(model, pretraining_loss, cfg, pbatch)
    return out, refs


@pytest.mark.parametrize("case", ["pp_m1", "pp_m2", "pp_m4"])
def test_pipelined_step_matches_jax_and_sequential(runs, case):
    out, refs = runs
    got = torch.load(out / f"{case}.pt")
    assert_step_matches(got, *refs["jax"])
    assert got["loss"] == refs["seq"][0]
    for n, g in refs["seq"][1].items():
        torch.testing.assert_close(got["grads"][n], g, rtol=1e-5, atol=1e-7, msg=n)


def test_pipelined_remat_matches(runs):
    out, _ = runs
    plain, remat = torch.load(out / "pp_m2.pt"), torch.load(out / "pp_remat.pt")
    assert plain["loss"] == remat["loss"]
    for n, g in plain["grads"].items():
        assert torch.equal(remat["grads"][n], g), n


def test_pipelined_pretraining_matches_jax(runs):
    out, refs = runs
    got = torch.load(out / "pp_pretrain.pt")
    assert_step_matches(got, *refs["jax_pretrain"])
    assert got["loss"] == refs["seq_pretrain"][0]
    assert any(n.startswith("relation_head") for n in got["grads"])


def test_span_process_layout_and_step(runs):
    """Stage j is the j-th block of ranks; the ranks of a data coordinate
    (one on each stage) load the same rows; the step matches JAX to
    reduction order."""
    out, refs = runs
    assert torch.load(out / "span_rank0.pt") == [[[0], [2]], [[1], [3]]]
    assert_step_matches(torch.load(out / "dp_pp_span.pt"), *refs["jax"])


def _grid(stages, data=1):
    return SimpleNamespace(stage=Axis(stages, 0, range(stages)), data=Axis(data, 0, range(data)))


def test_pipeline_validates_shapes():
    cfg = tiny_config()
    with pytest.raises(ValueError, match="divide the stage count"):
        check_pipeline(cfg.replace(encoder_layers=3), _grid(2), 8, 2, False)
    with pytest.raises(ValueError, match="LayerDrop"):
        check_pipeline(cfg.replace(encoder_layerdrop=0.1), _grid(2), 8, 2, True)
    with pytest.raises(ValueError, match="n_micro"):
        check_pipeline(cfg, _grid(2), 8, 0, False)
    with pytest.raises(ValueError, match=r"batch 12 not divisible by n_micro=4 x data shards=2"):
        check_pipeline(cfg, _grid(2, data=2), 6, 4, False)
    check_pipeline(cfg.replace(encoder_layerdrop=0.1), _grid(2), 8, 2, False)


def _mesh_args(**kw):
    base = dict(model_parallel=1, pipeline_stages=1, sequence_parallel=False,
                pipeline_span_processes=False, pipeline_microbatches=0, multihost=False)
    return argparse.Namespace(**{**base, **kw})


def test_make_grid_from_args_errors(monkeypatch):
    """The JAX CLI's combination error (SP with PP), the port's need of
    --multihost, and ``KMBART_NO_FUSED_FFN=1`` by default under TP or PP."""
    monkeypatch.setenv("KMBART_NO_FUSED_FFN", "")
    monkeypatch.delenv("KMBART_NO_FUSED_FFN")
    with pytest.raises(ValueError, match="sequence_parallel"):
        make_grid_from_args(_mesh_args(pipeline_stages=2, sequence_parallel=True,
                                       multihost=True))
    assert os.environ["KMBART_NO_FUSED_FFN"] == "1"
    with pytest.raises(ValueError, match="need --multihost"):
        make_grid_from_args(_mesh_args(model_parallel=2))
    assert make_grid_from_args(_mesh_args()) is None
    assert pipeline_microbatches(_mesh_args(pipeline_stages=2)) == 2
    assert pipeline_microbatches(_mesh_args(pipeline_stages=2, pipeline_microbatches=4)) == 4


@pytest.mark.parametrize("model_parallel", [False, True])
def test_zero1_axes_under_stages_match_jax(model_parallel):
    """ZeRO-1 under PP shards each stage's moments on the axes
    ``zero1_moment_specs`` picks over ``stage_param_specs`` (the stage axis
    takes the layer axis; without a model axis the TP axes are free)."""
    from kmbart_tpu.config import tiny_config as jax_tiny_config
    from kmbart_tpu.models.conditional import init_conditional_params
    from kmbart_tpu.parallel.tp import zero1_moment_specs
    from kmbart_tpu_torch.parallel.zero1 import leaf_axes
    from kmbart_tpu_torch.training.state import model_tensors
    params = init_conditional_params(jax.random.PRNGKey(0), jax_tiny_config())
    specs = zero1_moment_specs(jax_pp.stage_param_specs(params, model_parallel=model_parallel),
                               params, 2)
    flat = {"/".join(str(getattr(p, "key", p)) for p in path): tuple(spec)
            for path, spec in jax.tree_util.tree_flatten_with_path(
                specs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]}
    want = {k: (s.index("data") if "data" in s else None) for k, s in flat.items()}
    cfg = tiny_config()
    shapes = {n: t.shape for n, t in model_tensors(init_conditional_model(cfg, device="cpu"))
              .items()}
    got = leaf_axes(cfg, shapes, 2, tp_rules=model_parallel, stages=True)
    assert got == {k: want[k] for k in got} and set(got) == set(want)


def test_validate_batch_layout():
    with pytest.raises(ValueError, match="grad_accum_steps"):
        validate_batch_layout(argparse.Namespace(batch_size=24, grad_accum_steps=2), 8)
    validate_batch_layout(argparse.Namespace(batch_size=32, grad_accum_steps=2), 8)


@pytest.mark.parametrize("span", [False, True])
def test_vcg_train_pipeline_matches_one_process(fixture_f32, tmp_path, span):  # noqa: F811
    from tests.test_torch_multiprocess import TRAIN_LOSS_RE, VAL_LOSS_RE, _run, _train_argv
    data, cfg_path, single = fixture_f32
    flags = ["--multihost", "--pipeline_stages", "2", "--pipeline_microbatches", "2"]
    flags += ["--pipeline_span_processes"] if span else []
    multi = _run(_train_argv(data, str(tmp_path / "pp"), 4, "--model_config", cfg_path,
                             "--validate_loss", *flags), 2)
    lm = [float(x) for x in TRAIN_LOSS_RE.findall(multi[0])]
    ls = [float(x) for x in TRAIN_LOSS_RE.findall(single)]
    assert len(lm) >= 2 and len(lm) == len(ls)
    np.testing.assert_allclose(lm, ls, rtol=2e-3, atol=2e-3)
    vm = [float(x) for x in VAL_LOSS_RE.findall(multi[0])]
    vs = [float(x) for x in VAL_LOSS_RE.findall(single)]
    assert vm and len(vm) == len(vs)
    np.testing.assert_allclose(vm, vs, rtol=2e-3, atol=2e-3)
    assert not TRAIN_LOSS_RE.findall(multi[1])
    model0 = tmp_path / "pp" / os.listdir(tmp_path / "pp")[0] / "model0"
    with np.load(model0 / "params.npz") as f:
        # both stages' layers, stacked whole
        assert f["model/decoder/layers/fc1_kernel"].shape[0] == 2
    if not span:
        resumed = _run(_train_argv(data, str(tmp_path / "resumed"), 4, *flags,
                                   "--continue_training", "--checkpoint", str(model0),
                                   "--epochs", "2"), 2)
        assert "Epoch 2" in resumed[0]
