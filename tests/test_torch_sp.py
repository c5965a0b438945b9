"""PyTorch port, sequence parallelism (parallel/sp.py) on the CPU, held
against the JAX package: twins of tests/test_parallel_sp.py:45 and :104.

Two gloo ranks at TP 2 with SP (tests/_torch_parallel_workers.py): the loss
and every gradient of one fp32 step equal JAX's under
``sequence_parallel(mesh)`` on a 2-device TP mesh (1e-5 relative loss, 1e-4
gradients), with the layer norms' and row-parallel biases' gradients summed
over the model axis; at lengths TP 2 cannot split (13 encoder, 7 decoder
tokens) SP steps aside, as ``constrain`` does, and the step still equals
JAX's. The ``pretrain`` twin trains at TP 2 with SP on two ranks and writes
a whole npz.
"""

import os

import jax
import pytest
import torch
from jax.sharding import NamedSharding

from kmbart_tpu.models.conditional import conditional_loss as jax_conditional_loss
from kmbart_tpu.parallel import sp
from kmbart_tpu.parallel.mesh import make_mesh
from kmbart_tpu.parallel.tp import param_partition_specs
from kmbart_tpu_torch.config import tiny_config
from tests._torch_parallel_workers import make_batch, spawn, write_params
from tests.test_torch_tp import assert_step_matches, jax_grads_by_port_name


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = tmp_path_factory.mktemp("sp")
    jcfg, params, _ = write_params(str(out))
    spawn(out, 2, "sp", "sp_odd")
    mesh = make_mesh(devices=jax.devices()[:2], model_parallel=2)
    sharded = jax.tree.map(lambda x, s: jax.device_put(x, NamedSharding(mesh, s)), params,
                           param_partition_specs(params))
    cfg = tiny_config(dtype="float32")
    refs = {}
    for case, (S, T) in (("sp", (12, 6)), ("sp_odd", (13, 7))):
        with sp.sequence_parallel(mesh):
            loss, grads = jax.jit(jax.value_and_grad(
                lambda p, b: jax_conditional_loss(p, jcfg, b)[0]))(sharded, make_batch(cfg, S, T))
        refs[case] = (float(loss), jax_grads_by_port_name(grads, cfg))
    return out, refs


@pytest.mark.parametrize("case", ["sp", "sp_odd"])
def test_sequence_parallel_matches_jax(runs, case):
    out, refs = runs
    got = torch.load(out / f"{case}.pt")
    assert_step_matches(got, *refs[case])
    # the parts summed over the model axis: 2 layer norms and 2 row-parallel
    # biases in each of the encoder's 2 layers, 3 and 3 in each of the
    # decoder's (12 + 18 tensors); none where SP stepped aside
    assert got["partial"] == (30 if case == "sp" else 0)


def test_pretrain_twin_tp_sp_two_ranks(tmp_path):
    """The ``pretrain`` twin at TP 2 with SP on two ranks: it trains, prints
    its step-0 sample from the whole model gathered on rank 0, and rank 0
    writes an npz of whole tensors that the pretraining model loads."""
    from kmbart_tpu_torch.checkpoint.io import load_pretrained
    from kmbart_tpu_torch.models.pretraining import init_pretraining_model
    from tests.fixtures.make_dataset import make_dataset
    from tests.test_torch_multiprocess import _run
    data = str(tmp_path / "data")
    make_dataset(data)
    out = _run(["-m", "kmbart_tpu_torch.pretrain",
                "--dataset", "coco_train", f"{data}/coco", "--dataset", "vg_train", f"{data}/vg",
                "--checkpoint_dir", str(tmp_path / "ckpt"), "--tokenizer_dir",
                f"{data}/tokenizer", "--model_config", f"{data}/config.json", "--epochs", "1",
                "--batch_size", "4", "--max_img_num", "4", "--lr", "1e-3", "--device", "cpu",
                "--multihost", "--model_parallel", "2", "--sequence_parallel"], 2)
    assert "Loss" in out[0] and "Generated:" in out[0] and "Loss" not in out[1]
    run = tmp_path / "ckpt" / os.listdir(tmp_path / "ckpt")[0]
    _, model, report = load_pretrained(str(run / "model0"), device="cpu",
                                       init_model_fn=init_pretraining_model)
    assert not report
    assert model.model.encoder.layers[0].fc1.weight.shape == (64, 32)
