"""The port's library entry points run on the card unless the caller asks
for the CPU: the model constructors and checkpoint loaders default to
"cuda", and without a card that default raises instead of returning a model
on the host."""

import inspect

import pytest
import torch

from kmbart_tpu_torch.checkpoint.io import (load_pretrained, load_training_data, save_pretrained,
                                            save_training_data)
from kmbart_tpu_torch.config import tiny_config
from kmbart_tpu_torch.models.conditional import init_conditional_model
from kmbart_tpu_torch.models.pretraining import init_pretraining_model


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    """A tiny conditional model's params.npz and an epoch-only
    training_data.npz, written from the host."""
    path = str(tmp_path_factory.mktemp("ckpt"))
    cfg = tiny_config(dtype="float32")
    save_pretrained(path, cfg, init_conditional_model(cfg, device="cpu"))
    save_training_data(path, cfg, epoch=0, step=0)
    return path, cfg


def _calls(path, cfg):
    return {
        "init_conditional_model": (init_conditional_model, lambda: init_conditional_model(cfg)),
        "init_pretraining_model": (init_pretraining_model, lambda: init_pretraining_model(cfg)),
        "load_pretrained": (load_pretrained, lambda: load_pretrained(path)[1]),
        "load_training_data": (load_training_data, lambda: load_training_data(path, cfg)),
    }


@pytest.mark.parametrize("name", ["init_conditional_model", "init_pretraining_model",
                                  "load_pretrained", "load_training_data"])
def test_entry_point_defaults_to_the_card(name, checkpoint):
    fn, call = _calls(*checkpoint)[name]
    assert inspect.signature(fn).parameters["device"].default == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
        return
    out = call()
    if isinstance(out, torch.nn.Module):
        assert {p.device.type for p in out.parameters()} == {"cuda"}


def test_load_pretrained_builds_on_the_host_then_moves(checkpoint):
    path, cfg = checkpoint
    built = []

    def init(config, seed=0, device="cuda"):
        built.append(device)
        return init_conditional_model(config, seed=seed, device=device)

    _, model, _ = load_pretrained(path, device="cpu", init_model_fn=init)
    assert built == ["cpu"]
    assert {p.device.type for p in model.parameters()} == {"cpu"}
