"""PyTorch port, the JAX package's kernel switches and CLI flags: the
attention routing under ``KMBART_NO_FUSED_ATTN`` and
``KMBART_FUSED_ATTN_HEADS_MAX``, a model loss with each of
``KMBART_NO_FUSED_ATTN``, ``KMBART_NO_FUSED_FFN`` and ``KMBART_NO_FUSED_CE``
(the kernel's wrapper not reached, the loss that of the default path), and
``--amp``, ``--debug_nans`` and ``--cpu`` on each CLI twin's parser.

Tolerance: the loss of the switched path against the default path at
dropout 0 in bf16 within rtol 1e-4, tests/test_torch_training.py's bf16 loss
bound (the composite and the kernels' plain versions round the same values,
in another order of operations)."""

import sys

import numpy as np
import pytest
import torch

import vcg_train as jax_vcg_train
from kmbart_tpu_torch import pretrain, vcg_generate, vcg_train
from kmbart_tpu_torch.cli_common import setup_device
from kmbart_tpu_torch.config import tiny_config
from kmbart_tpu_torch.models import bart
from kmbart_tpu_torch.models.conditional import conditional_loss, init_conditional_model
from kmbart_tpu_torch.ops import attention, lm_ce
from tests.test_torch_pretrain_kernels import _attention_module

SWITCHES = ("KMBART_NO_FUSED_ATTN", "KMBART_FUSED_ATTN_HEADS_MAX", "KMBART_NO_FUSED_FFN",
            "KMBART_NO_FUSED_CE")


@pytest.fixture
def no_switches(monkeypatch):
    for name in SWITCHES:
        monkeypatch.delenv(name, raising=False)
    return monkeypatch


def _route(monkeypatch, T, H, causal=False):
    """The path ``multi_head_attention`` takes for self-attention over T
    tokens with H heads of 8 columns: "k1", "k11" or "composite"."""
    attn, _ = _attention_module(np.random.default_rng(0), 8 * H)
    taken = []
    monkeypatch.setattr(attention, "train_attention",
                        lambda *a, **k: taken.append("k1") or torch.zeros(a[0].shape))
    monkeypatch.setattr(attention, "flash_self_attention",
                        lambda *a, **k: taken.append("k11") or torch.zeros(a[0].shape))
    x = torch.zeros((1, T, 8 * H))
    attention.multi_head_attention(attn, x, num_heads=H, key_mask=torch.ones(1, T),
                                   causal=causal, dtype=torch.float32)
    return taken[0] if taken else "composite"


@pytest.mark.parametrize("env,T,H,route", [
    ({}, 144, 12, "k1"),
    ({}, 72, 12, "k1"),
    ({"KMBART_NO_FUSED_ATTN": "1"}, 144, 12, "k11"),      # flash_supported takes 144²
    ({"KMBART_NO_FUSED_ATTN": "1"}, 72, 12, "composite"),  # 72² < 128²
    ({"KMBART_NO_FUSED_ATTN": "0"}, 72, 12, "k1"),         # only "1" switches off
    ({"KMBART_FUSED_ATTN_HEADS_MAX": "8"}, 72, 12, "composite"),
    ({"KMBART_FUSED_ATTN_HEADS_MAX": "8"}, 144, 12, "k11"),
    ({"KMBART_FUSED_ATTN_HEADS_MAX": "8"}, 72, 8, "k1"),
    ({"KMBART_FUSED_ATTN_HEADS_MAX": "16"}, 72, 16, "k1"),
    ({}, 72, 16, "composite"),
])
@pytest.mark.parametrize("causal", [False, True])
def test_attention_routing_under_switches(no_switches, env, T, H, route, causal):
    """The JAX flow (ops/attention.py:118,191): a switch takes K1 out; a
    shape that flash_supported takes then goes to K11, any other to the
    composite. Read at call time."""
    for name, value in env.items():
        no_switches.setenv(name, value)
    assert _route(no_switches, T, H, causal) == route


# ---------------------------------------------------------------------------
# each switch on a model loss
# ---------------------------------------------------------------------------

def _loss_setup():
    """A bf16 config on which every kernel gate passes by default (K1, K2,
    K7/K8), its model and a batch."""
    cfg = tiny_config(d_model=128, encoder_ffn_dim=256, decoder_ffn_dim=256, vocab_size=1100,
                      dtype="bfloat16", attention_dropout=0.0, activation_dropout=0.0)
    model = init_conditional_model(cfg, seed=0, device="cpu")
    rng = np.random.default_rng(0)
    B, S, T = 8, 12, 6
    ids = rng.integers(4, 80, (B, S))
    ids[:, 1:3] = cfg.img_feat_id
    mask = np.ones((B, S), np.int64)
    mask[1, -3:] = 0
    labels = rng.integers(4, 1100, (B, T))
    labels[0, -2:] = -100
    batch = dict(input_ids=ids, attention_mask=mask, decoder_input_ids=rng.integers(4, 80, (B, T)),
                 decoder_attention_mask=np.ones((B, T), np.int64), labels=labels)
    batch = {k: torch.from_numpy(v) for k, v in batch.items()}
    batch["image_features"] = torch.from_numpy(
        rng.normal(size=(B, cfg.max_img_num, cfg.image_feature_size)).astype(np.float32))
    return cfg, model, batch


# switch -> (module, name) of the wrapper it keeps the model from
WRAPPERS = {"KMBART_NO_FUSED_ATTN": (attention, "train_attention"),
            "KMBART_NO_FUSED_FFN": (bart, "ffn"),
            "KMBART_NO_FUSED_CE": (lm_ce, "fused_lm_ce")}


@pytest.mark.parametrize("switch", list(WRAPPERS))
def test_switch_keeps_the_model_off_the_kernel(no_switches, switch):
    cfg, model, batch = _loss_setup()
    mod, name = WRAPPERS[switch]
    calls = []
    fn = getattr(mod, name)
    no_switches.setattr(mod, name, lambda *a, **k: calls.append(1) or fn(*a, **k))

    def loss():
        model.zero_grad(set_to_none=True)
        value = conditional_loss(model, cfg, batch, train=True)[0]
        value.backward()
        return float(value.detach()), model.model.shared.weight.grad.clone()

    want, want_grad = loss()
    assert calls, f"{name} not reached on the default path"
    calls.clear()
    no_switches.setenv(switch, "1")
    got, got_grad = loss()
    assert not calls, f"{name} reached under {switch}=1"
    np.testing.assert_allclose(got, want, rtol=1e-4)
    assert torch.isfinite(got_grad).all()


# ---------------------------------------------------------------------------
# the CLI flags
# ---------------------------------------------------------------------------

TWINS = {
    "vcg_generate": (vcg_generate, ["--data_dir", "d", "--output_file", "o.json",
                                    "--checkpoint", "c"]),
    "vcg_train": (vcg_train, ["--data_dir", "d", "--checkpoint_dir", "c",
                              "--model_config", "m.json"]),
    "pretrain": (pretrain, ["--dataset", "coco_train", "d", "--checkpoint_dir", "c",
                            "--model_config", "m.json"]),
}


@pytest.mark.parametrize("twin", list(TWINS))
def test_twins_take_the_jax_hardware_flags(twin):
    mod, argv = TWINS[twin]
    args = mod.parse_args(argv)
    assert (args.device, args.amp, args.debug_nans) == ("cuda", False, False)
    args = mod.parse_args(argv + ["--amp", "--debug_nans", "--cpu"])
    assert (args.device, args.amp, args.debug_nans) == ("cpu", True, True)
    assert mod.parse_args(argv + ["--device", "cpu"]).device == "cpu"


def test_debug_nans_turns_on_anomaly_detection():
    before = torch.is_anomaly_enabled()
    try:
        args = vcg_train.parse_args(TWINS["vcg_train"][1] + ["--cpu", "--debug_nans"])
        assert setup_device(args) == torch.device("cpu")
        assert torch.is_anomaly_enabled()
        torch.autograd.set_detect_anomaly(False)
        args = vcg_train.parse_args(TWINS["vcg_train"][1] + ["--cpu"])
        setup_device(args)
        assert not torch.is_anomaly_enabled()
    finally:
        torch.autograd.set_detect_anomaly(before)


def test_jax_vcg_train_command_line_parses_on_the_twin(monkeypatch):
    """A command line of the JAX vcg_train, --amp and --cpu included, means
    the same on the twin."""
    argv = ["--data_dir", "d", "--checkpoint_dir", "c", "--model_config", "m.json",
            "--tokenizer_dir", "t", "--epochs", "1", "--batch_size", "8", "--lr", "1e-4",
            "--dropout", "0.1", "--validate_loss", "--amp", "--debug_nans", "--cpu"]
    monkeypatch.setattr(sys, "argv", ["vcg_train.py"] + argv)
    want = vars(jax_vcg_train.parse_args())
    got = vars(vcg_train.parse_args(argv))
    assert got["device"] == "cpu" and want["cpu"]
    for key in ("amp", "debug_nans", "epochs", "batch_size", "lr", "dropout",
                "validate_loss", "data_dir", "checkpoint_dir", "tokenizer_dir"):
        assert got[key] == want[key], key
