"""Checkpoints: JAX-layout parameters to the port's state dict, and the
loader for a checkpoint directory.

Counterpart of kmbart_tpu/checkpoint/io.py (load side) and of
``pytree_to_state_dict`` in kmbart_tpu/checkpoint/torch_import.py, which
this module must match key for key. A directory holds ``config.json`` and
either ``params.npz`` (the JAX package's format: "/"-joined pytree paths,
[in, out] kernels, layers stacked on a leading axis) or a reference
``pytorch_model.bin`` (HF names, [out, in]; names in
``config.partial_load`` may differ in shape and load their overlapping
top-left slice, torch_import.py:169).
"""

import os

import numpy as np
import torch

from kmbart_tpu.config import MultiModalBartConfig
from kmbart_tpu_torch.models.conditional import init_conditional_model

WEIGHTS_NAME = "params.npz"
TORCH_WEIGHTS_NAME = "pytorch_model.bin"
CONFIG_NAME = "config.json"

_PROJ = (("q_proj", "q"), ("k_proj", "k"), ("v_proj", "v"), ("out_proj", "o"))
_TIED_COPIES = ("model.encoder.embed_tokens.weight", "model.decoder.embed_tokens.weight")


def _flatten(tree, prefix=""):
    if not isinstance(tree, dict):
        return {prefix[:-1]: tree}
    flat = {}
    for k, v in tree.items():
        flat.update(_flatten(v, f"{prefix}{k}/"))
    return flat


def params_from_jax(flat, cfg: MultiModalBartConfig):
    """JAX parameters -> the port's state dict (torch tensors, fp32).

    ``flat``: the "/"-joined keys of ``params.npz`` or the nested pytree,
    with numpy (or array-like) leaves. Kernels are transposed from
    [in, out] to [out, in] and the stacked layer axis is unstacked.
    """
    if any(isinstance(v, dict) for v in flat.values()):
        flat = _flatten(flat)
    p = {k: np.asarray(v) for k, v in flat.items()}
    sd = {}

    def put(name, arr):
        sd[name] = torch.from_numpy(np.array(arr, dtype=np.float32))

    put("model.shared.weight", p["model/shared"])
    sd["model.encoder.embed_tokens.weight"] = sd["model.shared.weight"]
    sd["model.decoder.embed_tokens.weight"] = sd["model.shared.weight"]
    for side in ("encoder", "decoder"):
        base = f"model/{side}"
        n_layers = cfg.encoder_layers if side == "encoder" else cfg.decoder_layers
        put(f"model.{side}.embed_positions.weight", p[f"{base}/embed_positions"])
        if f"{base}/layernorm_embedding/scale" in p:
            put(f"model.{side}.layernorm_embedding.weight",
                p[f"{base}/layernorm_embedding/scale"])
            put(f"model.{side}.layernorm_embedding.bias",
                p[f"{base}/layernorm_embedding/bias"])
        if f"{base}/layer_norm/scale" in p:
            put(f"model.{side}.layer_norm.weight", p[f"{base}/layer_norm/scale"])
            put(f"model.{side}.layer_norm.bias", p[f"{base}/layer_norm/bias"])
        if side == "encoder":
            put("model.encoder.embed_images.linear.weight",
                p[f"{base}/embed_images/kernel"].T)
            put("model.encoder.embed_images.linear.bias", p[f"{base}/embed_images/bias"])
        lp = f"{base}/layers"
        attns = ("self_attn",) + (("encoder_attn",) if side == "decoder" else ())
        lns = (("self_attn_layer_norm",)
               + (("encoder_attn_layer_norm",) if side == "decoder" else ())
               + ("final_layer_norm",))
        for i in range(n_layers):
            t = f"model.{side}.layers.{i}"
            for attn in attns:
                for proj, ours in _PROJ:
                    put(f"{t}.{attn}.{proj}.weight", p[f"{lp}/{attn}/{ours}_kernel"][i].T)
                    put(f"{t}.{attn}.{proj}.bias", p[f"{lp}/{attn}/{ours}_bias"][i])
            for ln in lns:
                put(f"{t}.{ln}.weight", p[f"{lp}/{ln}/scale"][i])
                put(f"{t}.{ln}.bias", p[f"{lp}/{ln}/bias"][i])
            for fc in ("fc1", "fc2"):
                put(f"{t}.{fc}.weight", p[f"{lp}/{fc}_kernel"][i].T)
                put(f"{t}.{fc}.bias", p[f"{lp}/{fc}_bias"][i])
    if "final_logits_bias" in p:
        put("final_logits_bias", p["final_logits_bias"].reshape(1, -1))
    return sd


def _partial_copy(dst, src):
    """Reference partial load: copy the overlapping top-left slice."""
    out = dst.clone()
    idx = tuple(slice(0, min(a, b)) for a, b in zip(dst.shape, src.shape))
    out[idx] = src[idx]
    return out


def load_state_dict(model, sd, partial_load=()):
    """Load ``sd`` into ``model`` with from_pretrained's rules: missing keys
    keep their initialisation, names in ``partial_load`` may differ in shape
    (overlapping slice), other shape mismatches raise. A base-model state
    dict without the "model." prefix is accepted. Returns report lines."""
    if sd and not any(k.startswith("model.") for k in sd) and any(
            k.startswith(("encoder.", "decoder.", "shared.")) for k in sd):
        sd = {"model." + k: v for k, v in sd.items()}
    own = model.state_dict()
    partial = set(partial_load)
    report, unused, new = [], [], {}
    for name, value in sd.items():
        if name in _TIED_COPIES:
            continue  # the shared embedding's tied copies: shared wins
        if name not in own:
            unused.append(name)
            continue
        target = own[name]
        value = torch.as_tensor(value).to(torch.float32)
        if name == "final_logits_bias":
            value = value.reshape(1, -1)
        if tuple(value.shape) != tuple(target.shape):
            if name not in partial:
                raise ValueError(f"size mismatch for {name}: checkpoint "
                                 f"{tuple(value.shape)} vs model {tuple(target.shape)}")
            report.append(f"partially loaded {name} {tuple(value.shape)} => "
                          f"{tuple(target.shape)}")
            value = _partial_copy(target.detach().cpu(), value)
        new[name] = value
    model.load_state_dict(new, strict=False)
    if unused:
        report.append(f"unused checkpoint keys: {len(unused)}")
    return report


def load_pretrained(path, config=None, device="cpu", seed=0):
    """Load a checkpoint directory. Returns (config, model, report_lines);
    the model is in eval mode on ``device``."""
    if config is None:
        config = MultiModalBartConfig.from_json(os.path.join(path, CONFIG_NAME))
    model = init_conditional_model(config, seed=seed)
    npz = os.path.join(path, WEIGHTS_NAME)
    if os.path.exists(npz):
        with np.load(npz) as data:
            sd = params_from_jax(dict(data), config)
    else:
        binpath = os.path.join(path, TORCH_WEIGHTS_NAME)
        if not os.path.exists(binpath):
            raise FileNotFoundError(f"no {WEIGHTS_NAME} or {TORCH_WEIGHTS_NAME} in {path}")
        sd = torch.load(binpath, map_location="cpu", weights_only=True)
    report = load_state_dict(model, sd, config.partial_load)
    return config, model.to(device).eval(), report
