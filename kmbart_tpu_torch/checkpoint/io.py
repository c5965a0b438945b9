"""Checkpoints in the JAX package's format, both ways.

Counterpart of kmbart_tpu/checkpoint/io.py and of ``pytree_to_state_dict``
in kmbart_tpu/checkpoint/torch_import.py, which this module must match key
for key. A directory holds ``config.json`` and either ``params.npz`` (the
JAX package's format: "/"-joined pytree paths, [in, out] kernels, layers
stacked on a leading axis) or a reference ``pytorch_model.bin`` (HF names,
[out, in]; names in ``config.partial_load`` may differ in shape and load
their overlapping top-left slice, torch_import.py:169). The pretraining
model's three classification heads are leaves of their own
(``mrm_head/dense_kernel`` and the like). A train checkpoint
adds ``training_data.npz``: the AdamW state under the JAX flat keys
(``step``, ``mu/…``, ``nu/…``, ``leaf_steps/…``) and ``__meta__`` (epoch
and train step). What the port writes loads in ``kmbart_tpu``, and the
reverse.
"""

import json
import os

import numpy as np
import torch

from kmbart_tpu_torch.config import MultiModalBartConfig
from kmbart_tpu_torch.device import resolve_device
from kmbart_tpu_torch.models.conditional import init_conditional_model

WEIGHTS_NAME = "params.npz"
TRAINING_DATA_NAME = "training_data.npz"
TORCH_WEIGHTS_NAME = "pytorch_model.bin"
CONFIG_NAME = "config.json"

_PROJ = (("q_proj", "q"), ("k_proj", "k"), ("v_proj", "v"), ("out_proj", "o"))
_TIED_COPIES = ("model.encoder.embed_tokens.weight", "model.decoder.embed_tokens.weight")
_HEADS = ("mrm_head", "attribute_head", "relation_head")


def _flatten(tree, prefix=""):
    if not isinstance(tree, dict):
        return {prefix[:-1]: tree}
    flat = {}
    for k, v in tree.items():
        flat.update(_flatten(v, f"{prefix}{k}/"))
    return flat


def _leaf_map(cfg: MultiModalBartConfig, heads=False):
    """[(port name, JAX leaf key, stacked-layer index or None, transpose)]
    for every tensor of the port's conditional model, and with ``heads``
    of the pretraining model's classification heads: HF names on one side,
    "/"-joined pytree paths with [in, out] kernels stacked over layers on
    the other."""
    out = [("model.shared.weight", "model/shared", None, False)]
    for side in ("encoder", "decoder"):
        base = f"model/{side}"
        put = lambda name, key, i=None, t=False: out.append((f"model.{side}.{name}",
                                                             f"{base}/{key}", i, t))
        put("embed_positions.weight", "embed_positions")
        if cfg.normalize_embedding:
            put("layernorm_embedding.weight", "layernorm_embedding/scale")
            put("layernorm_embedding.bias", "layernorm_embedding/bias")
        if cfg.normalize_before if side == "encoder" else cfg.add_final_layer_norm:
            put("layer_norm.weight", "layer_norm/scale")
            put("layer_norm.bias", "layer_norm/bias")
        if side == "encoder":
            put("embed_images.linear.weight", "embed_images/kernel", t=True)
            put("embed_images.linear.bias", "embed_images/bias")
        attns = ("self_attn",) + (("encoder_attn",) if side == "decoder" else ())
        lns = tuple(f"{a}_layer_norm" for a in attns) + ("final_layer_norm",)
        n_layers = cfg.encoder_layers if side == "encoder" else cfg.decoder_layers
        for i in range(n_layers):
            for attn in attns:
                for proj, ours in _PROJ:
                    put(f"layers.{i}.{attn}.{proj}.weight", f"layers/{attn}/{ours}_kernel", i, True)
                    put(f"layers.{i}.{attn}.{proj}.bias", f"layers/{attn}/{ours}_bias", i)
            for ln in lns:
                put(f"layers.{i}.{ln}.weight", f"layers/{ln}/scale", i)
                put(f"layers.{i}.{ln}.bias", f"layers/{ln}/bias", i)
            for fc in ("fc1", "fc2"):
                put(f"layers.{i}.{fc}.weight", f"layers/{fc}_kernel", i, True)
                put(f"layers.{i}.{fc}.bias", f"layers/{fc}_bias", i)
    out.append(("final_logits_bias", "final_logits_bias", None, False))
    if heads:
        for head in _HEADS:
            for ours, theirs in (("dense", "dense"), ("out_proj", "out")):
                out.append((f"{head}.{ours}.weight", f"{head}/{theirs}_kernel", None, True))
                out.append((f"{head}.{ours}.bias", f"{head}/{theirs}_bias", None, False))
    return out


def _has_heads(names):
    return any(n.startswith(_HEADS) for n in names)


def jax_leaf_groups(cfg: MultiModalBartConfig, heads=False):
    """{JAX leaf key: [port names]}: the tensors that make up each leaf of
    the JAX parameter pytree (one per layer for a stacked leaf); with
    ``heads``, also one leaf per tensor of the pretraining heads."""
    groups = {}
    for name, key, _, _ in _leaf_map(cfg, heads):
        groups.setdefault(key, []).append(name)
    return groups


def params_from_jax(flat, cfg: MultiModalBartConfig):
    """JAX parameters -> the port's state dict (torch tensors, fp32).

    ``flat``: the "/"-joined keys of ``params.npz`` or the nested pytree,
    with numpy (or array-like) leaves. Kernels are transposed from
    [in, out] to [out, in] and the stacked layer axis is unstacked. Leaves
    the source does not hold are left out (a conditional model's
    parameters have no heads). The same map converts any pytree shaped like
    the parameters (AdamW moments).
    """
    if any(isinstance(v, dict) for v in flat.values()):
        flat = _flatten(flat)
    p = {k: np.asarray(v) for k, v in flat.items()}
    sd = {}
    for name, key, i, transpose in _leaf_map(cfg, heads=True):
        if key not in p:
            continue
        arr = p[key] if i is None else p[key][i]
        arr = arr.T if transpose else arr
        if name == "final_logits_bias":
            arr = arr.reshape(1, -1)
        sd[name] = torch.from_numpy(np.array(arr, dtype=np.float32))
    if "model.shared.weight" in sd:
        for tied in _TIED_COPIES:
            sd[tied] = sd["model.shared.weight"]
    return sd


def params_to_jax(state_dict, cfg: MultiModalBartConfig):
    """The inverse of ``params_from_jax``: the port's tensors (a state dict,
    or any {port name: tensor} such as AdamW moments) -> {"/"-joined JAX
    key: fp32 numpy array}, layers stacked, kernels [in, out]; the heads
    when the tensors hold them."""
    stacks = {}
    flat = {}
    for name, key, i, transpose in _leaf_map(cfg, _has_heads(state_dict)):
        arr = state_dict[name].detach().float().cpu().numpy()
        arr = arr.T if transpose else arr
        if name == "final_logits_bias":
            arr = arr.reshape(-1)
        if i is None:
            flat[key] = arr
        else:
            stacks.setdefault(key, []).append(arr)
    flat.update({k: np.stack(v) for k, v in stacks.items()})
    return flat


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


def load_pretrained(path, config=None, device="cuda", seed=0,
                    init_model_fn=init_conditional_model):
    """Load a checkpoint directory into ``init_model_fn(config, seed)``
    (``init_conditional_model`` or ``init_pretraining_model``), as the JAX
    ``load_pretrained(path, init_params_fn, strict=False)`` does: weights
    the checkpoint lacks keep their initialisation (a fine-tune checkpoint
    in the pretraining model: its heads) and weights the model lacks are
    dropped (a pretraining checkpoint in the conditional model). Returns
    (config, model, report_lines); the model is built and loaded on the
    host, then moved to ``device`` (the card unless the caller passes "cpu";
    no card raises) in eval mode."""
    device = resolve_device(device)
    if config is None:
        config = MultiModalBartConfig.from_json(os.path.join(path, CONFIG_NAME))
    model = init_model_fn(config, seed=seed, device="cpu")
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


def save_pretrained(path, cfg: MultiModalBartConfig, model):
    """config.json + params.npz in the JAX layout."""
    os.makedirs(path, exist_ok=True)
    cfg.save_json(os.path.join(path, CONFIG_NAME))
    np.savez(os.path.join(path, WEIGHTS_NAME), **params_to_jax(model.state_dict(), cfg))


def save_training_data(path, cfg: MultiModalBartConfig, opt_state=None, epoch=None, step=None):
    """training_data.npz with the keys ``kmbart_tpu.checkpoint.io`` writes
    for a TrainState's AdamW state (moments stacked per JAX leaf)."""
    os.makedirs(path, exist_ok=True)
    flat = {}
    if opt_state is not None:
        flat["step"] = opt_state.step.cpu().numpy().astype(np.int32)
        for field in ("mu", "nu"):
            for k, v in params_to_jax(getattr(opt_state, field), cfg).items():
                flat[f"{field}/{k}"] = v
        for k, v in (opt_state.leaf_steps or {}).items():
            flat[f"leaf_steps/{k}"] = v.cpu().numpy().astype(np.int32)
    meta = {"epoch": epoch, "step": step}
    flat["__meta__"] = np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8)
    np.savez(os.path.join(path, TRAINING_DATA_NAME), **flat)


def load_training_data(path, cfg: MultiModalBartConfig, device="cuda"):
    """Returns {"opt_state": AdamWState or None, "epoch", "step"}, the
    state's tensors on ``device`` (the card unless the caller passes "cpu";
    no card raises). A state without per-leaf steps (an older JAX
    checkpoint) seeds every leaf's step from the global one, as the JAX
    loader does."""
    from kmbart_tpu_torch.training.adamw import AdamWState
    device = resolve_device(device)
    with np.load(os.path.join(path, TRAINING_DATA_NAME)) as data:
        flat = dict(data)
    meta = json.loads(bytes(flat.pop("__meta__")).decode())
    out = {"epoch": meta.get("epoch"), "step": meta.get("step"), "opt_state": None}
    if not flat:
        return out
    split = lambda prefix: {k[len(prefix):]: v for k, v in flat.items() if k.startswith(prefix)}
    moments = [{n: t.to(device) for n, t in params_from_jax(split(f"{f}/"), cfg).items()
                if n not in _TIED_COPIES} for f in ("mu", "nu")]
    step = torch.as_tensor(np.asarray(flat["step"], np.int32), device=device)
    leaf = split("leaf_steps/") or {
        k: flat["step"] for k in jax_leaf_groups(cfg, heads=_has_heads(moments[0]))}
    leaf_steps = {k: torch.as_tensor(np.asarray(v, np.int32), device=device)
                  for k, v in leaf.items()}
    out["opt_state"] = AdamWState(step=step, mu=moments[0], nu=moments[1],
                                  leaf_steps=leaf_steps)
    return out


def extractor_params_from_jax(tree):
    """The JAX package's detector pytree (``init_extractor_params``, numpy
    or array-like leaves) -> the port's tree of fp32 tensors: HWIO conv
    kernels become [out, in, kh, kw] and [in, out] dense kernels
    [out, in]."""
    if isinstance(tree, dict):
        return {k: extractor_params_from_jax(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [extractor_params_from_jax(v) for v in tree]
    arr = np.array(tree, np.float32)
    if arr.ndim == 4:
        arr = arr.transpose(3, 2, 0, 1)
    elif arr.ndim == 2:
        arr = arr.T
    return torch.from_numpy(np.ascontiguousarray(arr))
