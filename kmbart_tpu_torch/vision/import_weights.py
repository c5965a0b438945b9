"""Import bottom-up-attention / detectron2 detector checkpoints.

Counterpart of kmbart_tpu/vision/import_weights.py (the reference loads
``bua-caffe-frcn-r101_with_attributes.pth`` with detectron2's
``DetectionCheckpointer``). Maps detectron2 names onto the extractor's
parameter tree (vision/extractor.py ``init_extractor_params``):
  - conv weights stay [out, in, kh, kw];
  - (Frozen)BatchNorm folds into the scale/bias affine:
    scale = gamma / sqrt(var + eps), bias = beta - mean * scale, in fp32
    numpy as the JAX importer computes it;
  - rpn_head.conv / objectness_logits / anchor_deltas;
  - roi_heads.box_predictor.cls_score / bbox_pred (and attr_score when
    present), [out, in] as stored.
"""

import numpy as np
import torch


def _np(t):
    return None if t is None else np.asarray(torch.as_tensor(t).float().numpy())


def _fold_bn(sd, prefix, eps=1e-5):
    gamma, beta = _np(sd.get(prefix + ".weight")), _np(sd.get(prefix + ".bias"))
    mean, var = _np(sd.get(prefix + ".running_mean")), _np(sd.get(prefix + ".running_var"))
    if gamma is None:
        return None
    if mean is None:  # affine-only frozen BN, already folded
        return {"scale": torch.from_numpy(gamma), "bias": torch.from_numpy(beta)}
    scale = gamma / np.sqrt(var + eps)
    return {"scale": torch.from_numpy(scale), "bias": torch.from_numpy(beta - mean * scale)}


def _tensor(sd, name):
    w = sd.get(name)
    return None if w is None else torch.as_tensor(w).float()


def load_detector_weights(path, params):
    """Overlay a detector checkpoint (a ``torch.save``d state dict, or one
    under detectron2's ``model`` key) onto an initialised parameter tree.
    Returns (params, report); the tensors land on the CPU."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(sd, dict) and isinstance(sd.get("model"), dict):
        sd = sd["model"]
    if any(k.startswith("model.backbone") for k in sd):
        sd = {k[len("model."):]: v for k, v in sd.items() if k.startswith("model.")}
    report = []
    loaded = 0

    def put(dst, key, value):
        nonlocal loaded
        if value is None:
            return
        tgt = dst[key]
        if isinstance(value, dict):
            for k2, v2 in value.items():
                if tuple(v2.shape) != tuple(tgt[k2].shape):
                    report.append(f"shape mismatch {key}.{k2}")
                    return
        elif tuple(value.shape) != tuple(tgt.shape):
            report.append(f"shape mismatch {key}: {tuple(value.shape)} vs {tuple(tgt.shape)}")
            return
        dst[key] = value
        loaded += 1

    resnet = {k: (list(v) if isinstance(v, list) else dict(v))
              for k, v in params["resnet"].items()}
    put(resnet["stem"], "conv1", _tensor(sd, "backbone.stem.conv1.weight"))
    put(resnet["stem"], "bn1", _fold_bn(sd, "backbone.stem.conv1.norm"))
    stage_src = {"res2": "backbone.res2", "res3": "backbone.res3",
                 "res4": "backbone.res4", "res5": "roi_heads.res5"}
    for stage, src in stage_src.items():
        blocks = [dict(b) for b in resnet[stage]]
        for i, block in enumerate(blocks):
            base = f"{src}.{i}"
            for conv_name in ("conv1", "conv2", "conv3"):
                put(block, conv_name, _tensor(sd, f"{base}.{conv_name}.weight"))
                put(block, "bn" + conv_name[-1], _fold_bn(sd, f"{base}.{conv_name}.norm"))
            if "shortcut" in block:
                put(block, "shortcut", _tensor(sd, f"{base}.shortcut.weight"))
                put(block, "shortcut_bn", _fold_bn(sd, f"{base}.shortcut.norm"))
        resnet[stage] = blocks

    out = dict(params)
    out["resnet"] = resnet
    rpn = "proposal_generator.rpn_head"
    for ours, theirs in (("rpn_conv", "conv"), ("rpn_obj", "objectness_logits"),
                         ("rpn_delta", "anchor_deltas")):
        put(out, ours, _tensor(sd, f"{rpn}.{theirs}.weight"))
        bias = _tensor(sd, f"{rpn}.{theirs}.bias")
        if bias is not None:
            out[ours + "_bias"] = bias
    for ours, theirs in (("cls_score", "roi_heads.box_predictor.cls_score"),
                         ("bbox_pred", "roi_heads.box_predictor.bbox_pred"),
                         ("attr_score", "roi_heads.box_predictor.attr_score")):
        put(out, ours, _tensor(sd, theirs + ".weight"))
        bias = _tensor(sd, theirs + ".bias")
        if bias is not None and tuple(bias.shape) == tuple(out[ours + "_bias"].shape):
            out[ours + "_bias"] = bias
            loaded += 1
    report.append(f"loaded {loaded} detector tensors/groups")
    return out, report
