"""Non-maximum suppression, in PyTorch.

Counterpart of kmbart_tpu/vision/nms.py: the detector's NMS and the
class-wise max-confidence pooling of the reference's extractor
(scripts/feature_extractor.py:90-106). The greedy loops run a fixed number
of steps over fixed-shape tensors, as the JAX ``fori_loop``s do: each step
selects the highest-scoring live box (the first on a tie) and suppresses
what overlaps it. No step reads a value back to the host, so a whole loop
is queued on the card without a synchronisation.
"""

import numpy as np
import torch

from kmbart_tpu_torch import _native

NEG_INF = -float("inf")


def _area(b):
    return torch.clamp(b[..., 2] - b[..., 0], min=0) * torch.clamp(b[..., 3] - b[..., 1], min=0)


def _iou(inter, union):
    return torch.where(union > 0, inter / union, 0.0)


def box_iou(boxes_a, boxes_b):
    """IoU matrix [A, B] for xyxy boxes (detectron2 convention, +0 area)."""
    lt = torch.maximum(boxes_a[:, None, :2], boxes_b[None, :, :2])
    rb = torch.minimum(boxes_a[:, None, 2:], boxes_b[None, :, 2:])
    wh = torch.clamp(rb - lt, min=0)
    inter = wh[..., 0] * wh[..., 1]
    return _iou(inter, _area(boxes_a)[:, None] + _area(boxes_b)[None, :] - inter)


def box_iou_batched(boxes):
    """Pairwise IoU per batch row: [B, N, 4] -> [B, N, N]."""
    lt = torch.maximum(boxes[..., :, None, :2], boxes[..., None, :, :2])
    rb = torch.minimum(boxes[..., :, None, 2:], boxes[..., None, :, 2:])
    wh = torch.clamp(rb - lt, min=0)
    inter = wh[..., 0] * wh[..., 1]
    area = _area(boxes)
    return _iou(inter, area[..., :, None] + area[..., None, :] - inter)


def _iou_rows(sel, boxes):
    """IoU of one selected box per batch row against all boxes: sel [B, 4],
    boxes [B, N, 4] -> [B, N], without the [N, N] matrix."""
    lt = torch.maximum(sel[:, None, :2], boxes[..., :2])
    rb = torch.minimum(sel[:, None, 2:], boxes[..., 2:])
    wh = torch.clamp(rb - lt, min=0)
    inter = wh[..., 0] * wh[..., 1]
    return _iou(inter, _area(sel)[:, None] + _area(boxes) - inter)


def nms_mask(boxes, scores, iou_threshold, valid=None, max_keep=None):
    """Boolean keep-mask NMS (fixed shape); ``valid`` masks padded rows and
    ``max_keep`` bounds the greedy steps (the first K kept boxes equal full
    NMS's)."""
    keep = nms_mask_batched(boxes[None], scores[None], iou_threshold,
                            valid=None if valid is None else valid[None], max_keep=max_keep)
    return keep[0]


def nms_mask_batched(boxes, scores, iou_threshold, valid=None, max_keep=None):
    """nms_mask over a batch: boxes [B, N, 4], scores [B, N] -> keep [B, N].
    The whole batch shares one loop of ``max_keep`` steps over box ranks."""
    B, n = scores.shape
    alive = torch.ones((B, n), dtype=torch.bool, device=scores.device) if valid is None \
        else valid.clone()
    keep = torch.zeros((B, n), dtype=torch.bool, device=scores.device)
    col = torch.arange(n, device=scores.device)[None, :]
    steps = n if max_keep is None else min(n, max_keep)
    for _ in range(steps):
        s = torch.where(alive, scores, NEG_INF)
        best, idx = s.max(dim=1, keepdim=True)               # first max on a tie
        has = best > NEG_INF
        keep.scatter_(1, idx, keep.gather(1, idx) | has)
        sel = torch.gather(boxes, 1, idx[..., None].expand(B, 1, 4))[:, 0]
        suppress = (_iou_rows(sel, boxes) > iou_threshold) & has
        alive &= ~suppress & (col != idx)
    return keep


def nms(boxes, scores, iou_threshold):
    """Indices of kept boxes, score-descending (torchvision's convention),
    as a numpy array. Uses the port's C++ host NMS when it is built
    (native/kmbart_native.cpp), otherwise the tensor loop."""
    if _native.available():
        return _native.nms(np.asarray(boxes, np.float32), np.asarray(scores, np.float32),
                           iou_threshold)
    scores = np.asarray(scores, np.float32)
    keep = nms_mask(torch.as_tensor(np.asarray(boxes, np.float32)), torch.as_tensor(scores),
                    iou_threshold).numpy()
    idx = np.nonzero(keep)[0]
    return idx[np.argsort(-scores[idx], kind="stable")]


def class_wise_max_conf(boxes, scores, iou_threshold=0.3):
    """The reference's per-class NMS confidence pooling: for every class
    c >= 1 run NMS on (boxes, scores[:, c]) and raise each kept box's
    max_conf to its class score. boxes [N, 4], scores [N, C+1] -> [N]."""
    return class_wise_max_conf_batched(boxes.float()[None], scores.float()[None],
                                       iou_threshold)[0]


def class_wise_max_conf_batched(boxes, scores, iou_threshold=0.3):
    """class_wise_max_conf over a batch in one rank loop: boxes [B, N, 4],
    scores [B, N, C+1] -> max_conf [B, N]. Every image and class advances
    each step ([B, C, N] state) over one shared IoU matrix."""
    B, n = boxes.shape[:2]
    iou = box_iou_batched(boxes)                                # [B, N, N]
    cls_scores = scores[..., 1:].transpose(1, 2)                # [B, C, N]
    C = cls_scores.shape[1]
    col = torch.arange(n, device=boxes.device)[None, None, :]
    alive = torch.ones((B, C, n), dtype=torch.bool, device=boxes.device)
    kept = torch.zeros((B, C, n), dtype=torch.float32, device=boxes.device)
    for _ in range(n):
        s = torch.where(alive, cls_scores, NEG_INF)
        best, idx = s.max(dim=2, keepdim=True)                  # [B, C, 1]
        has = best > NEG_INF
        kept.scatter_reduce_(2, idx, torch.where(has, best, 0.0), reduce="amax")
        iou_rows = torch.gather(iou, 1, idx.expand(B, C, n))    # row idx of each image's IoU
        alive &= ~((iou_rows > iou_threshold) & has) & (col != idx)
    return kept.amax(dim=1)
