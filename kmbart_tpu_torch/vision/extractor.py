"""Bottom-up-attention feature extractor, in PyTorch.

Counterpart of kmbart_tpu/vision/extractor.py (the reference's
``FeatureExtractor``, scripts/feature_extractor.py:18-116, over the
bottom-up-attention Faster R-CNN of config/extract_config.yaml):
  - preprocessing: BGR image, caffe pixel-mean subtraction, shortest side
    600 / longest 1000 (``get_image_blob``);
  - given-boxes path: backbone -> ROIPool(14) -> res5 (dilation 2) ->
    spatial mean (2048-d) -> 1601-way softmax scores;
  - proposal path: RPN proposals -> the same transform -> class-wise
    NMS(0.3) max-confidence pooling -> CONF_THRESH 0.5 with 10..50 boxes.

Every selection uses the stable top-k of ``ops/topk.py``, whose ties go to
the lowest index as ``lax.top_k``'s do: the candidate lists hold many -inf
ties (the RPN's min-size filter, proposals NMS dropped), and with fewer than
``min_boxes`` valid rows some of them are kept. The single-image path is the
batch path at batch 1; the batch path runs the ROI stage image by image, as
the JAX package's ``lax.map`` does, so its memory stays one image's.
"""

import os

import numpy as np
import torch
import torch.nn.functional as F

from kmbart_tpu_torch.device import resolve_device
from kmbart_tpu_torch.ops.layers import matmul_f32
from kmbart_tpu_torch.ops.topk import top_k
from kmbart_tpu_torch.vision import resnet
from kmbart_tpu_torch.vision.nms import class_wise_max_conf_batched, nms_mask_batched
from kmbart_tpu_torch.vision.roi import roi_pool

PIXEL_MEAN_BGR = np.array([102.9801, 115.9465, 122.7717], np.float32)


def get_image_blob(image_bgr, pixel_mean=PIXEL_MEAN_BGR, min_size=600, max_size=1000,
                   device="cpu"):
    """Resize + mean-subtract. Returns (blob [H', W', 3] fp32 on ``device``,
    im_scale).

    The JAX package resizes with ``cv2.resize(fx=s, fy=s, INTER_LINEAR)``,
    whose output has round(h·s) rows and whose source coordinates step by
    1/s. ``upsample_bilinear2d`` given both the size and the scale does the
    same (within 0.05 of cv2 on 8-bit images), and needs no OpenCV."""
    h, w = image_bgr.shape[:2]
    scale = min_size / min(h, w)
    if round(scale * max(h, w)) > max_size:
        scale = max_size / max(h, w)
    x = torch.as_tensor(np.ascontiguousarray(image_bgr), device=device).float()
    x = x.permute(2, 0, 1)[None]
    x = torch.ops.aten.upsample_bilinear2d(x, [round(h * scale), round(w * scale)], False,
                                           scale, scale)
    mean = torch.as_tensor(np.asarray(pixel_mean, np.float32), device=device)
    return x[0].permute(1, 2, 0) - mean, scale


def init_extractor_params(generator, num_classes=1601, num_attributes=401, rpn_channels=512,
                          num_anchors=12, depth=101, device="cpu"):
    """Random detector parameters (the JAX package's shapes and scales,
    drawn from ``generator``). Dense weights are [out, in]."""
    d = 2048
    normal = lambda *shape: torch.randn(shape, generator=generator, device=device)
    zeros = lambda n: torch.zeros(n, device=device)
    return {
        "resnet": resnet.init_resnet_c4(generator, depth, device),
        "rpn_conv": resnet._conv_init(generator, 3, 3, 1024, rpn_channels, device),
        "rpn_conv_bias": zeros(rpn_channels),
        "rpn_obj": resnet._conv_init(generator, 1, 1, rpn_channels, num_anchors, device),
        "rpn_obj_bias": zeros(num_anchors),
        "rpn_delta": resnet._conv_init(generator, 1, 1, rpn_channels, num_anchors * 4, device),
        "rpn_delta_bias": zeros(num_anchors * 4),
        "cls_score": normal(num_classes, d) * 0.01,
        "cls_score_bias": zeros(num_classes),
        "attr_score": normal(num_attributes, d) * 0.01,
        "attr_score_bias": zeros(num_attributes),
        "bbox_pred": normal(num_classes * 4, d) * 0.001,
        "bbox_pred_bias": zeros(num_classes * 4),
    }


def params_to(params, device):
    """The parameter tree with every tensor on ``device``."""
    if isinstance(params, dict):
        return {k: params_to(v, device) for k, v in params.items()}
    if isinstance(params, list):
        return [params_to(v, device) for v in params]
    return params.to(device)


def make_anchors(feat_h, feat_w, stride=16, scales=(4, 8, 16, 32), ratios=(0.5, 1.0, 2.0)):
    """Caffe-style anchors, [feat_h · feat_w · A, 4] numpy (the JAX
    package's table, in its order)."""
    anchors = []
    for ratio in ratios:
        for scale in scales:
            size = stride * scale
            w = size * np.sqrt(1.0 / ratio)
            h = size * np.sqrt(ratio)
            anchors.append([-w / 2, -h / 2, w / 2, h / 2])
    base = np.array(anchors, np.float32)
    ys, xs = np.meshgrid(np.arange(feat_h), np.arange(feat_w), indexing="ij")
    centers = np.stack([xs, ys, xs, ys], axis=-1).astype(np.float32) * stride + stride / 2
    return (centers[:, :, None, :] + base[None, None]).reshape(-1, 4)


def apply_deltas(boxes, deltas, weights=(1.0, 1.0, 1.0, 1.0)):
    """Decode box deltas [..., 4] against boxes [..., 4] (log-size deltas
    clipped to [-10, 4.135])."""
    wx, wy, ww, wh = weights
    widths = boxes[..., 2] - boxes[..., 0]
    heights = boxes[..., 3] - boxes[..., 1]
    cx = boxes[..., 0] + 0.5 * widths
    cy = boxes[..., 1] + 0.5 * heights
    dx, dy = deltas[..., 0] / wx, deltas[..., 1] / wy
    dw = torch.clamp(deltas[..., 2] / ww, -10, 4.135)
    dh = torch.clamp(deltas[..., 3] / wh, -10, 4.135)
    pcx = dx * widths + cx
    pcy = dy * heights + cy
    pw = torch.exp(dw) * widths
    ph = torch.exp(dh) * heights
    return torch.stack([pcx - pw / 2, pcy - ph / 2, pcx + pw / 2, pcy + ph / 2], dim=-1)


class FeatureExtractor:
    """The reference FeatureExtractor: ``extract_feature(image,
    boxes=None)`` -> {'boxes', 'scores', 'features'} (numpy) in
    original-image coordinates. Runs on ``device``: the card unless the
    caller asks for the CPU."""

    def __init__(self, params=None, generator=None, num_classes=1601, num_attributes=401,
                 rpn_channels=512, depth=101, min_boxes=10, max_boxes=50, conf_thresh=0.5,
                 pre_nms_topk=6000, post_nms_topk=300, rpn_min_size=16, rpn_nms_thresh=0.7,
                 nms_thresh=0.3, anchor_scales=(4, 8, 16, 32),
                 bbox_reg_weights=(1.0, 1.0, 1.0, 1.0), min_size=600, max_size=1000,
                 pixel_mean=None, dtype=torch.bfloat16, device="cuda"):
        self.device = resolve_device(device)
        if params is None:
            if generator is None:
                generator = torch.Generator().manual_seed(0)
            params = init_extractor_params(generator, num_classes=num_classes,
                                           num_attributes=num_attributes,
                                           rpn_channels=rpn_channels,
                                           num_anchors=3 * len(anchor_scales), depth=depth)
        self.params = params_to(params, self.device)
        self.min_boxes = min_boxes
        self.max_boxes = max_boxes
        self.conf_thresh = conf_thresh
        self.pre_nms_topk = pre_nms_topk
        self.post_nms_topk = post_nms_topk
        self.rpn_min_size = rpn_min_size
        self.rpn_nms_thresh = rpn_nms_thresh
        self.nms_thresh = nms_thresh
        self.anchor_scales = tuple(anchor_scales)
        self.bbox_reg_weights = tuple(bbox_reg_weights)
        self.min_size = min_size
        self.max_size = max_size
        self.pixel_mean = PIXEL_MEAN_BGR if pixel_mean is None else np.asarray(pixel_mean,
                                                                                np.float32)
        self.dtype = dtype

    @classmethod
    def from_config(cls, path, params=None, generator=None, *, load_weights=True,
                    dtype=torch.bfloat16, device="cuda"):
        """Build from a detectron2-schema YAML (config/extract_config.yaml),
        loading MODEL.WEIGHTS when that file exists and ``load_weights``."""
        from kmbart_tpu_torch.vision.config import load_extract_config
        cfg = load_extract_config(path)
        ex = cls(params=params, generator=generator, dtype=dtype, device=device,
                 **cfg["extractor"], **cfg["input"])
        weights = cfg.get("weights")
        if load_weights and weights and os.path.exists(weights):
            from kmbart_tpu_torch.vision.import_weights import load_detector_weights
            params, _ = load_detector_weights(weights, ex.params)
            ex.params = params_to(params, ex.device)
        return ex

    # ---- stages -------------------------------------------------------

    def _blob(self, image):
        return get_image_blob(image, pixel_mean=self.pixel_mean, min_size=self.min_size,
                              max_size=self.max_size, device=self.device)

    def _backbone(self, blobs):
        """blobs [B, H, W, 3] -> res4 features [B, H/16, W/16, 1024]."""
        return resnet.backbone_c4(self.params["resnet"], blobs, dtype=self.dtype)

    def _roi_features(self, feat, boxes):
        """feat [H, W, C]; boxes [N, 4] in resized-image coords -> (pooled
        [N, 2048] fp32, class scores [N, classes]). The pool runs in the
        compute dtype: max commutes with rounding, and res5 reads its input
        rounded to that dtype."""
        p = self.params
        pooled = roi_pool(feat.to(self.dtype), boxes, output_size=14, spatial_scale=1.0 / 16)
        x = resnet.res5_head(p["resnet"], pooled, dilation=2, dtype=self.dtype)
        feats = x.mean(dim=(1, 2))
        logits = matmul_f32(feats, p["cls_score"], self.dtype) + p["cls_score_bias"]
        return feats, torch.softmax(logits, dim=-1)

    def _rpn_boxes(self, feat, sizes):
        """RPN head on feat [B, H, W, C] with sizes [B, 2] = (im_h, im_w):
        decode, clip, min-size filter, pre-NMS top-k -> (boxes [B, k, 4],
        scores [B, k])."""
        p, dt = self.params, self.dtype
        x = F.relu(resnet.conv(feat, p["rpn_conv"], dtype=dt) + p["rpn_conv_bias"])
        obj = resnet.conv(x, p["rpn_obj"], dtype=dt) + p["rpn_obj_bias"]
        deltas = resnet.conv(x, p["rpn_delta"], dtype=dt) + p["rpn_delta_bias"]
        B, H, W, _ = obj.shape
        anchors = torch.as_tensor(make_anchors(H, W, scales=self.anchor_scales),
                                  device=feat.device)
        obj = obj.reshape(B, -1)
        boxes = apply_deltas(anchors[None], deltas.reshape(B, -1, 4),
                             weights=self.bbox_reg_weights)
        im_h, im_w = sizes[:, 0, None], sizes[:, 1, None]
        zero = torch.zeros((), device=feat.device)
        boxes = torch.stack([torch.clamp(boxes[..., 0], zero, im_w),
                             torch.clamp(boxes[..., 1], zero, im_h),
                             torch.clamp(boxes[..., 2], zero, im_w),
                             torch.clamp(boxes[..., 3], zero, im_h)], dim=-1)
        ok = ((boxes[..., 2] - boxes[..., 0]) >= self.rpn_min_size) & \
             ((boxes[..., 3] - boxes[..., 1]) >= self.rpn_min_size)
        obj = torch.where(ok, obj, -float("inf"))
        top_scores, top_idx = top_k(obj, min(self.pre_nms_topk, obj.shape[1]))
        return torch.gather(boxes, 1, top_idx[..., None].expand(-1, -1, 4)), top_scores

    def _rpn_proposals(self, feat, sizes):
        """-> (proposals [B, post_nms_topk, 4], validity [B, post_nms_topk])."""
        top_boxes, top_scores = self._rpn_boxes(feat, sizes)
        keep = nms_mask_batched(top_boxes, top_scores, self.rpn_nms_thresh,
                                valid=torch.isfinite(top_scores), max_keep=self.post_nms_topk)
        score_kept = torch.where(keep, top_scores, -float("inf"))
        final_scores, final_idx = top_k(score_kept, min(self.post_nms_topk, top_boxes.shape[1]))
        proposals = torch.gather(top_boxes, 1, final_idx[..., None].expand(-1, -1, 4))
        return proposals, torch.isfinite(final_scores)

    def _proposal_stages(self, blobs, sizes):
        """backbone -> RPN -> ROI features (image by image) -> class-wise
        NMS confidences: (proposals, feats, scores, max_conf), batch-first."""
        feat = self._backbone(blobs)
        proposals, valid = self._rpn_proposals(feat, sizes)
        feats, scores = zip(*(self._roi_features(f, b) for f, b in zip(feat, proposals)))
        feats, scores = torch.stack(feats), torch.stack(scores)
        max_conf = class_wise_max_conf_batched(proposals, scores, self.nms_thresh)
        return proposals, feats, scores, torch.where(valid, max_conf, 0.0)

    # ---- public API ---------------------------------------------------

    @staticmethod
    def _pad32(blob):
        """Zero-pad to 32-divisible spatial dims (detectron2 size_divisibility)."""
        h, w = blob.shape[:2]
        return F.pad(blob, (0, 0, 0, (-w) % 32, 0, (-h) % 32))

    def extract_feature(self, image, boxes=None):
        with torch.no_grad():
            if boxes is None:
                return self._extract_without_bbox(image)
            return self._extract_with_bbox(image, boxes)

    def _extract_with_bbox(self, image, boxes):
        """Given-boxes path (scripts/feature_extractor.py:50-73)."""
        blob, im_scale = self._blob(image)
        scaled = np.asarray(boxes, np.float32) * im_scale
        feat = self._backbone(self._pad32(blob)[None])[0]
        feats, scores = self._roi_features(feat, torch.as_tensor(scaled, device=self.device))
        return {"boxes": scaled / im_scale, "scores": scores.cpu().numpy(),
                "features": feats.cpu().numpy()}

    def _keep_indices(self, max_conf):
        """CONF_THRESH filter with the 10..50 box bounds
        (scripts/feature_extractor.py:104-110)."""
        keep = np.nonzero(max_conf >= self.conf_thresh)[0]
        if len(keep) < self.min_boxes:
            keep = np.argsort(-max_conf)[: self.min_boxes]
        elif len(keep) > self.max_boxes:
            keep = np.argsort(-max_conf)[: self.max_boxes]
        return keep

    def _batch_keep(self, cnt, sel_idx_row):
        """Host half of the batched keep rule: ``cnt`` is the above-threshold
        count over all post-NMS proposals, ``sel_idx_row`` maps the arriving
        conf-descending rows to proposal rank. Returns (n_keep, row order),
        as _keep_indices selects: proposal order when cnt is within
        [min_boxes, max_boxes], conf-descending when clipped to a bound."""
        m = len(sel_idx_row)
        if self.min_boxes <= cnt <= m:
            return cnt, np.argsort(sel_idx_row[:cnt], kind="stable")
        n_keep = int(np.clip(cnt, self.min_boxes, m))
        return n_keep, np.arange(n_keep)

    def _extract_without_bbox(self, image):
        """Proposal path (scripts/feature_extractor.py:75-116)."""
        blob, im_scale = self._blob(image)
        h, w = blob.shape[:2]
        sizes = torch.tensor([[h, w]], dtype=torch.float32, device=self.device)
        proposals, feats, scores, max_conf = (
            t[0].cpu().numpy() for t in self._proposal_stages(self._pad32(blob)[None], sizes))
        keep = self._keep_indices(max_conf)
        return {"boxes": proposals[keep] / im_scale, "scores": scores[keep],
                "features": feats[keep]}

    def extract_feature_batch(self, images):
        """Proposal path over a list of images in one batched pass.

        Blobs are zero-padded to the largest 32-divisible shape of the batch
        (detectron2's batched size_divisibility); per-image results equal the
        single-image path's whenever the images share a padded shape. Only
        each image's top ``max_boxes`` rows by max_conf leave the card.
        Returns a list of per-image dicts like extract_feature(boxes=None)."""
        with torch.no_grad():
            blobs, scales = zip(*(self._blob(image) for image in images))
            sizes = [b.shape[:2] for b in blobs]
            H = max(-(-h // 32) * 32 for h, _ in sizes)
            W = max(-(-w // 32) * 32 for _, w in sizes)
            stacked = torch.stack([F.pad(b, (0, 0, 0, W - b.shape[1], 0, H - b.shape[0]))
                                   for b in blobs])
            proposals, feats, scores, max_conf = self._proposal_stages(
                stacked, torch.tensor(sizes, dtype=torch.float32, device=self.device))
            full_cnt = (max_conf >= self.conf_thresh).sum(dim=1)
            _, sel_idx = top_k(max_conf, min(self.max_boxes, max_conf.shape[1]))
            take = lambda x: torch.gather(
                x, 1, sel_idx.reshape(sel_idx.shape + (1,) * (x.ndim - 2)).expand(
                    -1, -1, *x.shape[2:])).cpu().numpy()
            proposals, feats, scores = take(proposals), take(feats), take(scores)
            full_cnt, sel_idx = full_cnt.cpu().numpy(), sel_idx.cpu().numpy()
        out = []
        for i, im_scale in enumerate(scales):
            n_keep, order = self._batch_keep(int(full_cnt[i]), sel_idx[i])
            out.append({"boxes": proposals[i][:n_keep][order] / im_scale,
                        "scores": scores[i][:n_keep][order],
                        "features": feats[i][:n_keep][order]})
        return out
