"""PyTorch port, vision: the bottom-up-attention feature extractor and its
parts (resize, ResNet C4 trunk, ROI pool and align, NMS, anchors, the whole
extractor on both paths and the batch path, the detector importer), each
against the JAX package on the CPU from the same seeded numpy inputs.

The detector runs at depth 50 with 11 classes and small images: the
published widths (ResNet-101, 1601 classes, 600x1000 images) run in
``chip_smoke.py`` on the card."""

import importlib
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kmbart_tpu.vision import extractor as jex
from kmbart_tpu.vision import resnet as jres
from kmbart_tpu.vision import roi as jroi
from kmbart_tpu.vision.config import load_extract_config as jax_load_extract_config
from kmbart_tpu.vision.import_weights import load_detector_weights as jax_load_detector_weights
from kmbart_tpu_torch.checkpoint.io import extractor_params_from_jax
from kmbart_tpu_torch.vision import extractor as tex
from kmbart_tpu_torch.vision import nms as tnms
from kmbart_tpu_torch.vision import resnet as tres
from kmbart_tpu_torch.vision import roi as troi
from kmbart_tpu_torch.vision.config import load_extract_config
from kmbart_tpu_torch.vision.import_weights import load_detector_weights

jnms = importlib.import_module("kmbart_tpu.vision.nms")  # the package re-exports a function "nms"

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = dict(num_classes=11, num_attributes=5, rpn_channels=32, depth=50)
EXTRACTOR = dict(SMALL, min_boxes=3, max_boxes=6, conf_thresh=0.25, pre_nms_topk=200,
                 post_nms_topk=24, min_size=96, max_size=160)
FEAT_RTOL = 1e-4   # fp32 through 16 + 3 bottlenecks: summation order only
_JAX_INIT = jex.init_extractor_params


def _tamed_bn(name):
    """Folded-BN scale of a random detector whose activations stay O(1):
    each block's last BN (and its shortcut's) damps the residual branch."""
    return 0.25 if name in ("bn3", "shortcut_bn") else 1.0


def jax_detector_params(seed, **kw):
    """A JAX-layout detector pytree (HWIO convs, [in, out] dense) of
    ``init_extractor_params``' shapes, drawn with numpy."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(lambda: _JAX_INIT(jax.random.PRNGKey(0), **kw))

    def fill(path, s):
        name = [getattr(k, "key", getattr(k, "idx", None)) for k in path]
        leaf, parent = name[-1], name[-2] if len(name) > 1 else None
        if len(s.shape) == 4:
            fan_in = s.shape[0] * s.shape[1] * s.shape[2]
            return (rng.normal(size=s.shape) * np.sqrt(2.0 / fan_in)).astype(np.float32)
        if leaf == "scale":
            return (_tamed_bn(parent) * rng.uniform(0.8, 1.2, s.shape)).astype(np.float32)
        if leaf == "bias" or str(leaf).endswith("_bias"):
            return (rng.normal(size=s.shape) * 0.05).astype(np.float32)
        std = {"cls_score": 0.05, "attr_score": 0.01, "bbox_pred": 0.001}[leaf]
        return (rng.normal(size=s.shape) * std).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def detector_state_dict(seed, depth=50, num_classes=11, num_attributes=5, rpn_channels=32):
    """A detectron2 / bottom-up-attention state dict (numpy, [out, in, kh,
    kw] convs, unfolded BN with running statistics) whose folded network is
    tamed like ``jax_detector_params``."""
    rng = np.random.default_rng(seed)
    sd = {}

    def conv(name, o, i, k):
        sd[name + ".weight"] = (rng.normal(size=(o, i, k, k)) * np.sqrt(2.0 / (i * k * k))
                                ).astype(np.float32)

    def bn(name, c, scale=1.0):
        var = rng.uniform(0.5, 2.0, c).astype(np.float32)
        sd[name + ".running_var"] = var
        sd[name + ".running_mean"] = (rng.normal(size=c) * 0.05).astype(np.float32)
        sd[name + ".weight"] = (scale * np.sqrt(var + 1e-5)
                                * rng.uniform(0.8, 1.2, c)).astype(np.float32)
        sd[name + ".bias"] = (rng.normal(size=c) * 0.05).astype(np.float32)

    conv("backbone.stem.conv1", 64, 3, 7)
    bn("backbone.stem.conv1.norm", 64)
    n2, n3, n4, n5 = jres.STAGE_BLOCKS[depth]
    stages = {"backbone.res2": (n2, 64, 64, 256), "backbone.res3": (n3, 256, 128, 512),
              "backbone.res4": (n4, 512, 256, 1024), "roi_heads.res5": (n5, 1024, 512, 2048)}
    for src, (n, cin, cmid, cout) in stages.items():
        for b in range(n):
            ci = cin if b == 0 else cout
            for j, (o, i, k) in enumerate(((cmid, ci, 1), (cmid, cmid, 3), (cout, cmid, 1))):
                conv(f"{src}.{b}.conv{j + 1}", o, i, k)
                bn(f"{src}.{b}.conv{j + 1}.norm", o, _tamed_bn(f"bn{j + 1}"))
            if b == 0:
                conv(f"{src}.{b}.shortcut", cout, ci, 1)
                bn(f"{src}.{b}.shortcut.norm", cout, _tamed_bn("shortcut_bn"))
    rpn = "proposal_generator.rpn_head"
    conv(f"{rpn}.conv", rpn_channels, 1024, 3)
    conv(f"{rpn}.objectness_logits", 12, rpn_channels, 1)
    conv(f"{rpn}.anchor_deltas", 48, rpn_channels, 1)
    for name, n in (("conv", rpn_channels), ("objectness_logits", 12), ("anchor_deltas", 48)):
        sd[f"{rpn}.{name}.bias"] = (rng.normal(size=n) * 0.05).astype(np.float32)
    for head, n_out, std in (("cls_score", num_classes, 0.05),
                             ("bbox_pred", 4 * num_classes, 0.001),
                             ("attr_score", num_attributes, 0.01)):
        sd[f"roi_heads.box_predictor.{head}.weight"] = (
            rng.normal(size=(n_out, 2048)) * std).astype(np.float32)
        sd[f"roi_heads.box_predictor.{head}.bias"] = (rng.normal(size=n_out) * 0.05).astype(
            np.float32)
    return sd


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _close(got, want, rtol):
    want = np.asarray(want, np.float32)
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * max(1.0, float(np.abs(want).max())))


@pytest.fixture(scope="module")
def det_params():
    jp = jax_detector_params(3, num_anchors=12, **SMALL)
    return jp, extractor_params_from_jax(jp)


def _map_eagerly(f, xs):
    n = len(jax.tree_util.tree_leaves(xs)[0])
    outs = [f(jax.tree_util.tree_map(lambda a: a[i], xs)) for i in range(n)]
    return jax.tree_util.tree_map(lambda *r: jnp.stack(r), *outs)


@pytest.fixture(scope="module")
def extractors(det_params):
    """The JAX extractor with its stages run eagerly (the backbone and res5
    compiled). Under a trace, XLA may contract the ROI pool's bin edge
    floor(o + i·bin) into one fused multiply-add, which moves an edge that
    falls on an integer and so the pooled window; evaluated op by op, the
    product is rounded first, as the port (and the reference's caffe
    kernel) does. ``lax.map`` of the batch path would trace its ROI stage,
    so it runs as a loop here."""
    jp, tp = det_params
    mp = pytest.MonkeyPatch()
    mp.setattr(jres, "backbone_c4", jax.jit(jres.backbone_c4, static_argnames="dtype"))
    mp.setattr(jres, "res5_head", jax.jit(jres.res5_head, static_argnames=("dilation", "dtype")))
    mp.setattr(jax.lax, "map", _map_eagerly)
    jx = jex.FeatureExtractor(params=jp, dtype=jnp.float32, **EXTRACTOR)
    jx._backbone_j, jx._roi_features_j = jx._backbone, jx._roi_features
    jx._proposal_j = lambda p, b, im_h, im_w: jx._proposal_pipeline(p, b, im_h=im_h, im_w=im_w)
    jx._proposal_batch_j = jx._proposal_pipeline_batch
    yield jx, tex.FeatureExtractor(params=tp, dtype=torch.float32, device="cpu", **EXTRACTOR)
    mp.undo()


def _image(rng, h, w):
    return rng.integers(0, 256, (h, w, 3)).astype(np.uint8)


# ---------------------------------------------------------------- preprocessing

@pytest.mark.parametrize("hw", [(333, 517), (481, 359)])
def test_get_image_blob_matches_cv2(hw):
    """The port's resize without OpenCV stays within 0.05 (of 255) of the
    JAX package's cv2.resize, with the same output size and scale."""
    img = _image(np.random.default_rng(hw[0]), *hw)
    want, s_want = jex.get_image_blob(img)
    got, s_got = tex.get_image_blob(img)
    assert s_got == s_want and got.shape == want.shape
    assert float(np.abs(got.numpy() - want).max()) <= 0.05


def test_extract_config_copy():
    path = os.path.join(REPO, "config", "extract_config.yaml")
    assert load_extract_config(path) == jax_load_extract_config(path)


# ---------------------------------------------------------------- ResNet

@pytest.mark.parametrize("k,stride,dilation", [(1, 1, 1), (1, 2, 1), (3, 1, 1), (3, 1, 2),
                                               (7, 2, 1)])
def test_conv_and_frozen_bn(k, stride, dilation):
    rng = np.random.default_rng(k * 10 + stride + dilation)
    x = rng.normal(size=(2, 11, 14, 6)).astype(np.float32)
    w = rng.normal(size=(k, k, 6, 5)).astype(np.float32)
    bn = {"scale": rng.normal(size=5).astype(np.float32),
          "bias": rng.normal(size=5).astype(np.float32)}
    want = jres.frozen_bn(jres.conv(jnp.asarray(x), jnp.asarray(w), stride, dilation,
                                    dtype=jnp.float32), bn)
    got = tres.frozen_bn(tres.conv(_t(x), _t(w.transpose(3, 2, 0, 1)), stride, dilation,
                                   dtype=torch.float32), {k2: _t(v) for k2, v in bn.items()})
    _close(got, want, 1e-5)
    # bf16 operands, fp32 result: the same rounding of the inputs on both sides
    want = jres.conv(jnp.asarray(x), jnp.asarray(w), stride, dilation, dtype=jnp.bfloat16)
    got = tres.conv(_t(x), _t(w.transpose(3, 2, 0, 1)), stride, dilation, dtype=torch.bfloat16)
    _close(got, want, 1e-5)


@pytest.mark.parametrize("hw", [(9, 10), (8, 8), (7, 12), (16, 15)])
def test_stem_max_pool_same_padding(hw):
    x = np.random.default_rng(hw[0]).normal(size=(2, *hw, 3)).astype(np.float32)
    want = jax.lax.reduce_window(jnp.asarray(x), -jnp.inf, jax.lax.max, (1, 3, 3, 1),
                                 (1, 2, 2, 1), "SAME")
    np.testing.assert_array_equal(tres.max_pool_same(_t(x)).numpy(), np.asarray(want))


@pytest.mark.parametrize("stride,shortcut,dilation", [(1, True, 1), (2, True, 1),
                                                      (1, False, 1), (1, False, 2)])
def test_bottleneck(stride, shortcut, dilation):
    rng = np.random.default_rng(stride + 2 * shortcut + 4 * dilation)
    cin = 16 if shortcut else 32
    shapes = jax.eval_shape(lambda: jres.init_bottleneck(jax.random.PRNGKey(0), cin, 8, 32,
                                                         shortcut))
    p = jax.tree_util.tree_map(lambda a: rng.normal(size=a.shape).astype(np.float32) * 0.3,
                               shapes)
    x = rng.normal(size=(2, 9, 12, cin)).astype(np.float32)
    want = jres.bottleneck(jnp.asarray(x), p, stride, dilation, dtype=jnp.float32)
    got = tres.bottleneck(_t(x), extractor_params_from_jax(p), stride, dilation,
                          dtype=torch.float32)
    _close(got, want, 1e-5)


def test_backbone_c4_and_res5_head(det_params):
    jp, tp = det_params
    x = np.random.default_rng(5).normal(size=(1, 48, 64, 3)).astype(np.float32) * 50
    want = jres.backbone_c4(jp["resnet"], jnp.asarray(x), dtype=jnp.float32)
    got = tres.backbone_c4(tp["resnet"], _t(x), dtype=torch.float32)
    _close(got, want, FEAT_RTOL)
    assert 1e-2 < float(np.abs(np.asarray(want)).max()) < 1e3   # tamed, not exploding
    rois = np.random.default_rng(6).normal(size=(2, 14, 14, 1024)).astype(np.float32)
    want = jres.res5_head(jp["resnet"], jnp.asarray(rois), dtype=jnp.float32)
    got = tres.res5_head(tp["resnet"], _t(rois), dtype=torch.float32)
    _close(got, want, FEAT_RTOL)


# ---------------------------------------------------------------- ROI ops

BOXES = np.array([[2, 3, 18, 15], [0, 0, 23, 19], [0, 0, 400, 300], [5, 5, 6, 6],
                  [-10, -3, 30, 500], [7.4, 2.6, 7.5, 19.5], [0, 0, 1000, 1000]], np.float32)


@pytest.mark.parametrize("P,scale,max_bin", [(7, 1.0, 8), (14, 1 / 16, 8), (3, 1.0, 2),
                                             (7, 0.5, 3), (2, 1.0, 8)])
def test_roi_pool_matches_jax_exactly(P, scale, max_bin):
    """Bins wider than max_bin (the (3, 1.0, 2) and (2, 1.0, 8) cases keep
    only their first max_bin pixels in both), boxes off the map, one-pixel
    boxes: the same numbers bit for bit."""
    feat = np.random.default_rng(P).normal(size=(20, 24, 5)).astype(np.float32)
    want = jroi.roi_pool(feat, BOXES, P, scale, max_bin=max_bin)
    got = troi.roi_pool(_t(feat), _t(BOXES), P, scale, max_bin=max_bin)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # the detector pools in bf16: max commutes with the rounding
    got16 = troi.roi_pool(_t(feat).bfloat16(), _t(BOXES), P, scale, max_bin=max_bin)
    np.testing.assert_array_equal(got16.float().numpy(),
                                  np.asarray(jnp.asarray(want).astype(jnp.bfloat16), np.float32))


@pytest.mark.parametrize("aligned", [True, False])
def test_roi_align_matches_jax(aligned):
    feat = np.random.default_rng(1).normal(size=(20, 24, 5)).astype(np.float32)
    want = jroi.roi_align(feat, BOXES, 7, 0.5, aligned=aligned)
    got = troi.roi_align(_t(feat), _t(BOXES), 7, 0.5, aligned=aligned)
    _close(got, want, 1e-6)


# ---------------------------------------------------------------- NMS

def _boxes(rng, n, size=60.0):
    xy = rng.uniform(0, size, (n, 2))
    wh = rng.uniform(5, 30, (n, 2))
    return np.concatenate([xy, xy + wh], axis=1).astype(np.float32)


@pytest.mark.parametrize("max_keep", [None, 5])
def test_nms_mask_matches_jax(max_keep):
    rng = np.random.default_rng(0)
    boxes, scores = _boxes(rng, 40), rng.random(40).astype(np.float32)
    scores[10:14] = scores[0]                    # ties: the first index wins
    valid = np.ones(40, bool)
    valid[[3, 17]] = False
    want = jnms.nms_mask(jnp.asarray(boxes), jnp.asarray(scores), 0.5,
                         valid=jnp.asarray(valid), max_keep=max_keep)
    got = tnms.nms_mask(_t(boxes), _t(scores), 0.5, valid=torch.from_numpy(valid),
                        max_keep=max_keep)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    bw = np.stack([boxes, boxes[::-1]])
    sw = np.stack([scores, scores[::-1]])
    want = jnms.nms_mask_batched(jnp.asarray(bw), jnp.asarray(sw), 0.4, max_keep=max_keep)
    got = tnms.nms_mask_batched(_t(bw), _t(sw), 0.4, max_keep=max_keep)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_nms_and_box_iou_match_jax():
    rng = np.random.default_rng(1)
    boxes, scores = _boxes(rng, 30), rng.random(30).astype(np.float32)
    np.testing.assert_array_equal(tnms.nms(boxes, scores, 0.5), jnms.nms(boxes, scores, 0.5))
    _close(tnms.box_iou(_t(boxes[:7]), _t(boxes)), jnms.box_iou(boxes[:7], boxes), 1e-7)
    bb = np.stack([boxes, boxes[::-1]])
    _close(tnms.box_iou_batched(_t(bb)), jnms.box_iou_batched(jnp.asarray(bb)), 1e-7)


def test_class_wise_max_conf_exact_with_ties_and_invalid_rows():
    rng = np.random.default_rng(2)
    n, C = 30, 6
    boxes = _boxes(rng, n)
    boxes[20:23] = boxes[0]                       # duplicates
    boxes[25] = [5, 5, 5, 5]                      # zero area
    scores = rng.random((n, C + 1)).astype(np.float32)
    scores[5:9] = scores[0]                       # tied rows
    scores[27:] = 0.0                             # invalid (zero-score) rows
    want = jnms.class_wise_max_conf(boxes, scores, 0.4)
    got = tnms.class_wise_max_conf(_t(boxes), _t(scores), 0.4)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    bb, sb = np.stack([boxes, boxes[::-1]]), np.stack([scores, scores[::-1]])
    want = jnms.class_wise_max_conf_batched(jnp.asarray(bb), jnp.asarray(sb), 0.3)
    got = tnms.class_wise_max_conf_batched(_t(bb), _t(sb), 0.3)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---------------------------------------------------------------- RPN box math

def test_make_anchors_and_apply_deltas():
    np.testing.assert_array_equal(tex.make_anchors(3, 5, scales=(2, 4)),
                                  jex.make_anchors(3, 5, scales=(2, 4)))
    rng = np.random.default_rng(3)
    anchors = jex.make_anchors(4, 4)
    deltas = rng.normal(size=anchors.shape).astype(np.float32) * 3
    deltas[:5, 2:] = [[4.2, 5.0], [4.135, 4.1], [-11, -10], [30, 0.0], [-30, 9]]  # the clip
    weights = (10.0, 10.0, 5.0, 5.0)
    for w in ((1.0, 1.0, 1.0, 1.0), weights):
        want = jex.apply_deltas(jnp.asarray(anchors), jnp.asarray(deltas), w)
        _close(tex.apply_deltas(_t(anchors), _t(deltas), w), want, 1e-6)


# ---------------------------------------------------------------- the extractor

def _same_detections(got, want):
    """Boxes (so the kept rows and their order), scores and features. The
    proposals are decoded from RPN deltas that went through 16
    bottlenecks, so they carry the features' relative error."""
    _close(got["boxes"], want["boxes"], FEAT_RTOL)
    np.testing.assert_allclose(got["scores"], want["scores"], rtol=0, atol=1e-5)
    _close(got["features"], want["features"], FEAT_RTOL)


def test_extractor_given_boxes(extractors):
    jx, tx = extractors
    img = _image(np.random.default_rng(7), 100, 131)
    boxes = np.array([[0, 0, 131, 100], [10, 10, 40, 40], [3, 30, 120, 95], [50, 2, 51, 3]],
                     np.float32)
    want, got = jx.extract_feature(img, boxes), tx.extract_feature(img, boxes)
    assert got["features"].shape == (4, 2048) and got["scores"].shape == (4, 11)
    _same_detections(got, want)


def test_extractor_proposal_and_batch_paths(extractors):
    """The proposal path keeps the same rows as the JAX package's (boxes,
    order, scores, features), and the batch path equals both on images
    that share a padded shape."""
    jx, tx = extractors
    rng = np.random.default_rng(8)
    imgs = [_image(rng, 120, 150), _image(rng, 118, 150)]
    singles = [tx.extract_feature(img) for img in imgs]
    assert all(3 <= len(s["boxes"]) <= 6 for s in singles)
    _same_detections(singles[0], jx.extract_feature(imgs[0]))
    got_b, want_b = tx.extract_feature_batch(imgs), jx.extract_feature_batch(imgs)
    for g, w, s in zip(got_b, want_b, singles):
        _same_detections(g, w)
        _same_detections(g, s)


def test_extractor_keep_regimes(extractors):
    """max_conf in every regime of the 10..50 rule (here 3..6): _keep_indices
    and _batch_keep are the JAX package's host code."""
    jx, tx = extractors
    rng = np.random.default_rng(9)
    for n_above in (0, 1, 4, 6, 9):
        max_conf = rng.uniform(0.0, 0.2, 24).astype(np.float32)
        max_conf[rng.choice(24, n_above, replace=False)] = rng.uniform(0.3, 1.0, n_above)
        np.testing.assert_array_equal(tx._keep_indices(max_conf), jx._keep_indices(max_conf))
        sel = np.argsort(-max_conf, kind="stable")[:6]
        cnt = int((max_conf >= 0.25).sum())
        g, w = tx._batch_keep(cnt, sel), jx._batch_keep(cnt, sel)
        assert g[0] == w[0]
        np.testing.assert_array_equal(g[1], w[1])


# ---------------------------------------------------------------- weights

def test_load_detector_weights_matches_jax(tmp_path):
    sd = detector_state_dict(4)
    path = str(tmp_path / "det.pth")
    torch.save({"model": {k: torch.from_numpy(v) for k, v in sd.items()}}, path)
    jp = jax_detector_params(0, num_anchors=12, **SMALL)
    want, want_report = jax_load_detector_weights(path, jp)
    got, report = load_detector_weights(path, extractor_params_from_jax(jp))
    assert report == want_report and not [r for r in report if "mismatch" in r]
    flat_w = jax.tree_util.tree_leaves(extractor_params_from_jax(
        jax.tree_util.tree_map(np.asarray, want)))
    flat_g = jax.tree_util.tree_leaves(got)
    assert len(flat_g) == len(flat_w)
    for g, w in zip(flat_g, flat_w):
        np.testing.assert_array_equal(g.numpy(), w.numpy())
    # the folded stem equals conv2d + eval batch_norm on the raw state dict
    x = torch.from_numpy(np.random.default_rng(1).normal(size=(1, 3, 9, 9)).astype(np.float32))
    ref = torch.nn.functional.batch_norm(
        torch.nn.functional.conv2d(x, _t(sd["backbone.stem.conv1.weight"]), padding=3),
        _t(sd["backbone.stem.conv1.norm.running_mean"]),
        _t(sd["backbone.stem.conv1.norm.running_var"]),
        _t(sd["backbone.stem.conv1.norm.weight"]), _t(sd["backbone.stem.conv1.norm.bias"]),
        training=False, eps=1e-5)
    ours = tres.frozen_bn(tres.conv(x.permute(0, 2, 3, 1), got["resnet"]["stem"]["conv1"],
                                    dtype=torch.float32), got["resnet"]["stem"]["bn1"])
    _close(ours.permute(0, 3, 1, 2), ref.numpy(), 1e-5)


def test_extractor_params_from_jax_layouts(det_params):
    jp, tp = det_params
    np.testing.assert_array_equal(tp["resnet"]["res3"][0]["conv2"].numpy(),
                                  np.asarray(jp["resnet"]["res3"][0]["conv2"]).transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(tp["cls_score"].numpy(), np.asarray(jp["cls_score"]).T)
    np.testing.assert_array_equal(tp["rpn_delta_bias"].numpy(), np.asarray(jp["rpn_delta_bias"]))
    assert len(tp["resnet"]["res4"]) == 6 and tp["rpn_obj"].shape == (12, 32, 1, 1)
