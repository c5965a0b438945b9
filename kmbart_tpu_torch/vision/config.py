"""Detector config surface: detectron2-schema YAML -> extractor settings.

Parity target: ``config/extract_config.yaml`` in the reference (consumed by
detectron2's ``get_cfg().merge_from_file`` in scripts/feature_extractor.py).
The same YAML schema is accepted here, so a user can point the prepare CLIs
at the reference's own config file unchanged. Only the keys the TPU
extractor acts on are read; unknown keys are ignored (detectron2 semantics
for OUR defaults, minus training-only settings).
"""

import ast

DEFAULT_CONFIG_PATH = None  # resolved lazily relative to the repo root


def _get(d, path, default=None):
    cur = d
    for key in path.split("."):
        if not isinstance(cur, dict) or key not in cur:
            return default
        cur = cur[key]
    return cur


def _tuple(value, default):
    """detectron2 YAMLs write tuples as Python-literal strings."""
    if value is None:
        return default
    if isinstance(value, str):
        value = ast.literal_eval(value)
    return tuple(value)


def load_extract_config(path):
    """Parse a detectron2-style extract config YAML.

    Returns a dict with:
      - ``extractor``: kwargs for ``FeatureExtractor`` (thresholds, box
        budget, NMS settings, class/attribute counts, anchor scales,
        bbox-regression weights, resnet depth);
      - ``input``: {'min_size', 'max_size', 'pixel_mean'} for
        ``get_image_blob`` preprocessing;
      - ``weights``: the detector checkpoint path (MODEL.WEIGHTS).
    """
    import yaml

    with open(path) as f:
        raw = yaml.safe_load(f) or {}

    sizes = _get(raw, "MODEL.ANCHOR_GENERATOR.SIZES")
    anchor_scales = tuple(sizes[0]) if sizes else (4, 8, 16, 32)
    extractor = dict(
        num_classes=_get(raw, "MODEL.ROI_HEADS.NUM_CLASSES", 1601),
        num_attributes=_get(raw, "MODEL.BUA.ATTRIBUTE.NUM_CLASSES", 401),
        rpn_channels=_get(raw, "MODEL.BUA.RPN.CONV_OUT_CHANNELS", 512),
        depth=_get(raw, "MODEL.RESNETS.DEPTH", 101),
        min_boxes=_get(raw, "MODEL.BUA.EXTRACTOR.MIN_BOXES", 10),
        max_boxes=_get(raw, "MODEL.BUA.EXTRACTOR.MAX_BOXES", 50),
        conf_thresh=_get(raw, "MODEL.BUA.EXTRACTOR.CONF_THRESH", 0.5),
        pre_nms_topk=_get(raw, "MODEL.RPN.PRE_NMS_TOPK_TEST", 6000),
        post_nms_topk=_get(raw, "MODEL.RPN.POST_NMS_TOPK_TEST", 300),
        rpn_nms_thresh=_get(raw, "MODEL.RPN.NMS_THRESH", 0.7),
        nms_thresh=_get(raw, "MODEL.ROI_HEADS.NMS_THRESH_TEST", 0.3),
        rpn_min_size=_get(raw, "MODEL.PROPOSAL_GENERATOR.MIN_SIZE", 16),
        anchor_scales=anchor_scales,
        bbox_reg_weights=_tuple(
            _get(raw, "MODEL.ROI_BOX_HEAD.BBOX_REG_WEIGHTS"),
            (1.0, 1.0, 1.0, 1.0)),
    )
    input_cfg = dict(
        min_size=_get(raw, "INPUT.MIN_SIZE_TEST", 600),
        max_size=_get(raw, "INPUT.MAX_SIZE_TEST", 1000),
        pixel_mean=_get(raw, "MODEL.PIXEL_MEAN",
                        [102.9801, 115.9465, 122.7717]),
    )
    return {
        "extractor": extractor,
        "input": input_cfg,
        "weights": _get(raw, "MODEL.WEIGHTS"),
    }
