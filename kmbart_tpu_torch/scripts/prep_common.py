"""Shared helpers for the port's data-preparation CLIs.

Twin of scripts/prep_common.py: the shard-strided per-image feature loop
that writes one pickle per image, the extractor build (a detectron2-schema
config and detector weights), the SBU/CC caption cleaning, and the CLI
flags. One process drives the card's extractor; hosts split the data with
``--num_shards/--shard`` (the reference's ``data[rank::gpu_num]``). The
image download of the root module needs the network and is left out.
"""

import json
import os
import pickle
import re
import sys
from datetime import datetime

import torch


def print_segment_line(info=""):
    sys.stderr.flush()
    print((" " + info.strip() + " ").center(50, "="), flush=True)


def clean_caption(cap, strip_at=False):
    """SBU/CC caption cleaning (scripts/prepare_sbu.py:26-34)."""
    new_cap = cap
    new_cap = new_cap.replace(r"&amp;", " ").replace(r"quot;", " ").replace("amp;", " ")
    new_cap = re.sub(r"\([^>]+?\)", "", new_cap)     # remove (...) blocks
    new_cap = re.sub(r"\.+", ".", new_cap)           # redundant dots
    if strip_at:
        new_cap = new_cap.split("@")[0]
    new_cap = re.sub(r"[^\S\n\t]+", " ", new_cap)    # redundant spacing
    return new_cap.strip()


def build_extractor(args):
    """The port's FeatureExtractor on ``--device``: from ``--config`` (the
    reference's detectron2-schema YAML) when given, with random weights
    from seed 0 and the config's MODEL.WEIGHTS when that file exists; then
    ``--detector_weights``, when given, laid over them instead."""
    from kmbart_tpu_torch.vision.extractor import FeatureExtractor, params_to
    from kmbart_tpu_torch.vision.import_weights import load_detector_weights

    device = getattr(args, "device", "cuda")
    generator = torch.Generator().manual_seed(0)
    config = getattr(args, "config", None)
    weights = getattr(args, "detector_weights", None)
    if config:
        ex = FeatureExtractor.from_config(config, generator=generator,
                                          load_weights=not weights, device=device)
    else:
        ex = FeatureExtractor(generator=generator, device=device)
    if weights:
        params, report = load_detector_weights(weights, ex.params)
        ex.params = params_to(params, ex.device)
        for line in report:
            print(line, flush=True)
    return ex


def extract_features_loop(data, split, args, get_image_data, extractor=None):
    """Shard-strided per-image feature extraction with ETA logging: each
    entry's ``get_image_data(entry, args, extractor)`` dict is pickled to
    ``{output_dir}/{split}/{__img_id__}.pkl``. The extractor is built from
    ``args`` unless one is passed."""
    if extractor is None:
        extractor = build_extractor(args)
    shard, num_shards = args.shard, args.num_shards
    local_data = data[shard::num_shards]
    start_time = datetime.now()
    for i, entry in enumerate(local_data):
        out = get_image_data(entry, args, extractor)
        img_id = out.pop("__img_id__")
        with open(os.path.join(args.output_dir, split, str(img_id) + ".pkl"), "wb") as f:
            pickle.dump(out, f)
        print("shard{}, {}/{}, ETA: {}".format(
            shard, i, len(local_data),
            str((len(local_data) - (i + 1)) / (i + 1) * (datetime.now() - start_time))),
            flush=True)


def add_shard_args(parser):
    parser.add_argument("--num_shards", default=1, type=int,
                        help="total feature-extraction shards (hosts)")
    parser.add_argument("--shard", default=0, type=int, help="this host's shard index")
    parser.add_argument("--detector_weights", default=None, type=str,
                        help="detector checkpoint (.pth state dict) for the extractor")
    parser.add_argument("--config", default=None, type=str,
                        help="detectron2-schema extractor config YAML "
                             "(config/extract_config.yaml)")
    parser.add_argument("--device", default="cuda", type=str,
                        help="torch device to run on (cuda, cuda:N or cpu)")
    parser.add_argument("--cpu", dest="device", action="store_const", const="cpu",
                        help="run on host CPU (the same as --device cpu)")


def dump_json(obj, *path):
    with open(os.path.join(*path), "w") as f:
        json.dump(obj, f)
