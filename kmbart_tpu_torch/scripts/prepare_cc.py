"""Conceptual Captions preparation: ``python -m kmbart_tpu_torch.scripts.prepare_cc``.

Twin of scripts/prepare_cc.py (the reference's scripts/prepare_cc.py:
25-222): the TSV annotations (caption, tab, url) of train and validation,
an optional download into per-split directories on a thread pool (with
``--delete_invalid``), the index of the images that decode (captions
cleaned, the @-suffix stripped), and, unless ``--no_img_feat``, the
detector's proposal path on ``--device``; ``--skip_generated`` makes the
extraction resumable.
"""

import argparse
import os
import pickle
import warnings
from concurrent.futures import ThreadPoolExecutor
from datetime import datetime

from kmbart_tpu_torch.scripts.prep_common import (add_shard_args, build_extractor,
                                                  clean_caption, delete_invalid,
                                                  download_image, dump_json,
                                                  print_segment_line, read_image)


def build_index(index, caption, data_dir):
    img = read_image(os.path.join(data_dir, str(index) + ".jpg"))
    if img is not None:
        return {"img_id": index, "img_fn": str(index) + ".jpg",
                "width": img.shape[1], "height": img.shape[0],
                "labels": clean_caption(caption, strip_at=True)}
    return None


def image_data(image, extractor):
    """The pickle of one image: the proposal path's features, detector
    class probabilities and boxes, from the BGR ``image`` array."""
    features = extractor.extract_feature(image)
    return {"image_features": features["features"],
            "mrm_labels": features["scores"],
            "boxes": features["boxes"]}


def get_image_data(entry, data_dir, extractor):
    return image_data(read_image(os.path.join(data_dir, entry["img_fn"])), extractor)


def extract_split(data, split, args, extractor=None):
    """Per-image features of this shard's entries; with ``--skip_generated``
    an entry whose pickle exists is skipped (prepare_cc.py:93-114)."""
    if extractor is None:
        extractor = build_extractor(args)
    data_dir = os.path.join(args.data_dir, split)
    local = data[args.shard::args.num_shards]
    start_time = datetime.now()
    for i, entry in enumerate(local):
        save_path = os.path.join(args.output_dir, split, str(entry["img_id"]) + ".pkl")
        if os.path.isfile(save_path) and args.skip_generated:
            continue
        out = get_image_data(entry, data_dir, extractor)
        with open(save_path, "wb") as f:
            pickle.dump(out, f)
        print("shard{}, {}/{}, ETA: {}".format(
            args.shard, i, len(local),
            str((len(local) - (i + 1)) / (i + 1) * (datetime.now() - start_time))), flush=True)


def parse_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--download", action="store_true")
    parser.add_argument("--data_dir", type=str, default=None)
    parser.add_argument("--no_img_feat", action="store_true")
    parser.add_argument("--output_dir", type=str, required=True)
    parser.add_argument("--annot_dir", type=str, required=True,
                        help='with "Train_GCC-training.tsv" and '
                             '"Validation_GCC-1.1.0-Validation.tsv"')
    parser.add_argument("--max_index", type=int, default=-1)
    parser.add_argument("--n_jobs", type=int, default=4)
    parser.add_argument("--skip_generated", action="store_true")
    parser.add_argument("--delete_invalid", action="store_true")
    add_shard_args(parser)
    return parser.parse_args(argv)


def main(args):
    warnings.filterwarnings("ignore")

    def load(name):
        with open(os.path.join(args.annot_dir, name)) as f:
            return [[x.strip() for x in line.split("\t")] for line in f]

    split_dict = {"train": load("Train_GCC-training.tsv"),
                  "val": load("Validation_GCC-1.1.0-Validation.tsv")}
    for split in split_dict:
        if args.data_dir:
            os.makedirs(os.path.join(args.data_dir, split), exist_ok=True)
        os.makedirs(os.path.join(args.output_dir, split), exist_ok=True)

    if args.download:
        for split, rows in split_dict.items():
            path = os.path.join(args.data_dir, split)
            with ThreadPoolExecutor(args.n_jobs) as pool:
                list(pool.map(lambda ir: download_image(ir[0], ir[1][1], path),
                              enumerate(rows[: args.max_index])))
            if args.delete_invalid:
                with ThreadPoolExecutor(args.n_jobs) as pool:
                    list(pool.map(lambda i: delete_invalid(i, path),
                                  range(len(rows[: args.max_index]))))

    index_dict = {}
    for split, rows in split_dict.items():
        path = os.path.join(args.data_dir, split)
        with ThreadPoolExecutor(args.n_jobs) as pool:
            raw = list(pool.map(lambda ir: build_index(ir[0], ir[1][0], path),
                                enumerate(rows[: args.max_index])))
        index_dict[split] = [x for x in raw if x is not None]
        dump_json(index_dict[split], args.output_dir, split + ".json")

    if not args.no_img_feat:
        for split, data in index_dict.items():
            print_segment_line(f"extracting image features for {split} set")
            extract_split(data, split, args)


if __name__ == "__main__":
    main(parse_args())
