"""VCG dataset preparation: ``python -m kmbart_tpu_torch.scripts.prepare_vcg``.

Twin of scripts/prepare_vcg.py (the reference's scripts/prepare_vcg.py:
17-187): build ``{split}.json`` (one row per (image, task, label)),
``{split}_eval.json`` (one row per (image, task)), ``{split}_ref.json``
(reference lists by index), and, with ``--data_dir``, the per-image feature
pickles (the whole-image box and the metadata boxes through the detector's
given-boxes path, on ``--device``).
"""

import argparse
import json
import os
import warnings

import numpy as np

from kmbart_tpu_torch.scripts.prep_common import (add_shard_args, dump_json,
                                                  extract_features_loop, print_segment_line,
                                                  read_image)


def get_img_id(annot):
    img_id = os.path.basename(annot["img_fn"])
    return img_id[: img_id.rfind(".")]


def image_data(annot, image, metadata, extractor):
    """The pickle of one image: features of the whole-image box and the
    metadata boxes, from the BGR ``image`` array."""
    boxes = np.array(metadata["boxes"])[:, :4]
    h, w = metadata["height"], metadata["width"]
    boxes = np.vstack((np.array([0, 0, w, h]), boxes))
    features = extractor.extract_feature(image, boxes)
    return {
        "__img_id__": get_img_id(annot),
        "image_features": features["features"],
        "mrm_labels": features["scores"],
        "boxes": features["boxes"],
    }


def get_image_data(annot, args, extractor):
    im = read_image(os.path.join(args.data_dir, annot["img_fn"]))
    with open(os.path.join(args.data_dir, annot["metadata_fn"])) as f:
        metadata = json.load(f)
    return image_data(annot, im, metadata, extractor)


def get_text_data(annot, index):
    data = []
    base = {"event": annot["event"], "img_id": get_img_id(annot),
            "img_fn": annot["img_fn"], "index": index}
    if annot["split"] == "test":
        data.append(base)
    else:
        for task in ("intent", "before", "after"):
            for label in annot[task]:
                data.append({**base, "task_type": task, "labels": label})
    return data


def get_eval_data(annot, index):
    base = {"event": annot["event"], "img_id": get_img_id(annot),
            "img_fn": annot["img_fn"], "index": index}
    if annot["split"] == "test":
        return [base]
    return [{**base, "task_type": t} for t in ("intent", "after", "before")]


def get_reference_data(annot):
    return [{"intent": annot.get("intent"), "before": annot.get("before"),
             "after": annot.get("after")}]


def parse_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--data_dir", type=str, default=None,
                        help="VCR dataset directory. None for not generating image features")
    parser.add_argument("--output_dir", type=str, required=True)
    parser.add_argument("--annot_dir", type=str, required=True,
                        help='VCG annotation directory with "val_annots.json", '
                             '"train_annots.json" and "test_annots.json"')
    add_shard_args(parser)
    return parser.parse_args(argv)


def main(args):
    warnings.filterwarnings("ignore")
    split_dict = {}
    for split in ("train", "val", "test"):
        with open(os.path.join(args.annot_dir, f"{split}_annots.json")) as f:
            split_dict[split] = json.load(f)
        os.makedirs(os.path.join(args.output_dir, split), exist_ok=True)

    print_segment_line("processing training data")
    for split, annots in split_dict.items():
        data = []
        for index, annot in enumerate(annots):
            data += get_text_data(annot, index)
        dump_json(data, args.output_dir, split + ".json")

    print_segment_line("processing evaluation data")
    for split, annots in split_dict.items():
        data = []
        for index, annot in enumerate(annots):
            data += get_eval_data(annot, index)
        dump_json(data, args.output_dir, split + "_eval.json")

    print_segment_line("processing reference data")
    for split, annots in split_dict.items():
        if split != "test":
            data = []
            for annot in annots:
                data += get_reference_data(annot)
            dump_json(data, args.output_dir, split + "_ref.json")

    if args.data_dir is not None:
        for split, annots in split_dict.items():
            print_segment_line(f"extracting image features for {split} set")
            extract_features_loop(annots, split, args, get_image_data)


if __name__ == "__main__":
    main(parse_args())
