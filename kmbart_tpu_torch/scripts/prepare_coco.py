"""COCO captions preparation: ``python -m kmbart_tpu_torch.scripts.prepare_coco``.

Twin of scripts/prepare_coco.py (the reference's scripts/prepare_coco.py:
17-198): merge the captions and instances annotations into per-image
entries (boxes converted from xywh to xyxy), write ``{split}.json``,
``{split}_eval.json`` and ``{split}_ref.json``, and, for each split given
an image directory, the per-image feature pickles: the instance boxes and
the whole-image box through the detector's given-boxes path, on
``--device``.
"""

import argparse
import json
import os
import warnings

import numpy as np

from kmbart_tpu_torch.scripts.prep_common import (add_shard_args, dump_json,
                                                  extract_features_loop, print_segment_line,
                                                  read_image)


def extract_data(captions, instances):
    data = {}
    for img in captions["images"]:
        data[img["id"]] = {"img_id": img["id"], "img_fn": img["file_name"],
                           "width": img["width"], "height": img["height"]}
    for cap in captions["annotations"]:
        entry = data[cap["image_id"]]
        entry.setdefault("caption", []).append(cap["caption"])
    for ins in instances["annotations"]:
        entry = data[ins["image_id"]]
        boxes = list(ins["bbox"])
        boxes[2] += boxes[0]
        boxes[3] += boxes[1]
        entry.setdefault("boxes", []).append(boxes)
    for key in list(data.keys()):
        if "caption" not in data[key]:
            data[key]["caption"] = ""
    return data


def get_text_data(entry, index):
    base = {"img_id": str(entry["img_id"]), "img_fn": entry["img_fn"],
            "index": index, "task_type": "caption"}
    return [{**base, "labels": c} for c in entry["caption"]]


def get_eval_data(entry, index):
    return [{"img_id": str(entry["img_id"]), "img_fn": entry["img_fn"],
             "index": index, "task_type": "caption"}]


def get_reference_data(entry):
    return [{"caption": entry["caption"], "img_id": str(entry["img_id"])}]


def image_data(entry, image, extractor):
    """The pickle of one image: features of the instance boxes and the
    whole-image box (last), from the BGR ``image`` array."""
    h, w = entry["height"], entry["width"]
    whole = np.array([0, 0, w, h])
    if "boxes" in entry:
        boxes = np.vstack((np.array(entry["boxes"]), whole))
    else:
        boxes = whole[None]
    features = extractor.extract_feature(image, boxes)
    return {
        "__img_id__": str(entry["img_id"]),
        "image_features": features["features"],
        "mrm_labels": features["scores"],
        "boxes": features["boxes"],
    }


def get_image_data(entry, args, extractor):
    return image_data(entry, read_image(os.path.join(args._cur_image_dir, entry["img_fn"])),
                      extractor)


def parse_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--train_dir", type=str, default=None,
                        help="path for training images (train2014)")
    parser.add_argument("--val_dir", type=str, default=None,
                        help="path for validation images (val2014)")
    parser.add_argument("--output_dir", type=str, required=True)
    parser.add_argument("--annot_dir", type=str, required=True)
    add_shard_args(parser)
    return parser.parse_args(argv)


def main(args):
    warnings.filterwarnings("ignore")

    def load(name):
        with open(os.path.join(args.annot_dir, name)) as f:
            return json.load(f)

    print_segment_line("extracting training annotations")
    train_data = extract_data(captions=load("captions_train2014.json"),
                              instances=load("instances_train2014.json"))
    print_segment_line("extracting validation annotations")
    val_data = extract_data(captions=load("captions_val2014.json"),
                            instances=load("instances_val2014.json"))

    split_dict = {"train": (train_data, args.train_dir), "val": (val_data, args.val_dir)}
    for split in split_dict:
        os.makedirs(os.path.join(args.output_dir, split), exist_ok=True)

    print_segment_line("generating textual and reference data")
    for split, (data, _) in split_dict.items():
        text_data, eval_data, ref_data = [], [], []
        for index, entry in enumerate(data.values()):
            text_data += get_text_data(entry, index)
            eval_data += get_eval_data(entry, index)
            ref_data += get_reference_data(entry)
        dump_json(text_data, args.output_dir, split + ".json")
        dump_json(eval_data, args.output_dir, split + "_eval.json")
        dump_json(ref_data, args.output_dir, split + "_ref.json")

    for split, (data, image_dir) in split_dict.items():
        if image_dir is not None:
            print_segment_line(f"extracting image features for {split} set")
            args._cur_image_dir = image_dir
            extract_features_loop(list(data.values()), split, args, get_image_data)


if __name__ == "__main__":
    main(parse_args())
