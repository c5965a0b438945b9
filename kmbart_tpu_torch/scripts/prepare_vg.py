"""Visual Genome preparation: ``python -m kmbart_tpu_torch.scripts.prepare_vg``.

Twin of scripts/prepare_vg.py (the reference's scripts/prepare_vg.py:
18-291): merge the image, attribute, region, relation and object
annotations into per-image entries, write the region JSONs, build the
top-128 attribute and relation vocabularies (unknown = the next id) from
the train split, attach the ids, and, with ``--image_dir``, extract the
regions, the objects and the whole image through the detector's
given-boxes path on ``--device``. Visual Genome gives a box's ``y`` at its
bottom edge, so a box is ``[x, y - h, x + w, y]``.
"""

import argparse
import json
import os
import warnings
from collections import Counter

import numpy as np

from kmbart_tpu_torch.scripts.prep_common import (add_shard_args, dump_json,
                                                  extract_features_loop, print_segment_line,
                                                  read_image)


def extract_relation_data(image_ids, attribute_data, relation_data, object_data, region_data):
    data = {i: {"img_id": i, "regions": [], "objects": {}, "relations": []}
            for i in image_ids}

    for entry in region_data:
        if entry["id"] in data:
            data[entry["id"]]["regions"] = [
                {"region_id": x["region_id"], "description": x["phrase"],
                 "x": x["x"], "y": x["y"], "h": x["height"], "w": x["width"]}
                for x in entry["regions"]]

    for entry in object_data:
        if entry["image_id"] in data:
            data[entry["image_id"]]["objects"] = {
                x["object_id"]: {"object_id": x["object_id"], "x": x["x"],
                                 "y": x["y"], "h": x["h"], "w": x["w"]}
                for x in entry["objects"]}

    for entry in attribute_data:
        if entry["image_id"] in data and "attributes" in entry:
            for x in entry["attributes"]:
                objs = data[entry["image_id"]]["objects"]
                if x["object_id"] in objs and "attributes" in x:
                    objs[x["object_id"]]["attributes"] = [
                        y.lower().strip() for y in x["attributes"]]

    for entry in relation_data:
        if entry["image_id"] in data:
            data[entry["image_id"]]["relations"] = [
                {"object_id": x["object"]["object_id"],
                 "subject_id": x["subject"]["object_id"],
                 "predicate": x["predicate"].lower().strip()}
                for x in entry["relationships"]]

    for entry in data.values():
        entry["objects"] = list(entry["objects"].values())
    return data


def extract_region_data(data, region_data):
    output = []
    for entry in region_data:
        if entry["id"] in data:
            output += [{"img_id": entry["id"], "region_id": x["region_id"],
                        "description": x["phrase"]} for x in entry["regions"]]
    return output


def get_image_dir(image_id, image_dirs):
    for image_dir in image_dirs:
        path = os.path.join(image_dir, str(image_id) + ".jpg")
        if os.path.isfile(path):
            return path
    raise FileNotFoundError("cannot find {}.jpg".format(image_id))


def image_data(entry, image, extractor):
    """The pickle of one image: the regions' features, the objects' and the
    whole image's, from the BGR ``image`` array."""
    regions, objects = entry["regions"], entry["objects"]
    boxes = np.array(
        [[r["x"], r["y"] - r["h"], r["x"] + r["w"], r["y"]] for r in regions] +
        [[o["x"], o["y"] - o["h"], o["x"] + o["w"], o["y"]] for o in objects] +
        [[0, 0, image.shape[1], image.shape[0]]])
    f = extractor.extract_feature(image, boxes)
    n_r = len(regions)
    return {
        "__img_id__": str(entry["img_id"]),
        "region_features": f["features"][:n_r],
        "region_scores": f["scores"][:n_r],
        "region_boxes": f["boxes"][:n_r],
        "region_ids": [r["region_id"] for r in regions],
        "object_features": f["features"][n_r:-1],
        "object_scores": f["scores"][n_r:-1],
        "object_boxes": f["boxes"][n_r:-1],
        "object_ids": [o["object_id"] for o in objects],
        "image_feature": f["features"][-1],
        "image_score": f["scores"][-1],
        "image_box": f["boxes"][-1],
    }


def get_image_data(entry, args, extractor):
    return image_data(entry, read_image(get_image_dir(entry["img_id"], args.image_dir)),
                      extractor)


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description="Extract the ROI pooled features from images")
    parser.add_argument("--output_dir", type=str, required=True)
    parser.add_argument("--annot_dir", type=str, required=True)
    parser.add_argument("--image_dir", nargs="*", type=str)
    parser.add_argument("--train_ratio", type=float, default=0.8)
    parser.add_argument("--num_relations", type=int, default=128)
    parser.add_argument("--num_attributes", type=int, default=128)
    add_shard_args(parser)
    return parser.parse_args(argv)


def main(args):
    warnings.filterwarnings("ignore")

    def load(name):
        with open(os.path.join(args.annot_dir, name)) as f:
            return json.load(f)

    print_segment_line("loading data")
    image_ids = [x["image_id"] for x in load("image_data.json")]
    attribute_data = load("attributes.json")
    region_data = load("region_descriptions.json")
    relation_data = load("relationships.json")
    object_data = load("objects.json")

    split_index = int(len(image_ids) * args.train_ratio)
    split_ids = {"train": image_ids[:split_index], "val": image_ids[split_index:]}

    print_segment_line("extracting data")
    split_data = {split: extract_relation_data(ids, attribute_data, relation_data,
                                               object_data, region_data)
                  for split, ids in split_ids.items()}
    for split, data in split_data.items():
        dump_json(extract_region_data(data, region_data), args.output_dir,
                  f"{split}_region.json")

    # attribute and relation vocabularies from the train split
    attribute_count, relation_count = [], []
    for entry in split_data["train"].values():
        for obj in entry["objects"]:
            attribute_count += obj.get("attributes", [])
        for rel in entry["relations"]:
            relation_count.append(rel["predicate"])
    attribute_top = Counter(attribute_count).most_common(args.num_attributes)
    relation_top = Counter(relation_count).most_common(args.num_relations)
    attribute2id = {w: i for i, (w, _) in enumerate(attribute_top)}
    relation2id = {w: i for i, (w, _) in enumerate(relation_top)}

    print_segment_line("saving attribute ids")
    dump_json(attribute2id, args.output_dir, "attribute2id.json")
    dump_json([w for w, _ in attribute_top], args.output_dir, "id2attribute.json")
    print_segment_line("saving relation ids")
    dump_json(relation2id, args.output_dir, "relation2id.json")
    dump_json([w for w, _ in relation_top], args.output_dir, "id2relation.json")

    for data in split_data.values():
        for entry in data.values():
            for obj in entry["objects"]:
                if "attributes" in obj:
                    obj["attribute_ids"] = [attribute2id.get(x, len(attribute2id))
                                            for x in obj["attributes"]]
            for rel in entry["relations"]:
                rel["predicate_id"] = relation2id.get(rel["predicate"], len(relation2id))

    print_segment_line("saving data")
    for split, data in split_data.items():
        dump_json(data, args.output_dir, f"{split}.json")
        os.makedirs(os.path.join(args.output_dir, split), exist_ok=True)

    if args.image_dir:
        for split, data in split_data.items():
            print_segment_line(f"processing image data for {split} set")
            extract_features_loop(list(data.values()), split, args, get_image_data)


if __name__ == "__main__":
    main(parse_args())
