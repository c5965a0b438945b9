"""SBU captions preparation: ``python -m kmbart_tpu_torch.scripts.prepare_sbu``.

Twin of scripts/prepare_sbu.py (the reference's scripts/prepare_sbu.py:
25-203): download on a thread pool, delete the corrupt files, build the
index of the images that decode (captions cleaned), split it into train
and val by ``--train_ratio``, and, unless ``--no_img_feat``, extract
features through the detector's proposal path on ``--device``.
"""

import argparse
import os
import warnings
from concurrent.futures import ThreadPoolExecutor
from datetime import datetime

from kmbart_tpu_torch.scripts.prep_common import (add_shard_args, clean_caption,
                                                  delete_invalid, download_image, dump_json,
                                                  extract_features_loop, print_segment_line,
                                                  read_image)

CAPTION_KEY = "labels"
STRIP_AT = False


def build_index(index, caption, data_dir):
    img = read_image(os.path.join(data_dir, str(index) + ".jpg"))
    if img is not None:
        return {"img_id": index, "img_fn": str(index) + ".jpg",
                "width": img.shape[1], "height": img.shape[0],
                CAPTION_KEY: clean_caption(caption, strip_at=STRIP_AT)}
    return None


def image_data(entry, image, extractor):
    """The pickle of one image: the proposal path's features, detector
    class probabilities and boxes, from the BGR ``image`` array."""
    features = extractor.extract_feature(image)
    return {
        "__img_id__": str(entry["img_id"]),
        "image_features": features["features"],
        "mrm_labels": features["scores"],
        "boxes": features["boxes"],
    }


def get_image_data(entry, args, extractor):
    return image_data(entry, read_image(os.path.join(args.data_dir, entry["img_fn"])),
                      extractor)


def parse_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--download", action="store_true")
    parser.add_argument("--data_dir", type=str, default=None)
    parser.add_argument("--no_img_feat", action="store_true")
    parser.add_argument("--output_dir", type=str, required=True)
    parser.add_argument("--annot_dir", type=str, required=True,
                        help='with "SBU_captioned_photo_dataset_captions.txt" '
                             'and "SBU_captioned_photo_dataset_urls.txt"')
    parser.add_argument("--max_index", type=int, default=-1)
    parser.add_argument("--n_jobs", type=int, default=4)
    parser.add_argument("--train_ratio", type=float, default=0.9)
    parser.add_argument("--delete_invalid", action="store_true")
    add_shard_args(parser)
    args = parser.parse_args(argv)
    if args.download and args.data_dir is None:
        raise ValueError("if --download is set, --data_dir must be specified")
    return args


def run(args, captions, urls):
    start = datetime.now()
    if args.download:
        with ThreadPoolExecutor(args.n_jobs) as pool:
            list(pool.map(lambda iu: download_image(iu[0], iu[1], args.data_dir),
                          enumerate(urls[: args.max_index])))
    if args.delete_invalid:
        with ThreadPoolExecutor(args.n_jobs) as pool:
            list(pool.map(lambda i: delete_invalid(i, args.data_dir),
                          range(len(urls[: args.max_index]))))
        print_segment_line("Download complete in: " + str(datetime.now() - start))

    start = datetime.now()
    with ThreadPoolExecutor(args.n_jobs) as pool:
        raw = list(pool.map(lambda ic: build_index(ic[0], ic[1], args.data_dir),
                            enumerate(captions[: args.max_index])))
    raw = [x for x in raw if x is not None]

    split_index = int(len(raw) * args.train_ratio)
    split_dict = {"train": raw[:split_index], "val": raw[split_index:]}
    for split, data in split_dict.items():
        dump_json(data, args.output_dir, split + ".json")
        os.makedirs(os.path.join(args.output_dir, split), exist_ok=True)
    print_segment_line("Build index complete in: " + str(datetime.now() - start))

    if not args.no_img_feat:
        for split, data in split_dict.items():
            print_segment_line(f"extracting image features for {split} set")
            extract_features_loop(data, split, args, get_image_data)


def main(args):
    warnings.filterwarnings("ignore")
    with open(os.path.join(args.annot_dir, "SBU_captioned_photo_dataset_captions.txt")) as f:
        captions = f.readlines()
    with open(os.path.join(args.annot_dir, "SBU_captioned_photo_dataset_urls.txt")) as f:
        urls = f.readlines()
    run(args, captions, urls)


if __name__ == "__main__":
    main(parse_args())
