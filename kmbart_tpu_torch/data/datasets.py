"""Dataset readers for the KM-BART data layout (JSON index + per-image pickle).

Parity target: src/data/dataset.py:24-214 — COCODataset (pickle of
image_features/boxes/mrm_labels, 2048-d feature (+) 4-d box -> 2052-d),
VCGDataset (event handling, pretrain-as-caption mode, ``*_eval.json`` in
eval mode), SBUDataset/CCDataset (caption strip), VGDataset (whole-image +
object + region features, attribute/relation ids, region captions),
ReasonDataset (COMET-generated events, returns None on missing pickles so
the collator can drop them), plus a ConcatDataset.

No torch: plain sequence protocol (__getitem__/__len__); the loader in
data/loader.py handles batching/sharding/prefetch.
"""

import bisect
import json
import os
import pickle

import numpy as np

from kmbart_tpu_torch.utils.task import TaskType


class COCODataset:
    def __init__(self, data_dir, image_dir=None, split="train", eval_mode=False,
                 use_image=True, use_feature_cache="auto"):
        """``use_feature_cache``: read ROI features from the packed
        memory-mapped cache (data/feature_cache.py) instead of per-image
        pickles — "auto" uses it when ``{split}.features.npy`` exists."""
        self._use_image = use_image
        self._data_dir = data_dir
        self._image_dir = data_dir if image_dir is None else image_dir
        self._split = split
        file_name = split + ("_eval.json" if eval_mode else ".json")
        with open(os.path.join(data_dir, file_name)) as f:
            self._dataset = json.load(f)
        self._cache = None
        if use_image and use_feature_cache in (True, "auto"):
            packed = os.path.join(self._image_dir, f"{split}.features.npy")
            if os.path.exists(packed) or use_feature_cache is True:
                from kmbart_tpu_torch.data.feature_cache import FeatureCache
                self._cache = FeatureCache(self._image_dir, split)

    def __getitem__(self, index):
        raw = self._dataset[index]
        output = {**raw}
        if self._use_image:
            if self._cache is not None and str(raw["img_id"]) in self._cache:
                feats, scores = self._cache.get(raw["img_id"])
                output["image_features"] = feats
                if scores is not None:
                    output["mrm_labels"] = scores
                return output
            path = os.path.join(self._image_dir, self._split,
                                str(raw["img_id"]) + ".pkl")
            with open(path, "rb") as f:
                image_data = pickle.load(f)
            output["image_features"] = np.concatenate(
                [image_data["image_features"], image_data["boxes"]],
                axis=1).astype(np.float32)
            if "mrm_labels" in image_data:
                output["mrm_labels"] = image_data["mrm_labels"]
        return output

    def __len__(self):
        return len(self._dataset)


class VCGDataset(COCODataset):
    def __init__(self, data_dir, image_dir=None, split="train", eval_mode=False,
                 use_image=True, use_event=True, pretrain=False,
                 use_feature_cache="auto"):
        super().__init__(data_dir=data_dir, image_dir=image_dir, split=split,
                         eval_mode=eval_mode, use_image=use_image,
                         use_feature_cache=use_feature_cache)
        self._use_event = use_event
        self._pretrain = pretrain

    def __getitem__(self, item):
        output = super().__getitem__(item)
        if not self._use_event:
            output["event"] = output["event"].split()[0]  # target person only
        if self._pretrain:
            output["labels"] = output["event"]
            del output["event"]
            output["task_type"] = TaskType.CAPTION
        return output


class SBUDataset(COCODataset):
    def __init__(self, data_dir, image_dir=None, split="train", use_image=True,
                 use_feature_cache="auto"):
        super().__init__(data_dir=data_dir, image_dir=image_dir, split=split,
                         eval_mode=False, use_image=use_image,
                         use_feature_cache=use_feature_cache)

    def __getitem__(self, item):
        output = super().__getitem__(item)
        output["task_type"] = TaskType.CAPTION
        output["labels"] = output["labels"].strip()
        return output


class CCDataset(SBUDataset):
    pass


class VGDataset:
    def __init__(self, data_dir, image_dir=None, split="train"):
        self._data_dir = data_dir
        self._image_dir = data_dir if image_dir is None else image_dir
        self._split = split
        with open(os.path.join(data_dir, split + ".json")) as f:
            self._dataset = json.load(f)
        with open(os.path.join(data_dir, split + "_region.json")) as f:
            self._region_dataset = json.load(f)

    def __len__(self):
        return len(self._region_dataset)

    def __getitem__(self, index):
        region_data = self._region_dataset[index]
        img_id = region_data["img_id"]
        region_id = region_data["region_id"]
        raw = self._dataset[str(img_id)]
        output = {**raw}

        path = os.path.join(self._image_dir, self._split,
                            str(raw["img_id"]) + ".pkl")
        with open(path, "rb") as f:
            image_data = pickle.load(f)

        region_index = image_data["region_ids"].index(region_id)
        region_feature = np.concatenate(
            [image_data["region_features"][region_index],
             image_data["region_boxes"][region_index]], axis=0)
        image_feature = np.concatenate(
            [image_data["image_feature"], image_data["image_box"]], axis=0)
        object_features = np.concatenate(
            [image_data["object_features"], image_data["object_boxes"]], axis=1)

        output["image_features"] = np.concatenate(
            [image_feature[np.newaxis, :], object_features,
             region_feature[np.newaxis, :]], axis=0)
        output["mrm_labels"] = np.concatenate(
            [image_data["image_score"][np.newaxis, :],
             image_data["object_scores"],
             image_data["region_scores"][region_index:region_index + 1]], axis=0)
        output["object_ids"] = image_data["object_ids"]
        output["task_type"] = TaskType.REGION_CAPTION
        output["labels"] = region_data["description"]
        return output


class ReasonDataset:
    def __init__(self, data_dir, image_dir=None, split="train", eval_mode=False,
                 use_image=True, use_event=True):
        self._use_image = use_image
        self._use_event = use_event
        self._data_dir = data_dir
        self._image_dir = data_dir if image_dir is None else image_dir
        self._split = split
        file_name = "reason_" + split + ("_eval.json" if eval_mode else ".json")
        with open(os.path.join(data_dir, file_name)) as f:
            self._dataset = json.load(f)

    def __getitem__(self, index):
        raw = self._dataset[index]
        output = {**raw}
        if not self._use_event:
            output["event"] = ""
        if self._use_image:
            try:
                path = os.path.join(self._image_dir, self._split,
                                    str(raw["img_id"]) + ".pkl")
                with open(path, "rb") as f:
                    image_data = pickle.load(f)
            except FileNotFoundError:
                return None
            output["image_features"] = np.concatenate(
                [image_data["image_features"], image_data["boxes"]],
                axis=1).astype(np.float32)
            if "mrm_labels" in image_data:
                output["mrm_labels"] = image_data["mrm_labels"]
        output["dataset_index"] = index
        return output

    def get_raw_data(self, index):
        return self._dataset[index]

    def __len__(self):
        return len(self._dataset)


class ConcatDataset:
    """Concatenation of datasets (torch.utils.data.ConcatDataset parity)."""

    def __init__(self, datasets):
        self.datasets = list(datasets)
        if not self.datasets:
            raise ValueError("datasets should not be empty")
        self.cumulative_sizes = []
        total = 0
        for d in self.datasets:
            total += len(d)
            self.cumulative_sizes.append(total)

    def __len__(self):
        return self.cumulative_sizes[-1]

    def __getitem__(self, idx):
        if idx < 0:
            idx += len(self)
        ds_idx = bisect.bisect_right(self.cumulative_sizes, idx)
        offset = 0 if ds_idx == 0 else self.cumulative_sizes[ds_idx - 1]
        return self.datasets[ds_idx][idx - offset]
