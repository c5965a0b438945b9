"""Packed ROI-feature cache: one memory-mapped block per split.

The reference reads one pickle per image per __getitem__
(src/data/dataset.py:42-47) — fine on a local SSD, hostile at TPU-pod scale
(per-item open/unpickle on the host is the input-bound path). This packs a
split's features into contiguous float32 blocks:

  {split}.features.npy  [total_rows, feat]   (2048-d feature (+) 4-d box)
  {split}.scores.npy    [total_rows, C]      (detector soft labels)
  {split}.index.json    {img_id: [offset, count]}

Reads are np.memmap + the C++ ``gather_pad_rows`` batch assembler
(native/kmbart_native.cpp) with a numpy fallback.
"""

import json
import os
import pickle

import numpy as np

from kmbart_tpu_torch import _native


def pack_split(data_dir, split, out_dir=None):
    """Convert a directory of per-image pickles into the packed layout."""
    out_dir = out_dir or data_dir
    src_dir = os.path.join(data_dir, split)
    feats, scores, index = [], [], {}
    offset = 0
    for fname in sorted(os.listdir(src_dir)):
        if not fname.endswith(".pkl"):
            continue
        img_id = fname[:-4]
        with open(os.path.join(src_dir, fname), "rb") as f:
            data = pickle.load(f)
        block = np.concatenate(
            [np.asarray(data["image_features"], np.float32),
             np.asarray(data["boxes"], np.float32)], axis=1)
        feats.append(block)
        if "mrm_labels" in data:
            scores.append(np.asarray(data["mrm_labels"], np.float32))
        index[img_id] = [offset, len(block)]
        offset += len(block)
    features = np.concatenate(feats) if feats else np.zeros((0, 0), np.float32)
    np.save(os.path.join(out_dir, f"{split}.features.npy"), features)
    if scores:
        np.save(os.path.join(out_dir, f"{split}.scores.npy"),
                np.concatenate(scores))
    with open(os.path.join(out_dir, f"{split}.index.json"), "w") as f:
        json.dump(index, f)
    return index


class FeatureCache:
    def __init__(self, data_dir, split):
        self._features = np.load(
            os.path.join(data_dir, f"{split}.features.npy"), mmap_mode="r")
        scores_path = os.path.join(data_dir, f"{split}.scores.npy")
        self._scores = (np.load(scores_path, mmap_mode="r")
                        if os.path.exists(scores_path) else None)
        with open(os.path.join(data_dir, f"{split}.index.json")) as f:
            self._index = json.load(f)

    def __contains__(self, img_id):
        return str(img_id) in self._index

    def get(self, img_id):
        """Single example: (features [n, feat], scores [n, C] or None)."""
        offset, count = self._index[str(img_id)]
        feats = np.asarray(self._features[offset:offset + count])
        scores = (np.asarray(self._scores[offset:offset + count])
                  if self._scores is not None else None)
        return feats, scores

    def gather_batch(self, img_ids, max_rows):
        """Fixed-shape batch: (features [B, max_rows, feat] zero-padded,
        counts [B]). Uses the C++ assembler when built."""
        entries = [self._index[str(i)] for i in img_ids]
        offsets = np.asarray([e[0] for e in entries], np.int64)
        counts = np.asarray([e[1] for e in entries], np.int32)
        if _native.available():
            # pass the memmap straight through: same dtype + C-order means
            # no copy, the native kernel reads out of the page cache
            out = _native.gather_pad_rows(self._features, offsets, counts,
                                          max_rows)
        else:
            B = len(img_ids)
            feat = self._features.shape[1]
            out = np.zeros((B, max_rows, feat), np.float32)
            for b, (o, c) in enumerate(zip(offsets, counts)):
                c = min(c, max_rows)
                out[b, :c] = self._features[o:o + c]
        return out, np.minimum(counts, max_rows)
