"""Batch collation: ragged samples -> fixed-shape numpy device batches.

Parity target: ``Collator`` (src/data/collation.py:9-247):
  - per-item ROI truncation to ``max_img_num``; event/label token clipping;
  - the VCG pretraining swap (before/after/intent tasks move the event text
    into the <mlm> span, src/data/collation.py:86-89);
  - MLM 80/10/10 masking restricted to the <mlm> span (``_mask_tokens``);
  - MRM Bernoulli region masking: token -> <cls>, ROI feature zeroed except
    the trailing 4 bbox dims, detector soft labels kept for the masked slots
    (src/data/collation.py:113-132);
  - the label/decoder-input image-span copy so masked regions appear as
    <cls> on the decoder side too (src/data/collation.py:141-146);
  - attribute/relation label extraction from VG entries with the
    ``first <img> + 2`` object-position origin (src/data/collation.py:149-190);
  - label -100 masking of pad/<img>/</img>/<img_feat> positions.

TPU-first deltas (same numerics, static shapes):
  - every output is padded to a static bucket (``encoder_seq_len`` /
    ``decoder_seq_len`` / ``max_img_num`` / ``max_rel_count``) so the jitted
    train step never recompiles;
  - ragged per-example label lists become dense aligned tensors + masks:
    mrm_soft_labels [B,T,C] + mrm_mask, attribute_labels [B,T] +
    attribute_mask, relation_pairs [B,R,2] + relation_labels + relation_mask
    (loss functions in models/heads.py take masked means, reproducing the
    reference's mean-over-present-rows reductions);
  - masking randomness comes from a seedable ``numpy.random.Generator``.
"""

import warnings

import numpy as np

from kmbart_tpu_torch.utils.task import TaskType


def _round8(n):
    return ((n + 7) // 8) * 8


class Collator:
    def __init__(
        self,
        tokenizer,
        has_label=True,
        mlm_enabled=False,
        mrm_enabled=False,
        rp_enabled=False,
        ap_enabled=False,
        mlm_probability=0.0,
        mrm_probability=0.0,
        event_max_len=20,
        lm_max_len=30,
        max_img_num=30,
        max_rel_count=80,
        image_feature_size=2052,
        num_mrm_labels=1601,
        encoder_seq_len=None,
        decoder_seq_len=None,
        rng=None,
    ):
        self._tokenizer = tokenizer
        self._has_label = has_label
        self._mlm_enabled = mlm_enabled
        self._mrm_enabled = mrm_enabled
        self._rp_enabled = rp_enabled
        self._ap_enabled = ap_enabled
        self._mlm_probability = mlm_probability
        self._mrm_probability = mrm_probability
        self._event_max_len = event_max_len
        self._lm_max_len = lm_max_len
        self._max_img_num = max_img_num
        self._max_rel_count = max_rel_count
        self._image_feature_size = image_feature_size
        self._num_mrm_labels = num_mrm_labels
        self._rng = rng if rng is not None else np.random.default_rng()

        # reference invariants (src/data/collation.py:52-62)
        if mlm_enabled and not has_label:
            raise ValueError('mlm_enabled can not be true while has_label is false. MLM need labels.')
        if ap_enabled and not has_label:
            raise ValueError('ap_enabled can not be true while has_label is false. attribute prediction need labels.')
        if rp_enabled and not has_label:
            raise ValueError('rp_enabled can not be true while has_label is false. relation prediction need labels.')
        if (rp_enabled or ap_enabled) and not mrm_enabled:
            raise ValueError('if rp/ap is enabled, mrm must also be enabled')

        # static bucket lengths (+margin: clip->decode->re-encode round trips
        # can shift token counts by a few)
        if encoder_seq_len is None:
            encoder_seq_len = _round8(
                1 + (max_img_num + 2) + (event_max_len + 2)
                + ((lm_max_len + 2) if mlm_enabled else 0) + 8)
        if decoder_seq_len is None:
            decoder_seq_len = _round8(
                ((max_img_num + 2) if mrm_enabled else 0) + lm_max_len + 1 + 8)
        self.encoder_seq_len = encoder_seq_len
        self.decoder_seq_len = decoder_seq_len

    def _clip_text(self, text, length):
        ids = self._tokenizer.encode(str(text))
        return self._tokenizer.decode(ids[:length])

    # ----------------------------------------------------------------------

    def __call__(self, batch):
        tok = self._tokenizer
        batch = [entry for entry in batch if entry is not None]
        if not all(x["task_type"] in TaskType.ALL_TYPES for x in batch):
            warnings.warn("Unexpected task type in batch")
        B = len(batch)
        N = self._max_img_num
        F = self._image_feature_size

        raw_feats = [np.asarray(x["image_features"][:N], dtype=np.float32)
                     if "image_features" in x else np.zeros((0, F), np.float32)
                     for x in batch]
        img_num = [len(f) for f in raw_feats]
        label_img_num = img_num if self._mrm_enabled else None

        event = [self._clip_text(x["event"], self._event_max_len)
                 if "event" in x else "" for x in batch]
        task_type = [x["task_type"] for x in batch]
        target = ([self._clip_text(x["labels"], self._lm_max_len) for x in batch]
                  if self._has_label else None)
        mlm = list(target) if self._mlm_enabled else None
        for i in range(B):
            if batch[i]["task_type"] in ("before", "after", "intent") and self._mlm_enabled:
                mlm[i] = event[i]
                event[i] = ""

        enc = tok.encode_condition(img_num=img_num, event=event,
                                   task_type=task_type, mlm=mlm,
                                   pad_to=self.encoder_seq_len)
        input_ids = enc["input_ids"]

        if self._mlm_enabled:
            input_ids = self._mask_tokens(input_ids, enc["mlm_mask"])

        image_features = np.zeros((B, N, F), np.float32)
        for i, f in enumerate(raw_feats):
            if len(f):
                image_features[i, :len(f)] = f

        output = {
            "input_ids": input_ids,
            "attention_mask": enc["attention_mask"],
            "image_features": image_features,
            "index": [x.get("index") for x in batch],
            "task_type": task_type,
        }

        condition_img_mask = enc["img_mask"]

        mrm_slot_masked = None  # per row: bool over image slots
        if self._mrm_enabled:
            masked_regions = self._rng.random(input_ids.shape) < self._mrm_probability
            hit = masked_regions & condition_img_mask
            input_ids[hit] = tok.cls_token_id
            mrm_slot_masked = np.zeros((B, N), bool)
            soft = np.zeros((B, N, self._num_mrm_labels), np.float32)
            for i in range(B):
                img_positions = np.nonzero(condition_img_mask[i])[0]
                slots = np.nonzero(hit[i, img_positions])[0]  # masked slot order
                mrm_slot_masked[i, slots] = True
                if "mrm_labels" in batch[i] and len(slots):
                    lab = np.asarray(batch[i]["mrm_labels"][:N], np.float32)
                    soft[i, slots] = lab[slots]
                if img_num[i] > 0 and len(slots):
                    # zero the detector features, keep the 4 bbox dims
                    image_features[i, slots, :-4] = 0.0
            output["mrm_slot_soft_labels"] = soft

        if self._has_label:
            lab = tok.encode_label(label=target, img_num=label_img_num,
                                   pad_to=self.decoder_seq_len)
            labels = lab["labels"]
            decoder_input_ids = lab["decoder_input_ids"]

            if self._mrm_enabled:
                labels[lab["label_img_mask"]] = input_ids[condition_img_mask]
                decoder_input_ids[lab["decoder_input_img_mask"]] = \
                    input_ids[condition_img_mask]

            T = labels.shape[1]
            if self._ap_enabled:
                attribute_mask = np.zeros((B, T), np.float32)
                attribute_labels = np.zeros((B, T), np.int32)
                for i, entry in enumerate(batch):
                    if "object_ids" in entry:
                        start_pos = int(np.nonzero(
                            labels[i] == tok.begin_img_id)[0][0]) + 2
                        obj_dict = {o["object_id"]: o for o in entry["objects"]}
                        for obj_pos, obj_id in enumerate(
                                entry["object_ids"][:N - 2]):
                            if "attribute_ids" in obj_dict[obj_id]:
                                attribute_mask[i][obj_pos + start_pos] = 1
                                attribute_labels[i][obj_pos + start_pos] = \
                                    obj_dict[obj_id]["attribute_ids"][0]
                output["attribute_labels"] = attribute_labels
                output["attribute_mask"] = attribute_mask

            if self._rp_enabled:
                R = self._max_rel_count
                relation_pairs = np.zeros((B, R, 2), np.int32)
                relation_labels = np.zeros((B, R), np.int32)
                relation_mask = np.zeros((B, R), bool)
                for i, entry in enumerate(batch):
                    if "object_ids" in entry:
                        start_pos = int(np.nonzero(
                            labels[i] == tok.begin_img_id)[0][0]) + 2
                        obj_pos = {oid: start_pos + j for j, oid in
                                   enumerate(entry["object_ids"][:N - 2])}
                        count = 0
                        for rel in entry["relations"]:
                            if rel["object_id"] in obj_pos and \
                                    rel["subject_id"] in obj_pos:
                                relation_pairs[i, count] = (
                                    obj_pos[rel["object_id"]],
                                    obj_pos[rel["subject_id"]])
                                relation_labels[i, count] = rel["predicate_id"]
                                relation_mask[i, count] = True
                                count += 1
                                if count >= R:
                                    break
                output["relation_pairs"] = relation_pairs
                output["relation_labels"] = relation_labels
                output["relation_mask"] = relation_mask

            labels[(labels == tok.pad_token_id) |
                   (labels == tok.begin_img_id) |
                   (labels == tok.end_img_id) |
                   (labels == tok.img_feat_id)] = -100

            output["labels"] = labels
            output["decoder_input_ids"] = decoder_input_ids
            output["decoder_attention_mask"] = lab["decoder_attention_mask"]

            if self._mrm_enabled:
                mrm_mask = labels == tok.cls_token_id
                output["mrm_mask"] = mrm_mask
                # place each masked slot's soft label at its decoder position
                soft_full = np.zeros((B, T, self._num_mrm_labels), np.float32)
                for i in range(B):
                    positions = np.nonzero(mrm_mask[i])[0]
                    slots = np.nonzero(mrm_slot_masked[i])[0]
                    k = min(len(positions), len(slots))
                    soft_full[i, positions[:k]] = \
                        output["mrm_slot_soft_labels"][i, slots[:k]]
                output["mrm_soft_labels"] = soft_full
                del output["mrm_slot_soft_labels"]

        if "question_id" in batch[0]:
            output["question_id"] = [x["question_id"] for x in batch]
        if "dataset_index" in batch[0]:
            output["dataset_index"] = [x.get("dataset_index") for x in batch]
        if self._has_label:
            output["raw_labels"] = [x["labels"] for x in batch]

        return output

    # ----------------------------------------------------------------------

    def _mask_tokens(self, inputs, input_mask):
        """MLM 80/10/10 within the <mlm> span (src/data/collation.py:216-247)."""
        tok = self._tokenizer.get_base_tokenizer()
        inputs = inputs.copy()
        shape = inputs.shape

        prob = np.full(shape, self._mlm_probability)
        special = np.array([tok.get_special_tokens_mask(row)
                            for row in inputs.tolist()], dtype=bool)
        prob[special] = 0.0
        prob[inputs == self._tokenizer.pad_token_id] = 0.0
        masked = self._rng.random(shape) < prob

        replaced = (self._rng.random(shape) < 0.8) & masked
        inputs[replaced & input_mask] = self._tokenizer.mask_token_id

        random_idx = (self._rng.random(shape) < 0.5) & masked & ~replaced
        random_words = self._rng.integers(0, tok.vocab_size, shape)
        sel = random_idx & input_mask
        inputs[sel] = random_words[sel]
        return inputs
