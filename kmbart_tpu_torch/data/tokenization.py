"""Condition tokenizer: multimodal conditioning-sequence packing.

Parity target: ``ConditionTokenizer`` (src/data/tokenization.py:6-268):
  - wraps the byte-level BPE tokenizer and appends the 16 added special
    tokens (ids 50265-50280 on the real BART vocab): <img> </img> <event>
    </event> <before> <intent> <after> <caption> <img_feat> <mlm> </mlm>
    <cls> <token1> <token2> <token3> <region_caption>;
  - ``encode_condition`` builds
    ``task_type [<img> <img_feat>*N </img>] [<event> E </event>] [<mlm> M </mlm>]``
    and returns input_ids/attention_mask plus event/mlm/img masks;
  - ``encode_label`` builds ``[<img>*N prefix] <s> LABEL </s>`` and splits it
    into labels (without <s>) and decoder_input_ids (without </s>).

TPU-first deltas: outputs are numpy arrays padded to ``pad_to`` (a static
bucket length) instead of the ragged batch max, so every batch has the same
shape and the train step compiles once.
"""

import os

import numpy as np

from kmbart_tpu_torch.data.bpe import ByteLevelBPE
from kmbart_tpu_torch.utils.task import TaskType

ADDED_TOKENS = (
    "<img>", "</img>", "<event>", "</event>", "<before>", "<intent>",
    "<after>", "<caption>", "<img_feat>", "<mlm>", "</mlm>", "<cls>",
    "<token1>", "<token2>", "<token3>", "<region_caption>",
)


def _pad_rows(rows, pad_value, pad_to=None):
    width = max(len(r) for r in rows)
    if pad_to is not None:
        if width > pad_to:
            raise ValueError(f"sequence length {width} exceeds pad_to={pad_to}")
        width = pad_to
    out = np.full((len(rows), width), pad_value, dtype=np.int32)
    mask = np.zeros((len(rows), width), dtype=np.int32)
    for i, r in enumerate(rows):
        out[i, :len(r)] = r
        mask[i, :len(r)] = 1
    return out, mask


class ConditionTokenizer:
    def __init__(self, assets_dir=None, vocab_file=None, merges_file=None):
        if assets_dir is None and vocab_file is None:
            assets_dir = os.environ.get("KMBART_TOKENIZER_DIR")
        if assets_dir is not None:
            vocab_file = os.path.join(assets_dir, "vocab.json")
            merges_file = os.path.join(assets_dir, "merges.txt")
        if vocab_file is None:
            raise ValueError(
                "ConditionTokenizer needs tokenizer assets: pass assets_dir/"
                "vocab_file+merges_file or set KMBART_TOKENIZER_DIR")
        self._base = ByteLevelBPE(vocab_file, merges_file)
        self.additional_special_tokens = list(ADDED_TOKENS)
        self._base.add_special_tokens(self.additional_special_tokens)

        t = self._base.convert_tokens_to_ids
        self.begin_img, self.end_img = "<img>", "</img>"
        self.begin_event, self.end_event = "<event>", "</event>"
        self.before, self.intent, self.after = "<before>", "<intent>", "<after>"
        self.caption, self.img_feat = "<caption>", "<img_feat>"
        self.begin_mlm, self.end_mlm = "<mlm>", "</mlm>"
        self.cls_token, self.region_caption = "<cls>", "<region_caption>"

        self.begin_img_id = t(self.begin_img)
        self.end_img_id = t(self.end_img)
        self.begin_event_id = t(self.begin_event)
        self.end_event_id = t(self.end_event)
        self.before_id = t(self.before)
        self.intent_id = t(self.intent)
        self.after_id = t(self.after)
        self.img_feat_id = t(self.img_feat)
        self.caption_id = t(self.caption)
        self.begin_mlm_id = t(self.begin_mlm)
        self.end_mlm_id = t(self.end_mlm)
        self.cls_token_id = t(self.cls_token)
        self.region_caption_id = t(self.region_caption)

        self.vocab_size = self._base.vocab_size
        self.bos_token, self.bos_token_id = self._base.bos_token, t(self._base.bos_token)
        self.eos_token, self.eos_token_id = self._base.eos_token, t(self._base.eos_token)
        self.pad_token, self.pad_token_id = self._base.pad_token, t(self._base.pad_token)
        self.unk_token, self.unk_token_id = self._base.unk_token, t(self._base.unk_token)
        self.mask_token, self.mask_token_id = self._base.mask_token, t(self._base.mask_token)

    # -- task prefix -------------------------------------------------------

    def _task_token(self, task):
        table = {TaskType.INTENT: self.intent, TaskType.BEFORE: self.before,
                 TaskType.AFTER: self.after, TaskType.CAPTION: self.caption,
                 TaskType.REGION_CAPTION: self.region_caption}
        if task not in table:
            raise ValueError('Unexpected task type "{}"'.format(task))
        return table[task]

    # -- encoder-side packing ------------------------------------------------

    def encode_condition(self, task_type, img_num=None, event=None, mlm=None,
                         pad_to=None):
        """Build the conditioning sequence (src/data/tokenization.py:100-195).

        Returns numpy arrays: input_ids, attention_mask and, when the
        corresponding input is given, event_mask / mlm_mask / img_mask.
        """
        if not isinstance(task_type, list):
            task_type = [task_type]
        text = [self._task_token(t) for t in task_type]

        if img_num is not None:
            if not isinstance(img_num, list):
                img_num = [img_num]
            for i, n in enumerate(img_num):
                text[i] += self.begin_img + self.img_feat * n + self.end_img
        if event is not None:
            if not isinstance(event, list):
                event = [event]
            for i, e in enumerate(event):
                text[i] += self.begin_event + e + self.end_event
        if mlm is not None:
            if not isinstance(mlm, list):
                mlm = [mlm]
            for i, m in enumerate(mlm):
                text[i] += self.begin_mlm + m + self.end_mlm

        rows = [self._base.encode(t) for t in text]
        input_ids, attention_mask = _pad_rows(rows, self.pad_token_id, pad_to)
        encoded = {"input_ids": input_ids, "attention_mask": attention_mask}

        def span_mask(begin_id, end_id):
            mask = np.zeros(input_ids.shape, dtype=bool)
            for i, row in enumerate(input_ids):
                starts = np.nonzero(row == begin_id)[0]
                ends = np.nonzero(row == end_id)[0]
                if len(starts) and len(ends):
                    mask[i, starts[0] + 1:ends[0]] = True
            return mask

        if event is not None:
            encoded["event_mask"] = span_mask(self.begin_event_id, self.end_event_id)
        if mlm is not None:
            encoded["mlm_mask"] = span_mask(self.begin_mlm_id, self.end_mlm_id)
        if img_num is not None:
            encoded["img_mask"] = input_ids == self.img_feat_id
        return encoded

    # -- decoder-side packing -------------------------------------------------

    def encode_label(self, label, img_num=None, pad_to=None):
        """Build labels / decoder inputs (src/data/tokenization.py:197-250):
        text = [<img> <img_feat>*N </img>] <s> LABEL </s>; labels drop <s>,
        decoder_input_ids drop </s>."""
        if not isinstance(label, list):
            label = [label]
        text = [self.bos_token + v + self.eos_token for v in label]
        if img_num is not None:
            if not isinstance(img_num, list):
                img_num = [img_num]
            for i, n in enumerate(img_num):
                text[i] = (self.begin_img + self.img_feat * n + self.end_img
                           + text[i])

        rows = [self._base.encode(t) for t in text]
        label_rows, dec_rows = [], []
        for r in rows:
            label_rows.append([x for x in r if x != self.bos_token_id])
            dec_rows.append([x for x in r if x != self.eos_token_id])
        labels, _ = _pad_rows(label_rows, self.pad_token_id, pad_to)
        decoder_input_ids, decoder_attention_mask = _pad_rows(
            dec_rows, self.pad_token_id, pad_to)

        output = {
            "labels": labels,
            "decoder_input_ids": decoder_input_ids,
            "decoder_attention_mask": decoder_attention_mask,
        }
        if img_num is not None:
            output["label_img_mask"] = labels == self.img_feat_id
            output["decoder_input_img_mask"] = decoder_input_ids == self.img_feat_id
        return output

    # -- misc --------------------------------------------------------------------

    def encode(self, text):
        return self._base.encode(text)

    def decode(self, token_ids, skip_special_tokens=False):
        return self._base.decode(token_ids, skip_special_tokens=skip_special_tokens)

    def convert_tokens_to_ids(self, tokens):
        return self._base.convert_tokens_to_ids(tokens)

    def convert_ids_to_tokens(self, ids):
        return self._base.convert_ids_to_tokens(ids)

    def get_base_tokenizer(self):
        return self._base

    def __len__(self):
        return len(self._base)
