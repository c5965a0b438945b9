"""The one traffic generator: host batches from a traffic mix's parameters.

A mix (``traffic/<mix>.json``) gives the batch, the lengths and the shares;
``make_batch(mix, cfg, seed, index)`` draws batch ``index`` of a run from
(seed, index) alone, so a batch can be drawn again after the window to be
checked. Arrays are numpy, as a collator hands them to the system.

Encoder rows are BOS, then ``image_slots`` image positions, then text with
an EOS at the last real position; a row's real length is drawn uniformly
from ``real_len`` and the rest is padding. Decoder rows (``dec_len``) are
the shifted target of ``dec_real_len`` real tokens, labels -100 past it.
The pretraining fields follow the KM-BART collator: a share of the image
slots masked for region classification (cls tokens that keep their ROI
feature, with the detector's soft labels over ``num_labels``), attribute
labels on a share of the slots, and ``relations_present`` of
``relation_pairs`` (object, subject) pairs a row.
"""

import numpy as np

TEXT_IDS = (4, 50265)   # BART's BPE tokens, below KM-BART's added specials


def rng_for(seed, index):
    return np.random.default_rng([int(seed) % 2 ** 63, int(index)])


def _encoder(rng, mix, cfg, B):
    T, N = mix["enc_len"], mix["image_slots"]
    lo, hi = mix["real_len"]
    lens = rng.integers(lo, hi + 1, B)
    ids = rng.integers(*_text_ids(cfg), (B, T))
    ids[:, 0] = cfg["bos_token_id"]
    ids[:, 1:1 + N] = cfg["img_feat_id"]
    pos = np.arange(T)[None, :]
    ids[pos == lens[:, None] - 1] = cfg["eos_token_id"]
    ids = np.where(pos < lens[:, None], ids, cfg["pad_token_id"])
    mask = (pos < lens[:, None]).astype(np.int64)
    feats = rng.standard_normal((B, cfg["max_img_num"], cfg["image_feature_size"]),
                                dtype=np.float32)
    return ids, mask, feats


def _text_ids(cfg):
    """Text ids: BART's BPE tokens, below KM-BART's added specials (a small
    test vocabulary keeps below its image and cls ids)."""
    return TEXT_IDS[0], min(TEXT_IDS[1], cfg["img_feat_id"])


def _decoder(rng, mix, cfg, B):
    T = mix["dec_len"]
    lo, hi = mix["dec_real_len"]
    lens = rng.integers(lo, hi + 1, B)
    pos = np.arange(T)[None, :]
    tgt = rng.integers(*_text_ids(cfg), (B, T))
    tgt[:, 0] = cfg["bos_token_id"]
    tgt[pos == lens[:, None] - 1] = cfg["eos_token_id"]
    real = pos < lens[:, None]
    # HF BART's shift: the last real token (EOS) wraps to position 0
    dec_in = np.concatenate([np.full((B, 1), cfg["eos_token_id"]), tgt[:, :-1]], axis=1)
    dec_in = np.where(real, dec_in, cfg["pad_token_id"])
    labels = np.where(real, tgt, -100)
    return dec_in, real.astype(np.int64), labels


def make_batch(mix, cfg, seed, index):
    rng = rng_for(seed, index)
    B = mix["batch"]
    ids, mask, feats = _encoder(rng, mix, cfg, B)
    batch = {"input_ids": ids, "attention_mask": mask, "image_features": feats}
    if mix.get("dec_len"):
        dec_in, dec_mask, labels = _decoder(rng, mix, cfg, B)
        batch.update(decoder_input_ids=dec_in, decoder_attention_mask=dec_mask, labels=labels)
    if mix.get("relation_pairs"):
        _pretraining_fields(rng, mix, cfg, batch)
    return batch


def _pretraining_fields(rng, mix, cfg, batch):
    """The collator's pretraining fields: the decoder's image span at
    positions 1..N copies the encoder's (cls where masked), its labels are
    -100 there but at the masked regions."""
    B, T = batch["decoder_input_ids"].shape
    N = mix["image_slots"]
    span = slice(1, 1 + N)
    masked = rng.random((B, N)) < mix["masked_region_share"]
    batch["input_ids"][:, span][masked] = cfg["cls_token_id"]
    batch["decoder_input_ids"][:, span] = batch["input_ids"][:, span]
    labels = batch["labels"]
    labels[:, span] = np.where(masked, cfg["cls_token_id"], -100)
    batch["mrm_mask"] = labels == cfg["cls_token_id"]
    soft = np.zeros((B, T, cfg["num_labels"]), np.float32)
    b, n = np.nonzero(masked)
    logits = 2.0 * rng.standard_normal((len(b), cfg["num_labels"]), dtype=np.float32)
    e = np.exp(logits - logits.max(-1, keepdims=True))
    soft[b, 1 + n] = e / e.sum(-1, keepdims=True)
    batch["mrm_soft_labels"] = soft
    attr = np.zeros((B, T), np.float32)
    attr[:, span] = rng.random((B, N)) < mix["attribute_share"]
    batch["attribute_mask"] = attr
    batch["attribute_labels"] = rng.integers(0, cfg["num_attributes"], (B, T))
    R = mix["relation_pairs"]
    batch["relation_pairs"] = rng.integers(1, 1 + N, (B, R, 2))
    batch["relation_labels"] = rng.integers(0, cfg["num_relations"], (B, R))
    rel = np.zeros((B, R), bool)
    rel[:, :mix["relations_present"]] = True
    batch["relation_mask"] = rel
