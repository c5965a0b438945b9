"""Text-image matching classifier (auxiliary, ATOMIC pretraining data QA).

Counterpart of kmbart_tpu/models/reasoning.py: ``ReasoningClassification``
(the reference's src/model/model.py:408-426) — tanh-projected text and
image representations, concatenated into a binary matched/shuffled head
with CE loss — and ``AtomicCollator`` (src/data/collation.py:250-293):
shuffle a share of the events across the batch as negatives, encode the
text with a frozen backbone, zero-pad the image features to a fixed slot
count. The text backbone is pluggable (the prepare_atomic twin uses the
port's mean-pooled BART encoder).

Parameters are a flat {name: tensor} dict with [out, in] kernels, which is
what the port's AdamW updates.
"""

import numpy as np
import torch

from kmbart_tpu_torch.models.heads import masked_cross_entropy
from kmbart_tpu_torch.ops.layers import dense


def init_reasoning_params(generator, txt_dim, image_dim, inner_dim, init_std=0.02,
                          device="cpu"):
    normal = lambda *shape: torch.randn(shape, generator=generator, device=device) * init_std
    zeros = lambda n: torch.zeros(n, device=device)
    return {
        "txt_kernel": normal(inner_dim, txt_dim), "txt_bias": zeros(inner_dim),
        "image_kernel": normal(inner_dim, image_dim), "image_bias": zeros(inner_dim),
        "out_kernel": normal(2, 2 * inner_dim), "out_bias": zeros(2),
    }


def reasoning_loss(params, txt, image, label, dtype=torch.bfloat16):
    """txt [B, txt_dim]; image [B, image_dim]; label [B] in {0, 1} ->
    (mean CE, logits [B, 2])."""
    tx = torch.tanh(dense(txt, params["txt_kernel"], params["txt_bias"], dtype))
    ix = torch.tanh(dense(image, params["image_kernel"], params["image_bias"], dtype))
    logits = dense(torch.cat([ix, tx], dim=-1), params["out_kernel"], params["out_bias"], dtype)
    loss, _ = masked_cross_entropy(logits, label, torch.ones(label.shape, dtype=torch.bool,
                                                             device=label.device))
    return loss, logits


class AtomicCollator:
    """Shuffled-negative batch builder (src/data/collation.py:250-293).

    ``text_encode_fn(list[str]) -> array [B, txt_dim]`` replaces the
    reference's in-collator BERT forward. Returns numpy arrays."""

    def __init__(self, text_encode_fn, image_seq_length, image_feature_size, shuffle_ratio,
                 rng=None):
        self._encode = text_encode_fn
        self._image_seq_length = image_seq_length
        self._feat = image_feature_size
        self._shuffle_ratio = shuffle_ratio
        self._rng = rng if rng is not None else np.random.default_rng()

    def __call__(self, batch):
        event = np.array([x.get("event", "") for x in batch], dtype=object)
        label = np.ones(len(batch), dtype=np.int32)
        new_order = self._rng.permutation(len(batch))
        shuffled = self._rng.random(len(batch)) > self._shuffle_ratio
        event[shuffled] = event[new_order[shuffled]]
        label[shuffled] = 0

        text = np.asarray(self._encode([str(e) for e in event]), np.float32)

        L, F = self._image_seq_length, self._feat
        image = np.zeros((len(batch), L, F), np.float32)
        for i, x in enumerate(batch):
            feats = np.asarray(x.get("image_features", np.zeros((0, F), np.float32)))[:L]
            image[i, : len(feats)] = feats

        return {"text": text, "image": image.reshape(len(batch), -1), "label": label}
