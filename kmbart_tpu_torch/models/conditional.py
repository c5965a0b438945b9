"""Conditional-generation model: the trunk plus the tied LM head's bias,
and its training loss.

Counterpart of kmbart_tpu/models/conditional.py. ``final_logits_bias`` is a
buffer, as in transformers 3.0.2, shaped [1, vocab] like its state-dict
entry.
"""

from collections.abc import Mapping

import torch
from torch import nn

from kmbart_tpu_torch.config import MultiModalBartConfig
from kmbart_tpu_torch.device import resolve_device
from kmbart_tpu_torch.models import bart
from kmbart_tpu_torch.models.bart import MultiModalBartModel, init_bart_params_
from kmbart_tpu_torch.models.heads import lm_cross_entropy


class MultiModalBartForConditionalGeneration(nn.Module):
    def __init__(self, config: MultiModalBartConfig):
        super().__init__()
        self.model = MultiModalBartModel(config)
        self.register_buffer("final_logits_bias", torch.zeros((1, config.vocab_size)))


def init_conditional_model(cfg: MultiModalBartConfig, seed=0, device="cuda"):
    """A model initialised from ``seed`` (a ``torch.Generator`` on the CPU),
    then moved to ``device`` (the card unless the caller passes "cpu"; no
    card raises)."""
    device = resolve_device(device)
    model = MultiModalBartForConditionalGeneration(cfg)
    init_bart_params_(model.model, cfg, torch.Generator().manual_seed(seed))
    return model.to(device).eval()


class _LazyAux(Mapping):
    """``{"logits": ..., **items}`` with the logits computed on first access.
    Under jit JAX drops the unused aux logits; eager PyTorch would pay a
    second vocab-wide projection each step, so the port computes them only
    when asked."""

    def __init__(self, compute, **items):
        self._compute, self._logits, self._items = compute, None, items

    def __getitem__(self, key):
        if key in self._items:
            return self._items[key]
        if key != "logits":
            raise KeyError(key)
        if self._logits is None:
            self._logits = self._compute()
        return self._logits

    def __iter__(self):
        return iter(("logits", *self._items))

    def __len__(self):
        return 1 + len(self._items)


def conditional_loss(model, cfg, batch, *, train=False, generator=None, tp=None,
                     trunk_fn=None):
    """CE loss on ``batch["labels"]`` (-100 ignored), dropout drawn from
    ``generator`` when ``train``. Returns (loss, aux) where ``aux["logits"]``
    are the LM logits in the compute dtype, computed on access. ``tp``:
    tensor parallelism (parallel/tp.py); ``trunk_fn(trunk, cfg, batch,
    train, generator) -> decoder hidden`` swaps the trunk for another
    execution of the same math (the pipeline, parallel/pp.py). The LM head
    runs whole on the decoder output either way."""
    if trunk_fn is not None:
        hidden = trunk_fn(model.model, cfg, batch, train, generator)
    else:
        hidden, _ = bart.forward(
            model.model, cfg, batch["input_ids"], batch.get("image_features"),
            batch.get("attention_mask"), decoder_input_ids=batch["decoder_input_ids"],
            decoder_attention_mask=batch.get("decoder_attention_mask"), train=train,
            generator=generator, tp=tp)
    loss, _ = lm_cross_entropy(model.model, cfg, hidden, model.final_logits_bias,
                               batch["labels"])
    return loss, _LazyAux(lambda: bart.lm_logits(
        model.model, cfg, hidden, model.final_logits_bias,
        logits_dtype=bart.compute_dtype(cfg)))
