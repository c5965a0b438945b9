"""Pretraining model: the trunk plus the LM, MRM, attribute and relation
heads, and its multi-task loss.

Counterpart of kmbart_tpu/models/pretraining.py (the reference's
``MultiModalBartForPreTraining``, src/model/model.py:125-309):
  - the tied LM head + ``final_logits_bias`` with CE on the labels (cls
    positions forced to -100), scaled by ``lm_loss_factor``;
  - the MRM head (d -> d -> num_labels) with KL "batchmean" on the
    detector's soft labels over the masked-region decoder positions;
  - the attribute head's CE over the attribute-masked positions;
  - the relation head's CE on the concatenated (object, subject) hidden
    rows.
Every head runs on the collator's fixed shapes and a head with no rows
gives exactly 0. The batch contract is that of the JAX module.

Two things differ on purpose. The LM logits of the aux output are computed
only when read (``_LazyAux``): the JAX package computes them unconditionally
and XLA drops them under jit, while eagerly they would be a second
vocab-wide projection every step and defeat mode "nomat". And the
(object, subject) rows are gathered by index, where the JAX package
multiplies by one-hot matrices to avoid a scatter-add on the TPU
(:110-120); the values are the same.
"""

import torch
from torch import nn

from kmbart_tpu_torch.config import MultiModalBartConfig
from kmbart_tpu_torch.device import resolve_device
from kmbart_tpu_torch.models import bart
from kmbart_tpu_torch.models.bart import MultiModalBartModel, compute_dtype, init_bart_params_
from kmbart_tpu_torch.models.conditional import _LazyAux
from kmbart_tpu_torch.models.heads import (BartClassificationHead, classification_head,
                                           lm_cross_entropy, masked_cross_entropy,
                                           masked_kl_div_batchmean)


class MultiModalBartForPreTraining(nn.Module):
    def __init__(self, config: MultiModalBartConfig):
        super().__init__()
        d = config.d_model
        self.model = MultiModalBartModel(config)
        self.register_buffer("final_logits_bias", torch.zeros((1, config.vocab_size)))
        self.mrm_head = BartClassificationHead(d, d, config.num_labels)
        self.attribute_head = BartClassificationHead(d, d, config.num_attributes)
        self.relation_head = BartClassificationHead(2 * d, d, config.num_relations)


@torch.no_grad()
def init_pretraining_model(cfg: MultiModalBartConfig, seed=0, device="cuda"):
    """A model initialised from ``seed`` (a ``torch.Generator`` on the CPU),
    then moved to ``device`` (the card unless the caller passes "cpu"; no
    card raises): the trunk as ``init_bart_params_``, the heads as
    ``init_classification_head`` (normal(0, init_std) weights, zero
    biases)."""
    device = resolve_device(device)
    model = MultiModalBartForPreTraining(cfg)
    gen = torch.Generator().manual_seed(seed)
    init_bart_params_(model.model, cfg, gen)
    for head in (model.mrm_head, model.attribute_head, model.relation_head):
        for lin in (head.dense, head.out_proj):
            lin.weight.normal_(0.0, cfg.init_std, generator=gen)
            lin.bias.zero_()
    return model.to(device).eval()


def _pair_rows(hidden, pairs):
    """[B, R, 2D]: the hidden rows at each (object, subject) index pair."""
    B, R, _ = pairs.shape
    D = hidden.shape[-1]
    idx = pairs.long()
    obj = torch.gather(hidden, 1, idx[..., 0:1].expand(B, R, D))
    sub = torch.gather(hidden, 1, idx[..., 1:2].expand(B, R, D))
    return torch.cat([obj, sub], dim=-1)


def pretraining_loss(model, cfg, batch, *, train=False, generator=None, tp=None,
                     trunk_fn=None):
    """The multi-task loss. Returns (total, aux): ``aux["losses"]`` holds
    lm_loss, mrm_loss, attribute_loss, relation_loss and loss, for the heads
    whose inputs the batch has (src/model/model.py:244-307);
    ``aux["logits"]`` are the LM logits in the compute dtype, computed on
    access. Dropout draws from ``generator`` when ``train``, trunk first.

    ``tp``: tensor parallelism (parallel/tp.py). ``trunk_fn(trunk, cfg,
    batch, train, generator) -> decoder hidden`` swaps the encoder/decoder
    trunk for another execution of the same math
    (kmbart_tpu/models/pretraining.py:53,69): the pipeline
    (parallel/pp.py) passes its staged forward here, and the heads run
    whole on every rank on its output."""
    if trunk_fn is not None:
        hidden = trunk_fn(model.model, cfg, batch, train, generator)
    else:
        hidden, _ = bart.forward(
            model.model, cfg, batch["input_ids"], batch.get("image_features"),
            batch.get("attention_mask"), decoder_input_ids=batch["decoder_input_ids"],
            decoder_attention_mask=batch.get("decoder_attention_mask"), train=train,
            generator=generator, tp=tp)
    dtype = compute_dtype(cfg)
    head = dict(dropout_rate=cfg.classif_dropout, generator=generator, train=train,
                dtype=dtype)
    losses = {}
    total = 0.0

    def add(name, loss, n, factor):
        nonlocal total
        loss = torch.where(n > 0, loss * factor, 0.0)
        losses[name] = loss
        total = total + loss

    if "mrm_soft_labels" in batch:
        logits = classification_head(model.mrm_head, hidden, **head)
        logp = torch.log_softmax(logits.float(), dim=-1)
        add("mrm_loss", *masked_kl_div_batchmean(logp, batch["mrm_soft_labels"],
                                                 batch["mrm_mask"].bool()),
            cfg.mrm_loss_factor)
    if "attribute_labels" in batch:
        logits = classification_head(model.attribute_head, hidden, **head)
        add("attribute_loss", *masked_cross_entropy(logits, batch["attribute_labels"],
                                                    batch["attribute_mask"].bool()),
            cfg.attribute_loss_factor)
    if "relation_pairs" in batch:
        logits = classification_head(model.relation_head,
                                     _pair_rows(hidden, batch["relation_pairs"]), **head)
        add("relation_loss", *masked_cross_entropy(logits, batch["relation_labels"],
                                                   batch["relation_mask"].bool()),
            cfg.relation_loss_factor)
    if "labels" in batch:
        # cls positions are ignored (src/model/model.py:296-302)
        labels = torch.where(batch["labels"] == cfg.cls_token_id, -100, batch["labels"])
        lm_loss, _ = lm_cross_entropy(model.model, cfg, hidden, model.final_logits_bias,
                                      labels)
        lm_loss = lm_loss * cfg.lm_loss_factor
        losses["lm_loss"] = lm_loss
        total = total + lm_loss
    losses["loss"] = total
    return total, _LazyAux(lambda: bart.lm_logits(model.model, cfg, hidden,
                                                  model.final_logits_bias,
                                                  logits_dtype=dtype), losses=losses)


@torch.no_grad()
def forward_logits(model, cfg, batch):
    """Teacher-forced fp32 LM logits at eval (the sample-printing callback's)."""
    hidden, _ = bart.forward(
        model.model, cfg, batch["input_ids"], batch.get("image_features"),
        batch.get("attention_mask"), decoder_input_ids=batch["decoder_input_ids"],
        decoder_attention_mask=batch.get("decoder_attention_mask"))
    return bart.lm_logits(model.model, cfg, hidden, model.final_logits_bias)
