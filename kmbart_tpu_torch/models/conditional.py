"""Conditional-generation model: the trunk plus the tied LM head's bias.

Counterpart of kmbart_tpu/models/conditional.py (parameters only; the loss
comes with the fine-tuning port). ``final_logits_bias`` is a buffer, as in
transformers 3.0.2, shaped [1, vocab] like its state-dict entry.
"""

import torch
from torch import nn

from kmbart_tpu.config import MultiModalBartConfig
from kmbart_tpu_torch.models.bart import MultiModalBartModel, init_bart_params_


class MultiModalBartForConditionalGeneration(nn.Module):
    def __init__(self, config: MultiModalBartConfig):
        super().__init__()
        self.model = MultiModalBartModel(config)
        self.register_buffer("final_logits_bias", torch.zeros((1, config.vocab_size)))


def init_conditional_model(cfg: MultiModalBartConfig, seed=0, device="cpu"):
    """A model initialised from ``seed`` (a ``torch.Generator`` on the CPU),
    then moved to ``device``."""
    model = MultiModalBartForConditionalGeneration(cfg)
    init_bart_params_(model.model, cfg, torch.Generator().manual_seed(seed))
    return model.to(device).eval()
