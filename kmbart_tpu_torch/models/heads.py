"""Classification heads and loss functions.

Counterpart of kmbart_tpu/models/heads.py: the pretraining classification
head, the ignore-index cross-entropy with its hand-written gradient,
``lm_cross_entropy``, which takes the fused LM-head + CE kernels
(ops/lm_ce.py) where they apply and the composite ``lm_logits`` +
``cross_entropy_ignore_index`` otherwise, and the masked-mean losses of the
pretraining heads (KL "batchmean" over the masked regions, CE over the
present attribute and relation labels). Each mean divides by
``global_count`` of its count: under data parallelism the count over every
rank's rows, as the JAX package's mean over the global batch does.
"""

import torch
from torch import nn

from kmbart_tpu_torch.ops import lm_ce
from kmbart_tpu_torch.ops.layers import dense, dropout
from kmbart_tpu_torch.parallel.distributed import global_count


class BartClassificationHead(nn.Module):
    """dropout -> dense -> tanh -> dropout -> out_proj (heads.py:22-42,
    HF 3.0.2's ``BartClassificationHead``); [out, in] weights."""

    def __init__(self, input_dim, inner_dim, num_classes):
        super().__init__()
        self.dense = nn.Linear(input_dim, inner_dim)
        self.out_proj = nn.Linear(inner_dim, num_classes)


def classification_head(head, x, *, dropout_rate=0.0, generator=None, train=False,
                        dtype=torch.bfloat16):
    """The head's forward with the mixed-precision policy of ``dense``:
    logits in ``dtype``; dropout drawn from ``generator`` when ``train``."""
    x = dropout(x, dropout_rate, generator, train)
    x = torch.tanh(dense(x, head.dense.weight, head.dense.bias, dtype))
    x = dropout(x, dropout_rate, generator, train)
    return dense(x, head.out_proj.weight, head.out_proj.bias, dtype)


class _MaskedNllSum(torch.autograd.Function):
    """Sum over valid positions of -log softmax(logits)[label], statistics
    in fp32, with the closed-form gradient scale·(softmax − onehot) emitted
    in the logits dtype: the counterpart of ``_masked_nll_sum``'s custom
    VJP (heads.py:49-98)."""

    @staticmethod
    def forward(ctx, logits, safe_labels, valid):
        lf = logits.float()
        m = lf.amax(dim=-1)
        se = torch.exp(lf - m[..., None]).sum(dim=-1)
        ll = logits.gather(-1, safe_labels[..., None])[..., 0].float()
        ctx.save_for_backward(logits, safe_labels, valid, m, se)
        return torch.where(valid, torch.log(se) + m - ll, 0.0).sum()

    @staticmethod
    def backward(ctx, g):
        logits, safe_labels, valid, m, se = ctx.saved_tensors
        p = torch.exp(logits.float() - m[..., None]) / se[..., None]
        vocab = torch.arange(logits.shape[-1], device=logits.device)
        onehot = (vocab == safe_labels[..., None]).float()
        scale = (g * valid.float())[..., None]
        return (scale * (p - onehot)).to(logits.dtype), None, None


def cross_entropy_ignore_index(logits, labels, ignore_index=-100):
    """Mean CE over the positions whose label is not ``ignore_index``, and
    their count. Statistics are fp32 whatever the logits dtype."""
    valid = labels != ignore_index
    safe = torch.where(valid, labels, 0).long()
    n = global_count(valid.sum())
    return _MaskedNllSum.apply(logits, safe, valid) / n.clamp(min=1), n


def lm_cross_entropy(model, cfg, hidden, final_logits_bias, labels, *, ignore_index=-100):
    """LM-head projection + ignore-index CE (heads.py:116-137): the fused
    kernels when ``lm_ce.supported``, the composite path otherwise.
    ``model`` is the trunk (``MultiModalBartModel``)."""
    from kmbart_tpu_torch.models.bart import compute_dtype, lm_logits
    dtype = compute_dtype(cfg)
    n_rows = hidden.numel() // hidden.shape[-1]
    if lm_ce.supported(n_rows, cfg.vocab_size, cfg.d_model, dtype):
        return lm_ce.fused_lm_ce(hidden, model.shared.weight, final_logits_bias, labels,
                                 ignore_index=ignore_index, dtype=dtype)
    logits = lm_logits(model, cfg, hidden, final_logits_bias, logits_dtype=dtype)
    return cross_entropy_ignore_index(logits, labels, ignore_index=ignore_index)


def masked_kl_div_batchmean(log_probs, soft_labels, mask):
    """``F.kl_div(log_probs, targets, reduction="batchmean")`` over the rows
    where ``mask`` is set (heads.py:140-152): pointwise t·(log t − log p)
    with 0·log 0 := 0, summed over classes, divided by the number of masked
    rows. ``torch.where`` on both sides keeps NaN out of the gradient.
    Returns (loss, that number)."""
    t = soft_labels.float()
    present = t > 0
    log_t = torch.log(torch.where(present, t, 1.0))
    pointwise = torch.where(present, t * (log_t - log_probs), 0.0)
    per_row = pointwise.sum(dim=-1)
    n = global_count(mask.sum())
    return torch.where(mask, per_row, 0.0).sum() / n.clamp(min=1), n


def masked_cross_entropy(logits, labels, mask):
    """Mean CE over the rows where ``mask`` is set (heads.py:155-160).
    Returns (loss, that number)."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    safe = torch.where(mask, labels, 0).long()
    nll = -logp.gather(-1, safe[..., None])[..., 0]
    n = global_count(mask.sum())
    return torch.where(mask, nll, 0.0).sum() / n.clamp(min=1), n
