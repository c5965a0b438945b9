"""Loss heads of the conditional-generation model.

Counterpart of the LM part of kmbart_tpu/models/heads.py: the ignore-index
cross-entropy with its hand-written gradient, and ``lm_cross_entropy``,
which takes the fused LM-head + CE kernels (ops/lm_ce.py) where they apply
and the composite ``lm_logits`` + ``cross_entropy_ignore_index`` otherwise.
The pretraining heads are not ported yet.
"""

import torch

from kmbart_tpu_torch.ops import lm_ce


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
    n = valid.sum()
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
