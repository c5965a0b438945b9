"""K7 and K8: the tied LM head fused with the ignore-index cross-entropy.

Counterpart of kmbart_tpu/ops/pallas_lm_ce.py in its default mode
"fwdbwd". The kernels are in ``csrc/lm_ce.cu``; its source note says what
bounds them on an H100 and how the design answers that.

``lm_ce_fwd`` (K7) projects h @ Wᵀ + bias, writes the logits in bf16 and
returns each row's max, exp-sum and label logit, taken on the rounded
logits. ``lm_ce_bwd`` (K8) forms dlogits = scale·(softmax − onehot) in
bf16 from the stored logits and the statistics, and dh = dlogits @ W. On
CPU tensors both run their plain versions (``lm_ce_fwd_plain``,
``lm_ce_bwd_plain``); on CUDA tensors they launch the kernel or raise.
``fused_lm_ce`` is the differentiable loss: dW = dlogitsᵀ @ h is a library
matmul cast to the bf16 weight dtype (pallas_lm_ce.py:426-431), and
``final_logits_bias`` gets no gradient. The modes "bwd" and "nomat" of the
JAX package are not ported.
"""

import torch

from kmbart_tpu_torch.ops import _cuda
from kmbart_tpu_torch.ops.layers import mm_f32

MIN_VOCAB = 1024   # pallas_lm_ce.DEFAULT_TILE_V: the JAX gate's vocab floor
TILE_V = 128       # csrc/lm_ce.cu BN: vocab columns per K7 block
TILE_N = 64        # csrc/lm_ce.cu BM
STEP_V = 32        # csrc/lm_ce.cu BK: the K8 walk over the vocab


def supported(n_rows, vocab_size, d_model, dtype):
    """The JAX gate (pallas_lm_ce.py:474-488) without its TPU and
    single-device clauses: rows in tiles of 8, d_model % 128 == 0, a vocab
    of at least 1024; and the kernels' bf16."""
    return (n_rows % 8 == 0 and d_model % 128 == 0 and vocab_size >= MIN_VOCAB
            and dtype == torch.bfloat16)


def lm_ce_fwd_plain(h, w, fbias, labels):
    """Plain PyTorch version of K7, on any device. h [N, D] and w [V, D] in
    the compute dtype; fbias [V]; labels [N] in range. Returns (logits
    [N, V] in h's dtype, m, se, ll [N] fp32)."""
    logits = (h.float() @ w.float().t() + fbias.float()).to(h.dtype)
    lf = logits.float()
    m = lf.amax(dim=-1)
    se = torch.exp(lf - m[:, None]).sum(dim=-1)
    ll = lf.gather(1, labels.long()[:, None])[:, 0]
    return logits, m, se, ll


def _check_head(name, w, d, dtype):
    if w.ndim != 2 or w.shape[1] != d:
        raise ValueError(f"{name}: weight {tuple(w.shape)} for width {d}")
    if d % TILE_V:
        raise ValueError(f"{name} kernel takes d_model % {TILE_V} == 0, got {d}")
    if not (dtype == w.dtype == torch.bfloat16):
        raise TypeError(f"{name} kernel takes bf16 activations and weights")


def lm_ce_fwd(h, w, fbias, labels):
    """K7; same contract as ``lm_ce_fwd_plain`` except that on a CUDA device
    h and w must be bf16, fbias fp32 and labels int32."""
    if h.device.type == "cpu":
        return lm_ce_fwd_plain(h, w, fbias, labels)
    dev = _cuda.require_cuda("lm_ce_fwd", h, w, fbias, labels)
    (N, D), V = h.shape, w.shape[0]
    _check_head("lm_ce_fwd", w, D, h.dtype)
    if fbias.shape != (V,) or fbias.dtype != torch.float32:
        raise ValueError("lm_ce_fwd: bias must be fp32 [V]")
    if labels.shape != (N,) or labels.dtype != torch.int32:
        raise ValueError("lm_ce_fwd: labels must be int32 [N]")
    f32 = dict(dtype=torch.float32, device=dev)
    logits = torch.empty((N, V), dtype=torch.bfloat16, device=dev)
    m, se, ll = (torch.empty(N, **f32) for _ in range(3))
    if N == 0:
        return logits, m, se, ll
    n_vtiles = -(-V // TILE_V)
    parts = [torch.empty((N, n_vtiles), **f32) for _ in range(3)]
    lib, stream = _cuda.prepare(dev)
    _cuda.check(lib.kmb_lm_ce_fwd(
        h.data_ptr(), w.data_ptr(), fbias.data_ptr(), labels.data_ptr(), logits.data_ptr(),
        *(p.data_ptr() for p in parts), m.data_ptr(), se.data_ptr(), ll.data_ptr(),
        N, V, D, stream), "lm_ce_fwd")
    lm_ce_fwd.launches += 1
    return logits, m, se, ll


lm_ce_fwd.launches = 0


def lm_ce_bwd_plain(logits, w, m, inv_se, scale, labels):
    """Plain PyTorch version of K8, on any device. logits [N, V]; w [V, D];
    m, inv_se, scale [N] fp32; labels [N] in range. Returns (dlogits in the
    logits' dtype, dh in w's dtype)."""
    lf = logits.float()
    p = torch.exp(lf - m[:, None]) * inv_se[:, None]
    onehot = torch.arange(lf.shape[1], device=lf.device)[None, :] == labels.long()[:, None]
    dl = (scale[:, None] * (p - onehot.float())).to(logits.dtype)
    dh = (dl.float() @ w.float()).to(w.dtype)
    return dl, dh


def _splits(n_blocks, n_steps, device):
    """Split the vocab walk when the output tiles alone would leave SMs idle."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    want = max(1, min(n_steps, (2 * sms) // max(n_blocks, 1)))
    per = -(-n_steps // want)
    return -(-n_steps // per), per


def lm_ce_bwd(logits, w, m, inv_se, scale, labels):
    """K8; same contract as ``lm_ce_bwd_plain`` except that on a CUDA device
    logits and w must be bf16, the statistics fp32 and labels int32."""
    if logits.device.type == "cpu":
        return lm_ce_bwd_plain(logits, w, m, inv_se, scale, labels)
    dev = _cuda.require_cuda("lm_ce_bwd", logits, w, m, inv_se, scale, labels)
    N = logits.shape[0]
    V, D = w.shape
    _check_head("lm_ce_bwd", w, D, logits.dtype)
    if logits.shape != (N, V):
        raise ValueError(f"lm_ce_bwd: logits {tuple(logits.shape)} for w {tuple(w.shape)}")
    for t in (m, inv_se, scale):
        if t.shape != (N,) or t.dtype != torch.float32:
            raise ValueError("lm_ce_bwd: statistics must be fp32 [N]")
    if labels.shape != (N,) or labels.dtype != torch.int32:
        raise ValueError("lm_ce_bwd: labels must be int32 [N]")
    dl = torch.empty_like(logits)
    dh = torch.empty((N, D), dtype=torch.bfloat16, device=dev)
    if N == 0:
        return dl, dh
    n_blocks = (D // TILE_V) * -(-N // TILE_N)
    nsplit, per = _splits(n_blocks, -(-V // STEP_V), dev)
    partial = (torch.empty((nsplit, N, D), dtype=torch.float32, device=dev)
               if nsplit > 1 else None)
    lib, stream = _cuda.prepare(dev)
    _cuda.check(lib.kmb_lm_ce_bwd(
        logits.data_ptr(), w.data_ptr(), m.data_ptr(), inv_se.data_ptr(), scale.data_ptr(),
        labels.data_ptr(), dl.data_ptr(), dh.data_ptr(),
        None if partial is None else partial.data_ptr(), N, V, D, nsplit, per, stream),
        "lm_ce_bwd")
    lm_ce_bwd.launches += 1
    return dl, dh


lm_ce_bwd.launches = 0


class _FusedNll(torch.autograd.Function):
    """Sum over valid rows of -log softmax(h Wᵀ + bias)[label]; the
    counterpart of _fused_nll_fn's "fwdbwd" custom VJP (pallas_lm_ce.py:385).
    The kernel wrappers are looked up at call time, so a caller can route
    both directions to the plain versions."""

    @staticmethod
    def forward(ctx, h2, w_b, fbias, safe_labels, valid):
        logits, m, se, ll = lm_ce_fwd(h2, w_b, fbias, safe_labels)
        ctx.save_for_backward(h2, w_b, logits, m, se, safe_labels, valid)
        return torch.where(valid, torch.log(se) + m - ll, 0.0).sum()

    @staticmethod
    def backward(ctx, g):
        h2, w_b, logits, m, se, safe_labels, valid = ctx.saved_tensors
        scale = (g * valid.float()).contiguous()
        dl, dh = lm_ce_bwd(logits, w_b, m, (1.0 / se).contiguous(), scale, safe_labels)
        # the cotangent of the rounded W in its dtype, as XLA's dot
        # transpose emits it on the composite path
        dw = mm_f32(dl.t(), h2).to(w_b.dtype)
        return dh, dw, None, None, None


def fused_lm_ce(hidden, shared, final_logits_bias, labels, *, ignore_index=-100,
                dtype=torch.bfloat16):
    """``lm_logits`` + ``cross_entropy_ignore_index`` in one op. hidden
    [..., D]; shared [V, D] (the fp32 tied embedding); final_logits_bias
    [V] or [1, V] (no gradient); labels [...]. Returns (mean loss over the
    valid positions, their count), as the composite path does."""
    d = hidden.shape[-1]
    h2 = hidden.reshape(-1, d).to(dtype).contiguous()
    w_b = shared.to(dtype)
    labels2 = labels.reshape(-1)
    valid = labels2 != ignore_index
    safe = torch.where(valid, labels2, 0).to(torch.int32).contiguous()
    fbias = final_logits_bias.detach().reshape(-1).float().contiguous()
    nll = _FusedNll.apply(h2, w_b, fbias, safe, valid)
    cnt = valid.sum()
    return nll / cnt.clamp(min=1), cnt
