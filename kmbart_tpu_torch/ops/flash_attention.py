"""K11: blockwise (flash) attention for sequences too long for K1.

Counterpart of kmbart_tpu/ops/pallas_attention.py. The kernel is in
``csrc/flash_attention.cu``; its source note says what bounds it on an H100
and how the design answers that: bf16 inputs run both products on the
tensor cores, with p split into two bf16 terms (``p_split``), fp32 inputs
on the CUDA cores. It reads q, k and v by row stride (the chunks of a fused
QKV projection need no copy).

``flash_attention`` wraps the forward: on CPU tensors it runs
``flash_attention_plain``, on CUDA tensors it launches the kernel or raises.
Both compute, per head, softmax(float(q)·scale @ float(k)ᵀ + key bias,
causal mask) @ float(v) with p kept in fp32 and an fp32 output, as
``_flash_kernel`` does (pallas_attention.py:24-59): q is cast to fp32 and
then scaled (K1 rounds q·scale to the input dtype instead), the running max
starts at -1e9, and the output is acc / max(l, 1e-30).

The JAX package has no backward kernel for this attention: its custom VJP
differentiates the plain XLA math, recomputed from (q, k, v)
(``_reference_attention_bh``, :94-131). ``flash_self_attention`` does the
same: a ``torch.autograd.Function`` whose forward is the kernel and whose
backward is autograd through ``flash_attention_plain``.
"""

import torch

from kmbart_tpu_torch.ops import _cuda
from kmbart_tpu_torch.ops.train_attention import _kernel_mask, _ptr, row_stride
from kmbart_tpu_torch.utils.profiling import count

NEG_INF = -1e9
MIN_SCORES = 128 * 128   # pallas_attention.flash_supported: Tq·Tk floor
MAX_HEAD_DIM = 128       # csrc/flash_attention.cu: the widest instantiation


def p_split(p):
    """The two bf16 terms the bf16 kernel multiplies V by in place of the
    fp32 p: (bf16(p), bf16(p − bf16(p))), as fp32 tensors. Their sum is
    within 2⁻¹⁶·p of p: each rounding keeps 8 significant bits, and the
    second rounds a residual of at most 2⁻⁸·p."""
    hi = p.to(torch.bfloat16).float()
    return hi, (p - hi).to(torch.bfloat16).float()


def _key_bias(key_mask, B, Tk, device):
    if key_mask is None:
        return torch.zeros((B, Tk), dtype=torch.float32, device=device)
    return torch.where(key_mask.to(device=device).bool(), 0.0, NEG_INF).float()


def flash_attention_plain(q_flat, k_flat, v_flat, key_mask, *, num_heads, causal=False):
    """Plain PyTorch version of the kernel, on any device, differentiable.

    q_flat [B, Tq, D]; k_flat, v_flat [B, Tk, D] (D = H·hd); key_mask
    [B, Tk] 1-keep/0-pad or None. Returns [B, Tq, D] fp32."""
    B, Tq, D = q_flat.shape
    Tk = k_flat.shape[1]
    H = num_heads
    hd = D // H
    q = q_flat.float().reshape(B, Tq, H, hd) * hd ** -0.5
    k = k_flat.float().reshape(B, Tk, H, hd)
    v = v_flat.float().reshape(B, Tk, H, hd)
    s = torch.einsum("bqhd,bkhd->bhqk", q, k)
    s = s + _key_bias(key_mask, B, Tk, q.device)[:, None, None, :]
    if causal:
        allowed = (torch.arange(Tk, device=q.device)[None, :]
                   <= torch.arange(Tq, device=q.device)[:, None])
        s = torch.where(allowed, s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True).clamp(min=NEG_INF)   # the kernel's running max starts there
    e = torch.exp(s - m)
    l = e.sum(dim=-1).transpose(1, 2)[..., None]           # [B, Tq, H, 1]
    out = torch.einsum("bhqk,bkhd->bqhd", e, v) / l.clamp(min=1e-30)
    return out.reshape(B, Tq, D)


def supported(q_len, k_len, head_dim, causal=False):
    """Shapes on which the JAX package takes its flash kernel
    (pallas_attention.py:158-177) without its TPU and dropout clauses:
    Tq·Tk of at least 128², lengths and head_dim in multiples of 8, causal
    only when Tq == Tk; and the kernel's head_dim bound."""
    if causal and q_len != k_len:
        return False
    if q_len * k_len < MIN_SCORES:
        return False
    return (q_len % 8 == 0 and k_len % 8 == 0 and head_dim % 8 == 0
            and head_dim <= MAX_HEAD_DIM)


def flash_attention(q_flat, k_flat, v_flat, key_mask, *, num_heads, causal=False):
    """The kernel; same contract as ``flash_attention_plain`` (without
    gradients). CUDA tensors launch the kernel, in bf16 or fp32; rows may be
    strided (``train_attention.row_stride``)."""
    if q_flat.device.type == "cpu":
        return flash_attention_plain(q_flat, k_flat, v_flat, key_mask,
                                     num_heads=num_heads, causal=causal)
    dev = _cuda.require_cuda("flash_attention", q_flat, k_flat, v_flat, contiguous=False)
    B, Tq, D = q_flat.shape
    Tk = k_flat.shape[1]
    if (k_flat.shape != (B, Tk, D) or v_flat.shape != k_flat.shape
            or D % num_heads):
        raise ValueError(f"flash_attention: shapes {tuple(q_flat.shape)}, "
                         f"{tuple(k_flat.shape)}, {tuple(v_flat.shape)}")
    hd = D // num_heads
    if hd > MAX_HEAD_DIM:
        raise ValueError(f"flash_attention kernel takes head_dim <= {MAX_HEAD_DIM}, got {hd}")
    if causal and Tq != Tk:
        raise ValueError("flash_attention: causal needs Tq == Tk")
    if not (q_flat.dtype == k_flat.dtype == v_flat.dtype):
        raise TypeError("flash_attention: q, k, v dtypes differ")
    code = _cuda.dtype_code(q_flat)
    if q_flat.dtype == torch.bfloat16 and hd % 8:
        raise ValueError(f"flash_attention: the bf16 kernel takes head_dim % 8 == 0, got {hd}")
    out = torch.empty((B, Tq, D), dtype=torch.float32, device=dev)
    if B == 0 or Tq == 0 or Tk == 0:
        return out.zero_()
    mask = _kernel_mask(key_mask, B, Tk, dev)
    lds = [row_stride(t, "flash_attention") for t in (q_flat, k_flat, v_flat)]
    lib, stream = _cuda.prepare(dev)
    _cuda.check(lib.kmb_flash_attention(
        q_flat.data_ptr(), k_flat.data_ptr(), v_flat.data_ptr(), _ptr(mask),
        out.data_ptr(), B, Tq, Tk, D, num_heads, *lds, int(causal), hd ** -0.5, code, stream),
        "flash_attention")
    count("launch.flash_attention")
    return out


class _FlashAttention(torch.autograd.Function):
    # forward: the kernel; backward: autograd through the plain math,
    # recomputed from (q, k, v), as pallas_attention.py:122-128 does. The
    # module-level name is looked up at call time, so a caller can route the
    # forward to the plain version.

    @staticmethod
    def forward(ctx, q_flat, k_flat, v_flat, key_mask, num_heads, causal):
        ctx.save_for_backward(q_flat, k_flat, v_flat, key_mask)
        ctx.num_heads, ctx.causal = num_heads, causal
        return flash_attention(q_flat, k_flat, v_flat, key_mask, num_heads=num_heads,
                               causal=causal)

    @staticmethod
    def backward(ctx, g):
        q_flat, k_flat, v_flat, key_mask = ctx.saved_tensors
        leaves = [t.detach().requires_grad_() for t in (q_flat, k_flat, v_flat)]
        with torch.enable_grad():
            out = flash_attention_plain(*leaves, key_mask, num_heads=ctx.num_heads,
                                        causal=ctx.causal)
        dq, dk, dv = torch.autograd.grad(out, leaves, g.float())
        return dq, dk, dv, None, None, None


def flash_self_attention(q_flat, k_flat, v_flat, key_mask, *, num_heads, causal=False):
    """Differentiable flash attention (``flash_attention``'s contract);
    without autograd it is the forward alone."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q_flat, k_flat, v_flat)):
        return _FlashAttention.apply(q_flat, k_flat, v_flat, key_mask, num_heads, causal)
    return flash_attention(q_flat, k_flat, v_flat, key_mask, num_heads=num_heads,
                           causal=causal)
