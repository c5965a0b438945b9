"""K1: fused multi-head attention forward on the flat QKV projections.

Counterpart of kmbart_tpu/ops/pallas_train_attention.py (forward only; the
backward comes with the fine-tuning port). The kernel is
``csrc/train_attention.cu``; its source note says what bounds it on an
H100 and how the design answers that.

``train_attention_flat`` is the wrapper: on CPU tensors it runs
``train_attention_plain``, on CUDA tensors it launches the kernel or
raises. Both compute, per head, softmax(q·scale @ kᵀ + key bias, causal
mask) @ v with the TPU kernel's roundings: q·scale and P rounded to the
input dtype, scores, softmax and the PV sum in fp32.
"""

import torch

from kmbart_tpu_torch.ops import _cuda

NEG_INF = -1e9
MAX_LEN = 256  # whole score rows stay on chip


def _key_bias(key_mask, B, Tk, device):
    if key_mask is None:
        return torch.zeros((B, Tk), dtype=torch.float32, device=device)
    return torch.where(key_mask.to(device=device).bool(), 0.0, NEG_INF).float()


def _scaled(q, head_dim):
    # q * head_dim**-0.5 with the scale rounded to q's dtype (JAX weak typing)
    return q * torch.tensor(head_dim ** -0.5, dtype=q.dtype, device=q.device)


def train_attention_plain(q_flat, k_flat, v_flat, key_mask, *, num_heads,
                          causal=False):
    """Plain PyTorch version of the kernel, on any device.

    q_flat [B, Tq, D]; k_flat, v_flat [B, Tk, D] (D = H·hd); key_mask
    [B, Tk] 1-keep/0-pad or None. Returns [B, Tq, D] in the input dtype.
    """
    B, Tq, D = q_flat.shape
    Tk = k_flat.shape[1]
    H = num_heads
    hd = D // H
    dt = q_flat.dtype
    q = _scaled(q_flat, hd).float().reshape(B, Tq, H, hd)
    k = k_flat.to(dt).float().reshape(B, Tk, H, hd)
    v = v_flat.to(dt).float().reshape(B, Tk, H, hd)
    s = torch.einsum("bqhd,bkhd->bhqk", q, k)
    s = s + _key_bias(key_mask, B, Tk, q.device)[:, None, None, :]
    if causal:
        allowed = (torch.arange(Tk, device=q.device)[None, :]
                   <= torch.arange(Tq, device=q.device)[:, None])
        s = torch.where(allowed, s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    e = torch.exp(s - m)
    p = (e / e.sum(dim=-1, keepdim=True)).to(dt).float()
    out = torch.einsum("bhqk,bkhd->bqhd", p, v)
    return out.reshape(B, Tq, D).to(dt)


def supported(q_len, k_len, head_dim):
    """Shapes the kernel takes (the wrapper raises on others)."""
    return q_len <= MAX_LEN and k_len <= MAX_LEN and head_dim % 8 == 0


def train_attention_flat(q_flat, k_flat, v_flat, key_mask, *, num_heads,
                         causal=False):
    """Fused attention on flat projections; same contract as
    ``train_attention_plain``. CUDA tensors launch the kernel."""
    if q_flat.device.type == "cpu":
        return train_attention_plain(q_flat, k_flat, v_flat, key_mask,
                                     num_heads=num_heads, causal=causal)
    dev = _cuda.require_cuda("train_attention_flat", q_flat, k_flat, v_flat)
    B, Tq, D = q_flat.shape
    Tk = k_flat.shape[1]
    hd = D // num_heads
    if (k_flat.shape != (B, Tk, D) or v_flat.shape != k_flat.shape
            or D % num_heads):
        raise ValueError(f"train_attention_flat: shapes {tuple(q_flat.shape)}, "
                         f"{tuple(k_flat.shape)}, {tuple(v_flat.shape)}")
    if not supported(Tq, Tk, hd):
        raise ValueError(f"train_attention_flat kernel takes Tq, Tk <= {MAX_LEN} "
                         f"and head_dim % 8 == 0, got {Tq}, {Tk}, {hd}")
    if causal and Tq != Tk:
        raise ValueError("train_attention_flat: causal needs Tq == Tk")
    if not (q_flat.dtype == k_flat.dtype == v_flat.dtype):
        raise TypeError("train_attention_flat: q, k, v dtypes differ")
    code = _cuda.dtype_code(q_flat)
    lib, stream = _cuda.prepare(dev)
    if lib.kmb_train_attention_smem_bytes(Tk, hd) > 227 * 1024:
        raise ValueError(f"train_attention_flat: K/V of {Tk} x {hd} do not fit "
                         "in shared memory")
    bias = _key_bias(key_mask, B, Tk, dev).contiguous()
    scale = float(torch.tensor(hd ** -0.5, dtype=q_flat.dtype))
    out = torch.empty_like(q_flat)
    _cuda.check(lib.kmb_train_attention_fwd(
        q_flat.data_ptr(), k_flat.data_ptr(), v_flat.data_ptr(), bias.data_ptr(),
        out.data_ptr(), B, Tq, Tk, D, num_heads, int(causal), scale, code,
        stream), "train_attention_flat")
    train_attention_flat.launches += 1
    return out


train_attention_flat.launches = 0
