"""K2: fused FFN forward, y = gelu(x @ W1ᵀ + b1) @ W2ᵀ + b2.

Counterpart of kmbart_tpu/ops/pallas_ffn.py (forward only; the backward
comes with the fine-tuning port). The kernel is ``csrc/ffn.cu``; its source
note says what bounds it on an H100 and how the design answers that.

``fused_ffn`` is the wrapper: on CPU tensors it runs ``fused_ffn_plain``,
on CUDA tensors it launches the kernel or raises. Both round where the
composite dense → gelu → dense does: a = bf16(x@W1ᵀ + b1), h = bf16(gelu(a))
with exact erf in fp32, y = bf16(h@W2ᵀ + b2), fp32 accumulation throughout.
Weights are ``fc1.weight`` [F, D] and ``fc2.weight`` [D, F].
"""

import math

import torch

from kmbart_tpu_torch.ops import _cuda

_INV_SQRT2 = 1.0 / math.sqrt(2.0)
ROW_TILE = 32     # csrc/ffn.cu BM
F_TILE = 64       # csrc/ffn.cu BF
MAX_D = 1024      # the [32, D] fp32 accumulator lives in registers


def _gelu_f32(z):
    return z * 0.5 * (1.0 + torch.erf(z * _INV_SQRT2))


def fused_ffn_plain(x, w1, b1, w2, b2):
    """Plain PyTorch version of the kernel, on any device. x [..., D] bf16;
    w1 [F, D], w2 [D, F] (any float dtype, rounded to bf16); b1 [F], b2 [D]
    fp32. Returns bf16 [..., D]."""
    bf16 = torch.bfloat16
    a = x.to(bf16).float() @ w1.to(bf16).float().t() + b1.float()
    h = _gelu_f32(a.to(bf16).float()).to(bf16)
    y = h.float() @ w2.to(bf16).float().t() + b2.float()
    return y.to(bf16)


def supported(d, f):
    """Widths the kernel takes (the wrapper raises on others)."""
    return d % 16 == 0 and d <= MAX_D and f % F_TILE == 0


def _splits(n_rows, n_tiles, device):
    """Split the F walk when the row tiles alone would leave SMs idle."""
    row_tiles = -(-n_rows // ROW_TILE)
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    want = max(1, min(n_tiles, sms // row_tiles))
    per = -(-n_tiles // want)
    return -(-n_tiles // per), per


def fused_ffn(x, w1, b1, w2, b2):
    """Fused FFN; same contract as ``fused_ffn_plain`` except that on a CUDA
    device the weights must already be bf16 and the biases fp32."""
    if x.device.type == "cpu":
        return fused_ffn_plain(x, w1, b1, w2, b2)
    dev = _cuda.require_cuda("fused_ffn", x, w1, b1, w2, b2)
    D = x.shape[-1]
    F = w1.shape[0]
    if w1.shape != (F, D) or w2.shape != (D, F) or b1.shape != (F,) or b2.shape != (D,):
        raise ValueError(f"fused_ffn: shapes x {tuple(x.shape)}, w1 {tuple(w1.shape)}, "
                         f"b1 {tuple(b1.shape)}, w2 {tuple(w2.shape)}, b2 {tuple(b2.shape)}")
    if not supported(D, F):
        raise ValueError(f"fused_ffn kernel takes D % 16 == 0, D <= {MAX_D}, "
                         f"F % {F_TILE} == 0; got D {D}, F {F}")
    if not (x.dtype == w1.dtype == w2.dtype == torch.bfloat16):
        raise TypeError("fused_ffn kernel takes bf16 x and weights")
    if not (b1.dtype == b2.dtype == torch.float32):
        raise TypeError("fused_ffn kernel takes fp32 biases")
    xf = x.reshape(-1, D)
    N = xf.shape[0]
    y = torch.empty_like(xf)
    if N == 0:
        return y.reshape(x.shape)
    nsplit, per = _splits(N, F // F_TILE, dev)
    partial = (torch.empty((nsplit, N, D), dtype=torch.float32, device=dev)
               if nsplit > 1 else y)
    lib, stream = _cuda.prepare(dev)
    _cuda.check(lib.kmb_ffn_fwd(
        xf.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(), b2.data_ptr(),
        y.data_ptr(), partial.data_ptr(), N, D, F, nsplit, per, stream),
        "fused_ffn")
    fused_ffn.launches += 1
    return y.reshape(x.shape)


fused_ffn.launches = 0
