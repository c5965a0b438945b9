"""K1: fused multi-head attention on the flat QKV projections, forward and
backward.

Counterpart of kmbart_tpu/ops/pallas_train_attention.py. Two routes, chosen
by ``plan``: "wg", the persistent TMA + wgmma kernels of
``csrc/train_attention_wg.cu`` (forward) and ``train_attention_wg_bwd.cu``
(backward), for bf16 at head_dim 64 and lengths up to 128 (every shape of
the main path); "legacy", PR 4's kernels in ``csrc/train_attention_tc.cuh``
(bf16, mma.sync) and ``csrc/train_attention.cu`` (fp32), for the rest. The
source notes say what bounds them on an H100 and how each design answers
that.

``train_attention_flat`` wraps the forward: on CPU tensors it runs
``train_attention_plain``, on CUDA tensors it launches the kernel or
raises. Both compute, per head, softmax(q·scale @ kᵀ + key bias, causal
mask) @ v with the TPU kernel's roundings: q·scale and P rounded to the
input dtype, scores, softmax and the PV sum in fp32. The kernels read q,
k and v by row stride, so the chunks of a fused QKV projection go in as
they are; in bf16 they run on the tensor cores.
``train_attention_bwd`` wraps the backward the same way
(``train_attention_bwd_plain`` on the CPU), and ``train_attention`` is the
differentiable op the model calls: forward K1, backward the K1 backward,
as the JAX package's custom VJP pairs them (:368-381).
"""

from collections import namedtuple

import torch

from kmbart_tpu_torch.ops import _cuda, ffn
from kmbart_tpu_torch.utils.profiling import count

NEG_INF = -1e9
MAX_LEN = 256  # whole score rows stay on chip

# The "wg" kernels' reach and shared memory (csrc/train_attention_wg.cuh
# geometry, mirrored by _geometry; the launch refuses a plan whose bytes
# differ from its own).
WG_HEAD_DIM = 64
WG_MAX_LEN = 128      # past it a row's S and dP outgrow one pass's registers
STAGES = 2            # pairs in the shared-memory ring
SMEM_MAX = 232448     # shared memory a block may use on an H100

Plan = namedtuple("Plan", "kernel stages smem_bytes consumers")


def _key_bias(key_mask, B, Tk, device):
    if key_mask is None:
        return torch.zeros((B, Tk), dtype=torch.float32, device=device)
    return torch.where(key_mask.to(device=device).bool(), 0.0, NEG_INF).float()


def _kernel_mask(key_mask, B, Tk, device):
    """The key mask as the kernels read it: [B, Tk] int64 on the device
    (no copy when it already is), or None for no mask."""
    if key_mask is None:
        return None
    if tuple(key_mask.shape) != (B, Tk):
        raise ValueError(f"key_mask of shape {tuple(key_mask.shape)}, expected {(B, Tk)}")
    return key_mask.to(device=device, dtype=torch.int64).contiguous()


def _ptr(t):
    return None if t is None else t.data_ptr()


_SCALES = {}


def _scale(head_dim, dtype):
    """head_dim**-0.5 rounded to ``dtype``, as a Python float (cached: a
    launch's host time counts)."""
    key = (head_dim, dtype)
    if key not in _SCALES:
        _SCALES[key] = float(torch.tensor(head_dim ** -0.5, dtype=dtype))
    return _SCALES[key]


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


def row_stride(t, name):
    """The row stride of a [B, T, D] tensor whose rows are contiguous and
    evenly spaced (a chunk of a fused [B, T, 3D] projection has 3D); the
    bf16 kernels load 16-byte units, so there it must be a multiple of 8
    elements from a 16-byte aligned start. Raises on any other layout."""
    B, T, D = t.shape
    if t.is_contiguous():
        ld = D
    else:
        s0, s1, s2 = t.stride()
        ld = s1 if T > 1 else s0
        if s2 != 1 or ld < D or (B > 1 and s0 != T * ld):
            raise ValueError(f"{name}: the kernel reads rows by stride, got strides "
                             f"{t.stride()} for shape {tuple(t.shape)}")
    if t.dtype == torch.bfloat16 and (ld % 8 or t.data_ptr() % 16):
        raise ValueError(f"{name}: bf16 rows must start 16-byte aligned (row stride "
                         f"{ld}, address {t.data_ptr()})")
    return ld


def _check_args(name, q_flat, k_flat, v_flat, num_heads, causal, g_flat=None):
    """Device, shapes, dtypes and layouts the kernels take; returns (device,
    B, Tq, Tk, D, hd, (ldq, ldk, ldv))."""
    dev = _cuda.require_cuda(name, q_flat, k_flat, v_flat, contiguous=False)
    if g_flat is not None and _cuda.require_cuda(name, g_flat) != dev:  # g: contiguous
        raise ValueError(f"{name}: tensors on {g_flat.device} and {dev}")
    B, Tq, D = q_flat.shape
    Tk = k_flat.shape[1]
    hd = D // num_heads
    if (k_flat.shape != (B, Tk, D) or v_flat.shape != k_flat.shape or D % num_heads
            or (g_flat is not None and g_flat.shape != q_flat.shape)):
        shapes = [tuple(t.shape) for t in (q_flat, k_flat, v_flat, g_flat) if t is not None]
        raise ValueError(f"{name}: shapes {shapes}")
    if not supported(Tq, Tk, hd):
        raise ValueError(f"{name} kernel takes Tq, Tk <= {MAX_LEN} and head_dim % 8 == 0, "
                         f"got {Tq}, {Tk}, {hd}")
    if causal and Tq != Tk:
        raise ValueError(f"{name}: causal needs Tq == Tk")
    if not (q_flat.dtype == k_flat.dtype == v_flat.dtype
            and (g_flat is None or g_flat.dtype == q_flat.dtype)):
        raise TypeError(f"{name}: input dtypes differ")
    lds = tuple(row_stride(t, name) for t in (q_flat, k_flat, v_flat))
    return dev, B, Tq, Tk, D, hd, lds


def _round(n, m):
    return -(-n // m) * m


def _geometry(Tq, Tk, backward):
    """(shared-memory bytes, consumer warpgroups) of a "wg" block, as
    csrc/train_attention_wg.cuh geometry carves it: a stage a pair (forward:
    Q at Tq rounded to 16 rows, K and V at Tk rounded to 16, at least Tq
    rounded to 64 rows in all; backward: Q and G at Tq rounded to 64, K and
    V at Tk rounded to 16), 128 bytes a row; the stages' key biases, to 1024
    bytes; the backward's P and dS tiles and an 8 KB dQ staging tile a
    consumer; the barriers; 1024 bytes to align the base."""
    rq, rk, rk64 = _round(Tq, 64 if backward else 16), _round(Tk, 16), _round(Tk, 64)
    cw = 2 if backward and (rq > 64 or rk64 > 64) else 1
    stage = max(((2 if backward else 1) * rq + 2 * rk) * 128, _round(Tq, 64) * 128)
    tiles = 2 * (rk64 // 64) * rq * 128 + cw * 8192 if backward else 0
    return _round(STAGES * (stage + 4 * rk), 1024) + tiles + 2 * STAGES * 8 + 1024, cw


def wg_takes(Tq, Tk, head_dim, dtype, causal):
    """Shapes the "wg" kernels take: bf16, head_dim 64, 1 <= Tq, Tk <= 128
    (causal: square)."""
    return (dtype == torch.bfloat16 and head_dim == WG_HEAD_DIM and 1 <= Tq <= WG_MAX_LEN
            and 1 <= Tk <= WG_MAX_LEN and (not causal or Tq == Tk))


def plan(Tq, Tk, head_dim, dtype, causal, backward=False, kernel=None):
    """The route of a K1 (or, ``backward``, K1b) call: ``Plan(kernel,
    stages, smem_bytes, consumers)`` (consumer warpgroups a block, each
    block one producer warp more). "wg" wherever it takes the shape
    (``wg_takes``), else "legacy" (PR 4's kernels; their own launch sizes
    them, so the other fields are None). ``kernel`` forces a route (a
    test's hook: chip_smoke.py times both in one run)."""
    if kernel is None:
        kernel = "wg" if wg_takes(Tq, Tk, head_dim, dtype, causal) else "legacy"
    if kernel == "legacy":
        return Plan("legacy", None, None, None)
    if kernel != "wg" or not wg_takes(Tq, Tk, head_dim, dtype, causal):
        raise ValueError(f"train_attention: no {kernel!r} kernel for Tq {Tq}, Tk {Tk}, "
                         f"head_dim {head_dim}, {dtype}, causal={causal}")
    smem, cw = _geometry(Tq, Tk, backward)
    return Plan("wg", STAGES, smem, cw)


def grid(pairs, sms, resident):
    """The persistent grid: every block the card holds at once, or one a
    (b, h) pair when there are fewer pairs. Block x walks the pairs x, x +
    grid, ... (the kernels' loops)."""
    return max(1, min(pairs, sms * resident))


_RESIDENT = {}


def resident(device, Tq, Tk, backward):
    """Blocks of the "wg" kernel for (Tq, Tk) an SM of ``device`` holds
    (cudaOccupancyMaxActiveBlocksPerMultiprocessor), read once."""
    key = (device, Tq, Tk, backward)
    if key not in _RESIDENT:
        n = _cuda.lib().kmb_train_attention_wg_resident(Tq, Tk, int(backward))
        if n < 0:
            _cuda.check(-n, "train_attention resident blocks")
        if n < 1:
            raise RuntimeError(f"train_attention: no block of {Tq}/{Tk} fits on an SM")
        _RESIDENT[key] = n
    return _RESIDENT[key]


def launch_grid(device, Tq, Tk, pairs, backward):
    """The grid a "wg" launch on ``device`` takes."""
    return grid(pairs, ffn.sm_count(device), resident(device, Tq, Tk, backward))


def train_attention_flat(q_flat, k_flat, v_flat, key_mask, *, num_heads,
                         causal=False):
    """Fused attention on flat projections; same contract as
    ``train_attention_plain``. CUDA tensors launch the kernel."""
    if q_flat.device.type == "cpu":
        return train_attention_plain(q_flat, k_flat, v_flat, key_mask,
                                     num_heads=num_heads, causal=causal)
    return _fwd_launch(q_flat, k_flat, v_flat, key_mask, num_heads, causal)


def _fwd_launch(q_flat, k_flat, v_flat, key_mask, num_heads, causal, kernel=None):
    """The forward kernel on CUDA tensors, on ``plan``'s route (``kernel``
    forces one)."""
    dev, B, Tq, Tk, D, hd, lds = _check_args("train_attention_flat", q_flat, k_flat,
                                             v_flat, num_heads, causal)
    code = _cuda.dtype_code(q_flat)
    lib, stream = _cuda.prepare(dev)
    p = plan(Tq, Tk, hd, q_flat.dtype, causal, kernel=kernel)
    if (p.kernel == "legacy"
            and lib.kmb_train_attention_smem_bytes(Tq, Tk, hd, code) > 227 * 1024):
        raise ValueError(f"train_attention_flat: {Tq}/{Tk} x {hd} do not fit in shared "
                         "memory")
    mask = _kernel_mask(key_mask, B, Tk, dev)
    scale = _scale(hd, q_flat.dtype)
    out = torch.empty((B, Tq, D), dtype=q_flat.dtype, device=dev)
    ptrs = (q_flat.data_ptr(), k_flat.data_ptr(), v_flat.data_ptr(), _ptr(mask),
            out.data_ptr(), B, Tq, Tk, D, num_heads, *lds, int(causal), scale)
    if p.kernel == "wg":
        blocks = launch_grid(dev, Tq, Tk, B * num_heads, False)
        err = lib.kmb_train_attention_wg_fwd(*ptrs, blocks, p.smem_bytes, stream)
    else:
        err = lib.kmb_train_attention_fwd(*ptrs, code, stream)
    _cuda.check(err, "train_attention_flat")
    count("launch.train_attention")
    if p.kernel == "legacy":
        count("launch.train_attention_legacy")
    return out


def train_attention_bwd_plain(q_flat, k_flat, v_flat, key_mask, g_flat, *, num_heads,
                              causal=False):
    """Plain PyTorch version of the backward kernel, on any device: the
    recompute-softmax backward of pallas_train_attention.py:76-156 with its
    roundings (g and ds rounded to the input dtype, P rounded for dv, dq
    scaled in fp32 and then rounded, dk taken against the rounded q·scale).
    Returns (dq, dk, dv) in the input dtype."""
    B, Tq, D = q_flat.shape
    Tk = k_flat.shape[1]
    H = num_heads
    hd = D // H
    dt = q_flat.dtype
    q = _scaled(q_flat, hd).float().reshape(B, Tq, H, hd)
    k = k_flat.to(dt).float().reshape(B, Tk, H, hd)
    v = v_flat.to(dt).float().reshape(B, Tk, H, hd)
    g = g_flat.to(dt).float().reshape(B, Tq, H, hd)
    s = torch.einsum("bqhd,bkhd->bhqk", q, k)
    s = s + _key_bias(key_mask, B, Tk, q.device)[:, None, None, :]
    if causal:
        allowed = (torch.arange(Tk, device=q.device)[None, :]
                   <= torch.arange(Tq, device=q.device)[:, None])
        s = torch.where(allowed, s, NEG_INF)
    e = torch.exp(s - s.amax(dim=-1, keepdim=True))
    p = e / e.sum(dim=-1, keepdim=True)
    dp = torch.einsum("bqhd,bkhd->bhqk", g, v)
    ds = (p * (dp - (dp * p).sum(dim=-1, keepdim=True))).to(dt).float()
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, k) * hd ** -0.5
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q)
    dv = torch.einsum("bhqk,bqhd->bkhd", p.to(dt).float(), g)
    return (dq.reshape(B, Tq, D).to(dt), dk.reshape(B, Tk, D).to(dt),
            dv.reshape(B, Tk, D).to(dt))


def train_attention_bwd(q_flat, k_flat, v_flat, key_mask, g_flat, *, num_heads,
                        causal=False):
    """Backward of ``train_attention_flat``; same contract as
    ``train_attention_bwd_plain``. CUDA tensors launch the kernel (g must
    already be in the input dtype)."""
    if q_flat.device.type == "cpu":
        return train_attention_bwd_plain(q_flat, k_flat, v_flat, key_mask, g_flat,
                                         num_heads=num_heads, causal=causal)
    return _bwd_launch(q_flat, k_flat, v_flat, key_mask, g_flat, num_heads, causal)


def _bwd_launch(q_flat, k_flat, v_flat, key_mask, g_flat, num_heads, causal, kernel=None):
    """The backward kernel on CUDA tensors, on ``plan``'s route (``kernel``
    forces one)."""
    dev, B, Tq, Tk, D, hd, lds = _check_args("train_attention_bwd", q_flat, k_flat,
                                             v_flat, num_heads, causal, g_flat)
    code = _cuda.dtype_code(q_flat)
    lib, stream = _cuda.prepare(dev)
    p = plan(Tq, Tk, hd, q_flat.dtype, causal, backward=True, kernel=kernel)
    if (p.kernel == "legacy"
            and lib.kmb_train_attention_bwd_smem_bytes(Tq, Tk, hd, code) > 227 * 1024):
        raise ValueError(f"train_attention_bwd: q, k, v, g of {Tq}/{Tk} x {hd} do not "
                         "fit in shared memory")
    mask = _kernel_mask(key_mask, B, Tk, dev)
    scale_q = _scale(hd, q_flat.dtype)
    dq = torch.empty((B, Tq, D), dtype=q_flat.dtype, device=dev)
    dk, dv = (torch.empty((B, Tk, D), dtype=q_flat.dtype, device=dev) for _ in range(2))
    ptrs = (q_flat.data_ptr(), k_flat.data_ptr(), v_flat.data_ptr(), _ptr(mask),
            g_flat.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), B, Tq, Tk, D,
            num_heads, *lds, int(causal), scale_q, hd ** -0.5)
    if p.kernel == "wg":
        blocks = launch_grid(dev, Tq, Tk, B * num_heads, True)
        err = lib.kmb_train_attention_wg_bwd(*ptrs, blocks, p.smem_bytes, stream)
    else:
        err = lib.kmb_train_attention_bwd(*ptrs, code, stream)
    _cuda.check(err, "train_attention_bwd")
    count("launch.train_attention_bwd")
    if p.kernel == "legacy":
        count("launch.train_attention_bwd_legacy")
    return dq, dk, dv


class _TrainAttention(torch.autograd.Function):
    # the module-level names are looked up at call time, so a caller can
    # route both directions to the plain versions (chip_smoke.py does)

    @staticmethod
    def forward(ctx, q_flat, k_flat, v_flat, key_mask, num_heads, causal):
        ctx.save_for_backward(q_flat, k_flat, v_flat, key_mask)
        ctx.num_heads, ctx.causal = num_heads, causal
        return train_attention_flat(q_flat, k_flat, v_flat, key_mask,
                                    num_heads=num_heads, causal=causal)

    @staticmethod
    def backward(ctx, g):
        q_flat, k_flat, v_flat, key_mask = ctx.saved_tensors
        dq, dk, dv = train_attention_bwd(q_flat, k_flat, v_flat, key_mask,
                                         g.to(q_flat.dtype).contiguous(),
                                         num_heads=ctx.num_heads, causal=ctx.causal)
        return dq, dk, dv, None, None, None


def train_attention(q_flat, k_flat, v_flat, key_mask, *, num_heads, causal=False):
    """Differentiable fused attention (``train_attention_flat``'s contract);
    without autograd it is the forward alone."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q_flat, k_flat, v_flat)):
        return _TrainAttention.apply(q_flat, k_flat, v_flat, key_mask, num_heads, causal)
    return train_attention_flat(q_flat, k_flat, v_flat, key_mask, num_heads=num_heads,
                                causal=causal)
