"""K4: per-chunk vocab statistics and each row's exact top-k, in one pass.

Counterpart of kmbart_tpu/ops/pallas_vocab_stats.py and of the selections
the JAX package runs on its output (``topk_from_chunk_stats`` on the beam
step, ``radix_top_k`` on fast sampling, kmbart_tpu/ops/topk.py). Over the
[R, N] fp32 logits viewed as chunks of 1024 columns it gives, per row and
chunk,

    cm = max(chunk);   es = sum(exp(chunk - max(cm, FINITE_MIN)))

from which ``logsumexp_from_stats`` gives the row logsumexp, and each row's
k largest entries, values descending and equal values lowest index first
(-0.0 equal to +0.0), the order of ``topk.top_k``. The kernel is
``csrc/vocab_stats.cu``; its source note says what bounds it on an H100 and
how the design answers that.

``chunk_stats_topk`` is the wrapper: on CPU tensors it runs
``chunk_stats_topk_plain``, on CUDA tensors it launches the kernel or
raises. Both take the logits as they are; the ragged tail chunk counts its
missing columns as -inf. The kernel takes 1 <= k <= min(N, 1024)
(``kernel_takes``); ``stats_top_k`` and ``exact_top_k``, what the
generation paths call, route by that shape rule: a CUDA call the kernel
takes goes to it, any other k to the stable sort (with the statistics
from the kernel at k 0), every CPU call to the plain version.
"""

import torch

from kmbart_tpu_torch.ops import _cuda
from kmbart_tpu_torch.ops.topk import CHUNK, pad_to_chunks, top_k
from kmbart_tpu_torch.utils.profiling import count

# Finite floor for the exp-shift: an entirely -inf chunk (forced BOS/EOS
# steps) has cm == -inf, and exp(-inf - -inf) would be NaN; shifting by
# max(cm, FINITE_MIN) gives exp(-inf - finite) == 0 instead.
FINITE_MIN = -3.0e38


def chunk_stats_plain(logits):
    """Plain PyTorch version of the statistics: (cm, es), each [R, C] fp32."""
    xr = pad_to_chunks(logits.float())
    cm = xr.amax(dim=-1)
    es = torch.exp(xr - torch.clamp(cm, min=FINITE_MIN)[..., None]).sum(dim=-1)
    return cm, es


def chunk_stats_topk_plain(logits, k, stats=True):
    """Plain PyTorch version of the kernel: ``chunk_stats_plain`` (or None,
    None without ``stats``) and the stable sort's top-k."""
    cm, es = chunk_stats_plain(logits) if stats else (None, None)
    values, indices = top_k(logits, k)
    return cm, es, values, indices


def chunk_stats_topk(logits, k, stats=True):
    """(cm [R, C], es [R, C], values [R, k], indices [R, k]) in one pass over
    the fp32 logits [R, N]: K4's statistics (None, None without ``stats``)
    and each row's top-k as ``topk.top_k`` gives it (fp32 values, int64
    indices). On the card, 0 <= k <= min(N, 1024)."""
    if logits.device.type == "cpu":
        return chunk_stats_topk_plain(logits, k, stats)
    dev = _cuda.require_cuda("chunk_stats_topk", logits)
    if logits.dim() != 2 or logits.dtype != torch.float32:
        raise TypeError(f"chunk_stats_topk kernel takes fp32 [R, N] logits, got "
                        f"{logits.dtype} {tuple(logits.shape)}")
    R, N = logits.shape
    if not 0 <= k <= min(N, CHUNK):
        raise ValueError(f"chunk_stats_topk kernel takes 0 <= k <= min(N, {CHUNK}), "
                         f"got k {k} at N {N}")
    C = -(-N // CHUNK)
    f32 = dict(dtype=torch.float32, device=dev)
    cm = torch.empty((R, C), **f32) if stats else None
    es = torch.empty((R, C), **f32) if stats else None
    values = torch.empty((R, k), **f32)
    indices = torch.empty((R, k), dtype=torch.long, device=dev)
    if R == 0 or not (stats or k):
        return cm, es, values, indices
    # the chunk candidates: 64-bit keys, [R, C, k]
    keys = torch.empty((R, C, k), dtype=torch.int64, device=dev) if k else None
    ptr = lambda t: None if t is None else t.data_ptr()
    vec4 = int(N % 4 == 0 and logits.data_ptr() % 16 == 0)
    lib, stream = _cuda.prepare(dev)
    _cuda.check(lib.kmb_vocab_stats_topk(logits.data_ptr(), ptr(cm), ptr(es), ptr(keys),
                                         R, N, CHUNK, k, vec4, stream), "chunk_stats_topk")
    count("launch.vocab_stats_topk")
    if k:
        _cuda.check(lib.kmb_topk_merge(logits.data_ptr(), keys.data_ptr(), values.data_ptr(),
                                       indices.data_ptr(), R, N, C, k, stream),
                    "chunk_stats_topk merge")
        count("launch.vocab_topk_merge")
    return cm, es, values, indices


def chunk_stats(logits):
    """(cm [R, C], es [R, C]) alone: ``chunk_stats_topk`` at k 0."""
    cm, es, _, _ = chunk_stats_topk(logits, 0)
    return cm, es


def kernel_takes(n, k):
    """Whether K4's selection takes a top-k of k over rows of n columns: a
    chunk hands over at most its 1024 columns, and the merge ranks its k
    survivors in shared memory."""
    return 1 <= k <= min(n, CHUNK)


def stats_top_k(logits, k):
    """(cm, es, values, indices) of the fp32 logits [R, N], routed by shape:
    on a CUDA tensor one ``chunk_stats_topk`` call where ``kernel_takes(N,
    k)``, else the statistics from K4 at k 0 and the top-k from the stable
    sort; on a CPU tensor the plain version. All give the same numbers."""
    if logits.device.type == "cpu" or kernel_takes(logits.shape[1], k):
        return chunk_stats_topk(logits, k)
    cm, es = chunk_stats(logits)
    return (cm, es, *top_k(logits, k))


def exact_top_k(x, k):
    """``top_k`` of a 2-D x (the counterpart of kmbart_tpu/ops/topk.py:35
    exact_top_k), routed by shape: on a CUDA tensor K4's selection with its
    statistics off where ``kernel_takes(N, k)``, else the stable sort; on a
    CPU tensor the sort. Both give the same values and indices."""
    if x.device.type == "cpu" or not kernel_takes(x.shape[1], k):
        return top_k(x, k)
    _, _, vals, idx = chunk_stats_topk(x.contiguous(), k, stats=False)
    return vals, idx


def logsumexp_from_stats(cm, es):
    """Row logsumexp from per-chunk stats ([R, C] -> [R]); -inf-safe: an
    all -inf chunk adds exactly 0 and an all -inf row gives -inf."""
    m = torch.clamp(cm.amax(dim=1), min=FINITE_MIN)
    return m + torch.log((es * torch.exp(cm - m[:, None])).sum(dim=1))
