"""K4: per-chunk vocab statistics for the beam candidate step.

Counterpart of kmbart_tpu/ops/pallas_vocab_stats.py. Over the [R, V] fp32
logits viewed as chunks of 1024 columns it gives, per row and chunk,

    cm = max(chunk);   es = sum(exp(chunk - max(cm, FINITE_MIN)))

from which ``logsumexp_from_stats`` gives the row logsumexp. The kernel is
``csrc/vocab_stats.cu``; its source note says what bounds it on an H100 and
how the design answers that.

``chunk_stats`` is the wrapper: on CPU tensors it runs
``chunk_stats_plain``, on CUDA tensors it launches the kernel or raises.
Both take the logits as they are; the ragged tail chunk counts its missing
columns as -inf.
"""

import torch

from kmbart_tpu_torch.ops import _cuda
from kmbart_tpu_torch.ops.topk import CHUNK, pad_to_chunks

# Finite floor for the exp-shift: an entirely -inf chunk (forced BOS/EOS
# steps) has cm == -inf, and exp(-inf - -inf) would be NaN; shifting by
# max(cm, FINITE_MIN) gives exp(-inf - finite) == 0 instead.
FINITE_MIN = -3.0e38


def chunk_stats_plain(logits):
    """Plain PyTorch version of the kernel: (cm, es), each [R, C] fp32."""
    xr = pad_to_chunks(logits.float())
    cm = xr.amax(dim=-1)
    es = torch.exp(xr - torch.clamp(cm, min=FINITE_MIN)[..., None]).sum(dim=-1)
    return cm, es


def chunk_stats(logits):
    """(cm [R, C], es [R, C]) in one pass over the fp32 logits [R, V]."""
    if logits.device.type == "cpu":
        return chunk_stats_plain(logits)
    dev = _cuda.require_cuda("chunk_stats", logits)
    if logits.dim() != 2 or logits.dtype != torch.float32:
        raise TypeError(f"chunk_stats kernel takes fp32 [R, V] logits, got "
                        f"{logits.dtype} {tuple(logits.shape)}")
    R, V = logits.shape
    C = -(-V // CHUNK)
    cm = torch.empty((R, C), dtype=torch.float32, device=dev)
    es = torch.empty((R, C), dtype=torch.float32, device=dev)
    if R == 0:
        return cm, es
    lib, stream = _cuda.prepare(dev)
    _cuda.check(lib.kmb_vocab_stats(logits.data_ptr(), cm.data_ptr(), es.data_ptr(),
                                    R, V, CHUNK, stream), "chunk_stats")
    chunk_stats.launches += 1
    return cm, es


chunk_stats.launches = 0


def logsumexp_from_stats(cm, es):
    """Row logsumexp from per-chunk stats ([R, C] -> [R]); -inf-safe: an
    all -inf chunk adds exactly 0 and an all -inf row gives -inf."""
    m = torch.clamp(cm.amax(dim=1), min=FINITE_MIN)
    return m + torch.log((es * torch.exp(cm - m[:, None])).sum(dim=1))
