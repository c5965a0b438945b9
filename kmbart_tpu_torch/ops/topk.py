"""Exact top-k with ``lax.top_k``'s tie order, and the chunk view.

Counterpart of kmbart_tpu/ops/topk.py. The order: values descending, and
among equal values the lowest index first (topk.py:22-24); -0.0 equals
+0.0. ``torch.topk`` does not document its tie order; a stable descending
sort does give it, and ``top_k`` is that sort. There the chunk-max walk and
the radix select stand in for ``lax.top_k``, which lowers to a full sort on
the TPU (topk.py:3-7); on the card the same function is K4's selection,
and ``ops/vocab_stats.exact_top_k`` routes to it.
"""

import math

import torch

CHUNK = 1024


def top_k(x, k):
    """(values, indices) of the k largest entries of each row of x, sorted
    descending, ties broken by the lowest index. Indices are int64."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def pad_to_chunks(x):
    """[B, N] -> [B, C, CHUNK] padded view (-inf fill)."""
    B, N = x.shape
    C = -(-N // CHUNK)
    if C * CHUNK != N:
        x = torch.nn.functional.pad(x, (0, C * CHUNK - N), value=-math.inf)
    return x.reshape(B, C, CHUNK)
