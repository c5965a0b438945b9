"""K3: beam-stationary decode self-attention.

Counterpart of kmbart_tpu/ops/pallas_beam_attention.py. The self K/V cache
[B, K, T, D] is beam-stationary: a row is written once into the writer
beam's slot and never moved, and the int32 ``ancestry`` [B·K, T] says which
slot of the same sample holds position t's K/V for each live beam. Query
beam r attends position t <= cache_index through slot ancestry[r, t]. As in
the JAX reference (``beam_gather_attention_reference``), q, K, V and P are
rounded to bf16 whatever the cache dtype; scores, softmax and the PV sum
are fp32, and the output is fp32 [B·K, D].

The kernel (``csrc/beam_attention.cu``) runs a block per (sample, head):
it copies the sample's ancestry and the slab rows its beams descend
through into shared memory, in chunks of positions that ``beam_plan``
sizes, and gathers each beam's cache_index + 1 ancestor rows from there;
the TPU kernel scored every (slot, position) pair and masked them with the
one-hot ``sel`` that ``build_selection_mask`` builds. On an H100 the
generate step's 768 blocks run in two waves; layouts that fit one wave
(fewer threads a block, or a block per group of heads streaming its slab
through stages) measured slower, since every SM's share of the dot products
and P·V chains, not the waves, bounds the step (the kernel's source note). The plain version
keeps the TPU form (the one-hot mask and -1e9 fill), so the two are held
against each other.

Ring mode (``valid_counts`` given, int32 [B]) serves the continuous
pool's ring cache (kmbart_tpu/serving/continuous.py), where every slot
writes column ``tick % T``: ``cache_index`` is then that ring column, and
sample b reads the ``valid_counts[b]`` columns ending at it, cyclically
(column t iff (ring_col − t) mod T < valid_counts[b]); ancestry outside
the window is stale and ignored. The plain version builds
``build_selection_mask_ring``'s one-hot; the kernel visits the window
oldest first, so its sums run in the offline decode's order. Window
lengths are clamped to [1, T] on both sides (an inactive slot reads its own
newest column).

``beam_gather_attention`` is the wrapper: on CPU tensors it runs
``beam_gather_attention_plain``, on CUDA tensors it launches the kernel or
raises. It counts every launch as ``launch.beam_attention`` and those in
ring mode also as ``launch.beam_attention_ring`` (utils/profiling.py
``count``).
"""

from typing import NamedTuple

import torch

from kmbart_tpu_torch.ops import _cuda
from kmbart_tpu_torch.utils.profiling import count

NEG_INF = -1e9
# the bf16 kernel's shared memory: a budget that keeps five blocks on an SM
# (the whole slab of the main path's last step fits), and the card's limit
SMEM_BUDGET = 46 * 1024
SMEM_LIMIT = 227 * 1024


class BeamPlan(NamedTuple):
    """The bf16 kernel's layout for one call: positions [0, n) in chunks of
    ``chunk`` (K rows of every chunk, then V rows, two chunks in flight),
    ``smem`` bytes of shared memory a block, one block per (sample, head)."""
    n: int
    chunk: int
    nchunks: int
    smem: int


def beam_smem_bytes(K, n, hd, chunk):
    """csrc/beam_attention.cu beam_smem_bytes: two chunk buffers [K, chunk,
    hd] bf16, the queries [K, hd] bf16, the ancestry, the scores and two
    int32 per slab row (its place in a chunk buffer, its cache row), [K, n]
    each, and the fp32 accumulator [K, hd]."""
    return 2 * K * chunk * hd * 2 + K * hd * 2 + K * n * 16 + K * hd * 4


def beam_plan(K, cache_index, hd):
    """The chunk of positions the bf16 kernel stages at once: the whole
    slab (cache_index + 1 positions) when it fits ``SMEM_BUDGET``, else the
    most that does, and at least 8. Raises when that does not fit the
    card's shared memory."""
    n = cache_index + 1
    fixed = beam_smem_bytes(K, n, hd, 0)
    chunk = min(n, max(8, (SMEM_BUDGET - fixed) // (4 * K * hd)))
    smem = beam_smem_bytes(K, n, hd, chunk)
    if smem > SMEM_LIMIT:
        raise ValueError(f"beam_gather_attention kernel: {smem} bytes of shared memory for "
                         f"K {K}, {n} positions, head_dim {hd}")
    return BeamPlan(n, chunk, -(-n // chunk), smem)


def build_selection_mask(ancestry, num_beams, cache_index, num_heads):
    """One-hot ancestor-selection mask, as the TPU kernel consumes it:
    bf16 [B, K·T, K·H] with sel[b, j·T+t, q·H+h] = 1 iff
    ancestry[b·K+q, t] == j and t <= cache_index."""
    BK, T = ancestry.shape
    K = num_beams
    B = BK // K
    anc = ancestry.reshape(B, K, T)                                  # [B, q, t]
    j = torch.arange(K, dtype=ancestry.dtype, device=ancestry.device)
    sel = anc.transpose(1, 2)[:, None, :, :] == j[None, :, None, None]  # [B, j, t, q]
    t_ok = torch.arange(T, device=ancestry.device) <= cache_index
    sel = sel & t_ok[None, None, :, None]
    sel = sel.reshape(B, K * T, K, 1).expand(B, K * T, K, num_heads)
    return sel.reshape(B, K * T, K * num_heads).to(torch.bfloat16)


def build_selection_mask_ring(ancestry, num_beams, ring_col, valid_counts, num_heads):
    """``build_selection_mask`` for the ring cache
    (pallas_beam_attention.py:87): sample b's valid columns are the
    ``valid_counts[b]`` columns ending at ``ring_col``, cyclically."""
    BK, T = ancestry.shape
    K = num_beams
    B = BK // K
    anc = ancestry.reshape(B, K, T)
    j = torch.arange(K, dtype=ancestry.dtype, device=ancestry.device)
    sel = anc.transpose(1, 2)[:, None, :, :] == j[None, :, None, None]  # [B, j, t, q]
    age = torch.remainder(ring_col - torch.arange(T, device=ancestry.device), T)
    t_ok = age[None, :] < valid_counts.to(ancestry.device)[:, None]      # [B, T]
    sel = sel & t_ok[:, None, :, None]
    sel = sel.reshape(B, K * T, K, 1).expand(B, K * T, K, num_heads)
    return sel.reshape(B, K * T, K * num_heads).to(torch.bfloat16)


def beam_gather_attention_plain(q, k_cache, v_cache, ancestry, cache_index, *,
                                num_beams, num_heads, valid_counts=None):
    """Plain PyTorch version of the kernel, on any device.

    q [B·K, D] already scaled by head_dim**-0.5; k_cache, v_cache
    [B, K, T, D]; ancestry int [B·K, T]; cache_index: the newest valid
    position, or with ``valid_counts`` (int [B]) the ring column.
    Returns fp32 [B·K, D].
    """
    B, K, T, D = k_cache.shape
    H = num_heads
    hd = D // H
    bf16 = torch.bfloat16
    if valid_counts is None:
        sel = build_selection_mask(ancestry, K, cache_index, H)
    else:
        sel = build_selection_mask_ring(ancestry, K, cache_index,
                                        valid_counts.clamp(1, T), H)
    qh = q.reshape(B, K, H, hd).to(bf16).float()
    kh = k_cache.reshape(B, K, T, H, hd).to(bf16).float()
    vh = v_cache.reshape(B, K, T, H, hd).to(bf16).float()
    s_all = torch.einsum("bqhd,bjthd->bqhjt", qh, kh)                # [B, q, H, j, T]
    sel_q = sel.reshape(B, K, T, K, H).permute(0, 3, 4, 1, 2)        # [B, q, h, j, t]
    scores = torch.where(sel_q > 0, s_all, NEG_INF).reshape(B, K, H, K * T)
    m = scores.amax(dim=-1, keepdim=True)
    e = torch.exp(scores - m)
    probs = (e / e.sum(dim=-1, keepdim=True)).reshape(B, K, H, K, T)
    out = torch.einsum("bqhjt,bjthd->bqhd", probs.to(bf16).float(), vh)
    return out.reshape(B * K, D)


def beam_gather_attention(q, k_cache, v_cache, ancestry, cache_index, *,
                          num_beams, num_heads, valid_counts=None):
    """Beam-stationary decode self-attention; same contract as
    ``beam_gather_attention_plain`` (the kernel wants int32 ancestry and
    window lengths)."""
    if q.device.type == "cpu":
        return beam_gather_attention_plain(q, k_cache, v_cache, ancestry,
                                           cache_index, num_beams=num_beams,
                                           num_heads=num_heads, valid_counts=valid_counts)
    ring = valid_counts is not None
    dev = _cuda.require_cuda("beam_gather_attention", q, k_cache, v_cache, ancestry,
                             *((valid_counts,) if ring else ()))
    B, K, T, D = k_cache.shape
    H = num_heads
    if (K != num_beams or v_cache.shape != k_cache.shape or q.shape != (B * K, D)
            or ancestry.shape != (B * K, T) or D % H):
        raise ValueError(f"beam_gather_attention: shapes q {tuple(q.shape)}, cache "
                         f"{tuple(k_cache.shape)}, ancestry {tuple(ancestry.shape)}")
    if ancestry.dtype != torch.int32 or (ring and valid_counts.dtype != torch.int32):
        raise TypeError("beam_gather_attention kernel takes int32 ancestry and window lengths")
    if ring and valid_counts.shape != (B,):
        raise ValueError(f"beam_gather_attention: valid_counts {tuple(valid_counts.shape)} "
                         f"for {B} samples")
    if k_cache.dtype != v_cache.dtype:
        raise TypeError("beam_gather_attention: k and v cache dtypes differ")
    if not 0 <= cache_index < T:
        raise ValueError(f"cache_index {cache_index} outside [0, {T})")
    q_code, c_code = _cuda.dtype_code(q), _cuda.dtype_code(k_cache)
    chunk = 0
    if k_cache.dtype == torch.bfloat16:
        # 16-byte copies of head rows: head_dim % 8 == 0 and aligned bases
        if (D // H) % 8 or k_cache.data_ptr() % 16 or v_cache.data_ptr() % 16:
            raise ValueError("beam_gather_attention kernel takes head_dim % 8 == 0 and "
                             "16-byte aligned bf16 caches")
        # a ring call is planned for all T columns (no window is longer)
        chunk = beam_plan(K, T - 1 if ring else int(cache_index), D // H).chunk
    elif H > 32:
        raise ValueError("beam_gather_attention kernel takes at most 32 heads on an fp32 "
                         "cache")
    out = torch.empty((B * K, D), dtype=torch.float32, device=dev)
    lib, stream = _cuda.prepare(dev)
    _cuda.check(lib.kmb_beam_attention(
        q.data_ptr(), q_code, k_cache.data_ptr(), v_cache.data_ptr(), c_code,
        ancestry.data_ptr(), valid_counts.data_ptr() if ring else None, out.data_ptr(),
        B, K, T, D, H, int(cache_index), chunk, stream), "beam_gather_attention")
    count("launch.beam_attention")
    if ring:
        count("launch.beam_attention_ring")
    return out


