"""K7-K10: the tied LM head fused with the ignore-index cross-entropy.

Counterpart of kmbart_tpu/ops/pallas_lm_ce.py in its three modes. The
kernels are in ``csrc/lm_ce.cu``; its source note says what bounds them on
an H100 and how the design answers that.

``lm_ce_fwd`` (K7) projects h @ Wᵀ + bias, writes the logits in bf16 and
returns each row's max, exp-sum and label logit, taken on the rounded
logits. ``lm_ce_bwd`` (K8) forms dlogits = scale·(softmax − onehot) in
bf16 from the stored logits and the statistics, and dh = dlogits @ W.
``lm_ce_fwd_stats`` (K9) is K7 without the logits: the [N, V] tensor never
reaches memory. ``lm_ce_recompute_bwd`` (K10) is K8 with each logits tile
recomputed from (h, W, bias) with the same bf16 rounding. On CPU tensors
each runs its plain version (``*_plain``); on CUDA tensors it launches its
kernel or raises.

On the card K7, K9 and K10's first pass run on the wgmma + TMA GEMM of
``csrc/wgmma_gemm.cuh`` that K2 uses, on tiles of 256 rows that both
consumer warpgroups share (``coop_plan``, tiles walking rows fastest), each
consumer's chains those of the 128-row tiles K7 ran on before, so the three
agree bit for bit. K7 is the projection with an epilogue that stores the
bf16 logits and one partial (max, exp-sum, label logit) per row and
128-column tile, then a merge of each row's partials in a fixed order.
TMA's row pitch is a multiple of 16 bytes, so the logits live in an [N,
``padded_vocab(V)``] buffer and K7 returns its [:, :V] view (the whole
buffer when V % 8 == 0). K9 is the same projection and statistics with no
store and no tile buffers. K8 is one launch of its own
kernel (``csrc/lm_ce_bwd.cu``, laid out by ``bwd_plan``): a 64-row block
across the whole of D keeps its fp32 dh sum in registers while it walks
the vocab in 32-deep slices; each logits slice is turned into dlogits in
shared memory, stored once into an [N, ``padded_vocab(V)``] buffer (the pad
columns are zero) and fed as A to the dh product, so the dlogits never
come back from memory; the vocab walk splits into parts, summed in part
order, when 64-row blocks alone would leave SMs idle. K10's first pass
(``recompute_dlogits_pass``) is K7's projection on K9's tiles with an
epilogue that forms the same dlogits from the logits in registers and
writes them into the same padded buffer; its second pass (``dh_gemm``)
loads them on units of 128 rows by 384 columns (``dh_plan``) over K8's
vocab parts, each element the chain K8's kernel runs for it. K10's outputs
thus equal K8's on K7's logits bit for bit. Both return the [:, :V] view
of the buffer as their dlogits.

``fused_lm_ce`` is the differentiable loss, in one of the JAX package's
modes (pallas_lm_ce.py:385-396): "fwdbwd" (K7 + K8, the default), "nomat"
(K9 + K10) or "bwd" (the library projection and statistics in PyTorch,
then K8). dW = dlogitsᵀ @ h is a library matmul cast to the bf16 weight
dtype (pallas_lm_ce.py:426-431), and ``final_logits_bias`` gets no
gradient.
"""

import os
from typing import NamedTuple

import torch

from kmbart_tpu_torch.ops import _cuda
from kmbart_tpu_torch.ops.ffn import check_aligned, gemm_plan, sm_count
from kmbart_tpu_torch.parallel.distributed import global_count
from kmbart_tpu_torch.ops.layers import mm_f32
from kmbart_tpu_torch.utils.profiling import count

MIN_VOCAB = 1024   # pallas_lm_ce.DEFAULT_TILE_V: the JAX gate's vocab floor
TILE_V = 128       # csrc/lm_ce.cu BN: vocab columns per K7 block


def supported(n_rows, vocab_size, d_model, dtype):
    """The JAX gate (pallas_lm_ce.py:474-488) without its TPU and
    single-device clauses: ``KMBART_NO_FUSED_CE=1`` (read at call time)
    turns the kernels off; else rows in tiles of 8, d_model % 128 == 0, a
    vocab of at least 1024; and the kernels' bf16."""
    if os.environ.get("KMBART_NO_FUSED_CE") == "1":
        return False
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


def _check_fwd(name, h, w, fbias, labels):
    dev = _cuda.require_cuda(name, h, w, fbias, labels)
    (N, D), V = h.shape, w.shape[0]
    _check_head(name, w, D, h.dtype)
    if fbias.shape != (V,) or fbias.dtype != torch.float32:
        raise ValueError(f"{name}: bias must be fp32 [V]")
    if labels.shape != (N,) or labels.dtype != torch.int32:
        raise ValueError(f"{name}: labels must be int32 [N]")
    return dev, N, V, D


COOP_ROWS = 256   # csrc/wgmma_gemm.cuh StatsCoop, LogitsCoop, DlogitsCoop: a tile's rows (128 a consumer)


def coop_plan(n_rows, d_model, vocab_size, sms):
    """The launch plan of K7's, K9's and K10's first pass's projection
    ([N, V] = [N, D] @ [D, V], depth D) on a card with ``sms`` SMs:
    ``ffn.gemm_plan``'s grid without a split (the statistics need whole
    sums) on tiles of 256 rows by 128 columns, both consumer warpgroups on
    each tile (128 rows each), ``ctas`` the persistent blocks, at most one a
    tile. The kernel walks its tiles rows fastest (tile t is row tile t %
    row_tiles of column tile t // row_tiles), so the row tiles that share a
    W slice run together. Consumer cw of tile (r, c) writes the partials
    (and logits, or dlogits) of rows [256 r + 128 cw, 256 r + 128 cw + 128)
    at column index c = col0 / 128."""
    g = gemm_plan(n_rows, vocab_size, d_model, sms, False)
    row_tiles = -(-n_rows // COOP_ROWS)
    return g._replace(row_tiles=row_tiles, tile_rows=COOP_ROWS,
                      ctas=min(sms, row_tiles * g.col_tiles))


def _project_stats(wrapper, h, w, fbias, labels, store):
    """The launch of K7 on CUDA tensors, or of K9 when not ``store``, counted
    on ``wrapper``: (the logits buffer [N, padded_vocab(V)] or None, m, se,
    ll), both on ``coop_plan``."""
    name = wrapper.__name__
    dev, N, V, D = _check_fwd(name, h, w, fbias, labels)
    f32 = dict(dtype=torch.float32, device=dev)
    buf = (torch.empty((N, padded_vocab(V)), dtype=torch.bfloat16, device=dev)
           if store else None)
    m, se, ll = (torch.empty(N, **f32) for _ in range(3))
    if N == 0:
        return buf, m, se, ll
    parts = torch.empty((3, N, -(-V // TILE_V)), **f32)
    check_aligned(name, h, w, fbias, buf)
    g = coop_plan(N, D, V, sm_count(dev))
    lib, stream = _cuda.prepare(dev)
    _cuda.check(lib.kmb_lm_ce_fwd(
        h.data_ptr(), w.data_ptr(), fbias.data_ptr(), labels.data_ptr(),
        None if buf is None else buf.data_ptr(), parts.data_ptr(), m.data_ptr(),
        se.data_ptr(), ll.data_ptr(), N, V, D, 0 if buf is None else buf.shape[1], g.ctas,
        stream), name)
    count("launch." + name)
    return buf, m, se, ll


def lm_ce_fwd(h, w, fbias, labels):
    """K7; same contract as ``lm_ce_fwd_plain`` except that on a CUDA device
    h and w must be bf16, fbias fp32 and labels int32. The logits come back
    as a [:, :V] view of a buffer whose rows are ``padded_vocab(V)``
    apart."""
    if h.device.type == "cpu":
        return lm_ce_fwd_plain(h, w, fbias, labels)
    buf, m, se, ll = _project_stats(lm_ce_fwd, h, w, fbias, labels, True)
    return buf[:, :w.shape[0]], m, se, ll


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


def padded_vocab(vocab_size):
    """The row pitch of the dlogits buffer of K8 and K10: the vocab rounded up
    to 8 columns (16 bytes of bf16), the multiple TMA needs."""
    return -(-vocab_size // 8) * 8


BWD_ROWS = 64      # csrc/lm_ce_bwd.cu ROWS: a work unit's rows
BWD_SLICE = 32     # SK: the vocab slice depth
BWD_GROUP = 768    # GROUP_COLS: a unit's columns (two warpgroups x 384)
# bwd_plan's cost of an extra vocab part, in slices: finalize_sum writes and
# reads its fp32 partials (8 N D bytes) at about 3 TB/s, and a 32-deep slice
# of a 64 x 768 unit takes 0.5-0.75 us on an H100, so 1.5-2.2 MB cost one
# slice (the plans over that range take 3 parts at N 5120 and 7 or 8 at N
# 9216, which a sweep of part counts timed alike)
PARTIAL_BYTES_PER_SLICE = 1.5e6
MAX_SPLITS = 64


class BwdPlan(NamedTuple):
    """K8's launch plan (``bwd_plan``): N rows, D columns, V deep, in units
    of 64 rows by 768 columns by ``kper`` 32-deep vocab slices."""
    rows: int
    cols: int
    depth: int
    row_blocks: int
    groups: int
    splits: int
    kper: int
    ctas: int

    @property
    def units(self):
        return self.row_blocks * self.groups * self.splits


def bwd_plan(n_rows, d_model, vocab_size, sms, splits=None):
    """The launch plan of K8's kernel (whose vocab parts K10's second pass
    takes, ``dh_plan``) on a card with ``sms`` SMs. A unit is a
    64-row block across a 768-column group of D (one group at D 768) over
    one part of the vocab walk; units run parts slowest, then row blocks,
    then groups, block b taking units b, b + ctas, ... The vocab walk of
    ceil(V / 32) slices is split into parts of ``kper`` slices (the last may
    be shorter, none empty) when that shortens the critical path, the
    persistent waves times kper, by more than the parts' fp32 partials cost
    (``PARTIAL_BYTES_PER_SLICE``); ``splits`` forces a part count (a test
    hook). finalize_sum adds the parts in part order."""
    row_blocks = -(-n_rows // BWD_ROWS)
    groups = -(-d_model // BWD_GROUP)
    ksteps = -(-vocab_size // BWD_SLICE)
    best = None
    for want in ([splits] if splits else range(1, min(MAX_SPLITS, ksteps) + 1)):
        kper = -(-ksteps // want)
        parts = -(-ksteps // kper)
        units = row_blocks * groups * parts
        cost = -(-units // sms) * kper
        if parts > 1:
            cost += parts * 8 * n_rows * d_model / PARTIAL_BYTES_PER_SLICE
        if best is None or cost < best[0]:
            best = (cost, parts, kper, units)
    _, parts, kper, units = best
    return BwdPlan(n_rows, d_model, vocab_size, row_blocks, groups, parts, kper,
                   min(sms, units))


DH_ROWS = 128     # csrc/lm_ce_bwd.cu DH_ROWS: a unit's rows in K10's second pass
DH_COLS = 384     # DH_COLS: its columns, half of D 768


def dh_plan(n_rows, d_model, vocab_size, sms):
    """The launch plan of K10's second pass on a card with ``sms`` SMs:
    K8's vocab parts (``bwd_plan``'s splits and kper, so that every dh
    element sums the same slices in the same parts as K8's kernel) on units
    of 128 rows by a 384-column block of D (``groups``: two halves at D
    768). Units run parts slowest, then row blocks, then column blocks, so
    the halves of a row block run side by side and share its dlogits rows in
    L2; block b takes units b, b + ctas, ... At the heads the unit count is
    K8's (rows / 128 x 2 = rows / 64)."""
    k8 = bwd_plan(n_rows, d_model, vocab_size, sms)
    row_blocks = -(-n_rows // DH_ROWS)
    groups = -(-d_model // DH_COLS)
    return BwdPlan(n_rows, d_model, vocab_size, row_blocks, groups, k8.splits, k8.kper,
                   min(sms, row_blocks * groups * k8.splits))


def _check_stats(name, N, m, inv_se, scale, labels):
    for t in (m, inv_se, scale):
        if t.shape != (N,) or t.dtype != torch.float32:
            raise ValueError(f"{name}: statistics must be fp32 [N]")
    if labels.shape != (N,) or labels.dtype != torch.int32:
        raise ValueError(f"{name}: labels must be int32 [N]")


def _bwd_launch(name, logits, w, m, inv_se, scale, labels, splits=None):
    """K8's launch on CUDA tensors (checked by the caller): the bf16 dlogits
    in an [N, padded_vocab(V)] buffer with zero pad columns, and dh. The
    kernel reads the logits by TMA, whose row pitch must be a multiple of 16
    bytes: K7's buffer is, a contiguous [N, V] with V % 8 != 0 is copied
    into one that is. ``splits`` forces the plan's part count (a test
    hook)."""
    N, V = logits.shape
    D = w.shape[1]
    if N > 1 and logits.stride(0) % 8:
        padded = torch.empty((N, padded_vocab(V)), dtype=logits.dtype, device=logits.device)
        padded[:, :V] = logits
        logits = padded[:, :V]
    dl = torch.empty((N, padded_vocab(V)), dtype=torch.bfloat16, device=logits.device)
    dh = torch.empty((N, D), dtype=torch.bfloat16, device=logits.device)
    g = bwd_plan(N, D, V, sm_count(logits.device), splits)
    partial = (torch.empty((g.splits, N, D), dtype=torch.float32, device=logits.device)
               if g.splits > 1 else None)
    check_aligned(name, logits, w, dl, dh, partial)
    lib, stream = _cuda.prepare(logits.device)
    _cuda.check(lib.kmb_lm_ce_bwd(
        logits.data_ptr(), w.data_ptr(), m.data_ptr(), inv_se.data_ptr(), scale.data_ptr(),
        labels.data_ptr(), dl.data_ptr(), dh.data_ptr(),
        None if partial is None else partial.data_ptr(), N, V, D,
        logits.stride(0) if N > 1 else padded_vocab(V), dl.shape[1],
        g.ctas, g.splits, g.kper, stream), name)
    return dl, dh


def dh_gemm(name, dl, V, w):
    """K10's second pass on CUDA tensors (checked by the caller): dh =
    dl[:, :V] @ w on 128-row units (``dh_plan``), whose dh equals K8's bit
    for bit on the same dlogits."""
    N, D = dl.shape[0], w.shape[1]
    dh = torch.empty((N, D), dtype=torch.bfloat16, device=dl.device)
    g = dh_plan(N, D, V, sm_count(dl.device))
    partial = (torch.empty((g.splits, N, D), dtype=torch.float32, device=dl.device)
               if g.splits > 1 else None)
    check_aligned(name, dl, w, dh, partial)
    lib, stream = _cuda.prepare(dl.device)
    _cuda.check(lib.kmb_lm_ce_dh(
        dl.data_ptr(), w.data_ptr(), dh.data_ptr(),
        None if partial is None else partial.data_ptr(), N, V, dl.shape[1], D, g.ctas,
        g.splits, g.kper, stream), f"{name} dh")
    return dh


def lm_ce_bwd(logits, w, m, inv_se, scale, labels):
    """K8; same contract as ``lm_ce_bwd_plain`` except that on a CUDA device
    logits and w must be bf16, the statistics fp32 and labels int32. The
    dlogits come back as a [:, :V] view of a buffer whose rows are
    ``padded_vocab(V)`` apart."""
    if logits.device.type == "cpu":
        return lm_ce_bwd_plain(logits, w, m, inv_se, scale, labels)
    _cuda.require_cuda("lm_ce_bwd", logits, w, m, inv_se, scale, labels, contiguous=False)
    _cuda.require_cuda("lm_ce_bwd", w, m, inv_se, scale, labels)
    N = logits.shape[0]
    V, D = w.shape
    _check_head("lm_ce_bwd", w, D, logits.dtype)
    if logits.shape != (N, V):
        raise ValueError(f"lm_ce_bwd: logits {tuple(logits.shape)} for w {tuple(w.shape)}")
    if N > 1 and (logits.stride(1) != 1 or logits.stride(0) < V):
        raise ValueError("lm_ce_bwd kernel takes logits rows that are contiguous")
    _check_stats("lm_ce_bwd", N, m, inv_se, scale, labels)
    if N == 0:
        return torch.empty_like(logits), torch.empty((0, D), dtype=w.dtype, device=w.device)
    dl, dh = _bwd_launch("lm_ce_bwd", logits, w, m, inv_se, scale, labels)
    count("launch.lm_ce_bwd")
    return dl[:, :V], dh


def lm_ce_fwd_stats_plain(h, w, fbias, labels):
    """Plain PyTorch version of K9, on any device: K7's statistics (m, se,
    ll [N] fp32) without returning the logits."""
    return lm_ce_fwd_plain(h, w, fbias, labels)[1:]


def lm_ce_fwd_stats(h, w, fbias, labels):
    """K9; same contract as ``lm_ce_fwd_stats_plain`` except that on a CUDA
    device h and w must be bf16, fbias fp32 and labels int32. No [N, V]
    tensor is allocated."""
    if h.device.type == "cpu":
        return lm_ce_fwd_stats_plain(h, w, fbias, labels)
    _, m, se, ll = _project_stats(lm_ce_fwd_stats, h, w, fbias, labels, False)
    return m, se, ll


def lm_ce_recompute_bwd_plain(h, w, fbias, m, inv_se, scale, labels):
    """Plain PyTorch version of K10, on any device: K8 on the logits
    recomputed as K7 rounds them. Returns (dlogits in h's dtype, dh in w's
    dtype)."""
    logits = (h.float() @ w.float().t() + fbias.float()).to(h.dtype)
    return lm_ce_bwd_plain(logits, w, m, inv_se, scale, labels)


def recompute_dlogits_pass(h, w, fbias, m, inv_se, scale, labels):
    """K10's first pass on CUDA tensors (checked by the caller): K7's
    projection with the dlogits epilogue on ``coop_plan``'s tiles, into an
    [N, padded_vocab(V)] buffer with zero pad columns, as K8 writes it."""
    (N, D), V = h.shape, w.shape[0]
    dl = torch.empty((N, padded_vocab(V)), dtype=torch.bfloat16, device=h.device)
    check_aligned("lm_ce_recompute_bwd", h, w, fbias, dl)
    g = coop_plan(N, D, V, sm_count(h.device))
    lib, stream = _cuda.prepare(h.device)
    _cuda.check(lib.kmb_lm_ce_recompute_dlogits(
        h.data_ptr(), w.data_ptr(), fbias.data_ptr(), m.data_ptr(), inv_se.data_ptr(),
        scale.data_ptr(), labels.data_ptr(), dl.data_ptr(), N, V, dl.shape[1], D, g.ctas,
        stream), "lm_ce_recompute_bwd dlogits")
    return dl


def lm_ce_recompute_bwd(h, w, fbias, m, inv_se, scale, labels):
    """K10; same contract as ``lm_ce_recompute_bwd_plain`` except that on a
    CUDA device h and w must be bf16, fbias and the statistics fp32 and
    labels int32. ``recompute_dlogits_pass``, then ``dh_gemm`` over its
    padded buffer; the dlogits come back as ``lm_ce_bwd`` returns them."""
    if h.device.type == "cpu":
        return lm_ce_recompute_bwd_plain(h, w, fbias, m, inv_se, scale, labels)
    dev, N, V, D = _check_fwd("lm_ce_recompute_bwd", h, w, fbias, labels)
    _check_stats("lm_ce_recompute_bwd", N, m, inv_se, scale, labels)
    if N == 0:
        return (torch.empty((0, V), dtype=torch.bfloat16, device=dev),
                torch.empty((0, D), dtype=torch.bfloat16, device=dev))
    dl = recompute_dlogits_pass(h, w, fbias, m, inv_se, scale, labels)
    dh = dh_gemm("lm_ce_recompute_bwd", dl, V, w)
    count("launch.lm_ce_recompute_bwd")
    return dl[:, :V], dh


MODES = ("fwdbwd", "nomat", "bwd")


def _fwd_materialized(h2, w_b, fbias, safe_labels):
    """Mode "bwd"'s forward (pallas_lm_ce.py:398-406): the library
    projection rounded to the compute dtype, then the statistics in
    PyTorch."""
    logits = (mm_f32(h2, w_b.t()) + fbias).to(h2.dtype)
    lf = logits.float()
    m = lf.amax(dim=-1)
    se = torch.exp(lf - m[:, None]).sum(dim=-1)
    ll = logits.gather(1, safe_labels.long()[:, None])[:, 0].float()
    return logits, m, se, ll


class _FusedNll(torch.autograd.Function):
    """Sum over valid rows of -log softmax(h Wᵀ + bias)[label]; the
    counterpart of _fused_nll_fn's custom VJP (pallas_lm_ce.py:385) in each
    mode. The kernel wrappers are looked up at call time, so a caller can
    route both directions to the plain versions."""

    @staticmethod
    def forward(ctx, h2, w_b, fbias, safe_labels, valid, mode):
        ctx.mode = mode
        if mode == "nomat":
            m, se, ll = lm_ce_fwd_stats(h2, w_b, fbias, safe_labels)
            ctx.save_for_backward(h2, w_b, fbias, m, se, safe_labels, valid)
        else:
            fwd = lm_ce_fwd if mode == "fwdbwd" else _fwd_materialized
            logits, m, se, ll = fwd(h2, w_b, fbias, safe_labels)
            ctx.save_for_backward(h2, w_b, logits, m, se, safe_labels, valid)
        return torch.where(valid, torch.log(se) + m - ll, 0.0).sum()

    @staticmethod
    def backward(ctx, g):
        h2, w_b, saved, m, se, safe_labels, valid = ctx.saved_tensors
        scale = (g * valid.float()).contiguous()
        inv_se = (1.0 / se).contiguous()
        if ctx.mode == "nomat":
            dl, dh = lm_ce_recompute_bwd(h2, w_b, saved, m, inv_se, scale, safe_labels)
        else:
            dl, dh = lm_ce_bwd(saved, w_b, m, inv_se, scale, safe_labels)
        # the cotangent of the rounded W in its dtype, as XLA's dot
        # transpose emits it on the composite path
        dw = mm_f32(dl.t(), h2).to(w_b.dtype)
        return dh, dw, None, None, None, None


def resolve_mode(mode=None, recompute=None):
    """The mode as pallas_lm_ce.fused_lm_ce picks it (:506-510): ``mode``,
    else "nomat"/"bwd" from ``recompute``, else ``KMBART_FUSED_CE_MODE``,
    else "fwdbwd"."""
    if mode is None:
        if recompute is not None:
            mode = "nomat" if recompute else "bwd"
        else:
            mode = os.environ.get("KMBART_FUSED_CE_MODE", "fwdbwd")
    if mode not in MODES:
        raise ValueError(f"fused_lm_ce: mode {mode!r} is not one of {MODES}")
    return mode


def fused_lm_ce(hidden, shared, final_logits_bias, labels, *, ignore_index=-100,
                dtype=torch.bfloat16, recompute=None, mode=None):
    """``lm_logits`` + ``cross_entropy_ignore_index`` in one op. hidden
    [..., D]; shared [V, D] (the fp32 tied embedding); final_logits_bias
    [V] or [1, V] (no gradient); labels [...]. ``mode`` and ``recompute``
    as ``resolve_mode`` reads them. Returns (mean loss over the valid
    positions, their count), as the composite path does; the count is
    ``global_count``'s."""
    mode = resolve_mode(mode, recompute)
    d = hidden.shape[-1]
    h2 = hidden.reshape(-1, d).to(dtype).contiguous()
    w_b = shared.to(dtype)
    labels2 = labels.reshape(-1)
    valid = labels2 != ignore_index
    safe = torch.where(valid, labels2, 0).to(torch.int32).contiguous()
    fbias = final_logits_bias.detach().reshape(-1).float().contiguous()
    nll = _FusedNll.apply(h2, w_b, fbias, safe, valid, mode)
    cnt = global_count(valid.sum())
    return nll / cnt.clamp(min=1), cnt
