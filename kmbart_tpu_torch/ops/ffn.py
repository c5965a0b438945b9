"""K2: fused FFN, y = gelu(x @ W1ᵀ + b1) @ W2ᵀ + b2, forward and backward.

Counterpart of kmbart_tpu/ops/pallas_ffn.py. Both kernels are in
``csrc/ffn.cu``; their source notes say what bounds them on an H100 and how
the design answers that.

``fused_ffn`` wraps the forward: on CPU tensors it runs ``fused_ffn_plain``,
on CUDA tensors it launches the kernel or raises. Both round where the
composite dense → gelu → dense does: a = bf16(x@W1ᵀ + b1), h = bf16(gelu(a))
with exact erf in fp32, y = bf16(h@W2ᵀ + b2), fp32 accumulation throughout;
with ``with_a`` they also return the bf16 ``a`` (the backward's residual).
``fused_ffn_bwd`` wraps the backward (da = bf16(g@W2 · gelu′(a)),
dx = bf16(da@W1)) the same way, and ``ffn`` is the differentiable op the
model calls: its backward runs the kernel and leaves the weight and bias
gradients to library products and reductions, as pallas_ffn.py:288-303
leaves them to XLA. Weights are ``fc1.weight`` [F, D] and ``fc2.weight``
[D, F].

On the card each direction is two GEMMs: the forward writes h =
bf16(gelu(a)) into an [N, F] scratch that the second GEMM reads back, the
backward writes da and reads it back. ``train_plan`` lays out the
training forward (with ``a``) and the backward: ``plan``'s Legacy tiles,
the first GEMM's epilogue on its direction's training layout (F1's from
TABLE_MIN_DEPTH);
``infer_plan`` the inference forward (without ``a``), whose
second GEMM walks its depth in the same INFERENCE_KPER parts at every N
and sums them on the SM, bit for bit what ``fused_ffn_partials``
(``plan``'s Legacy layout with the same parts through an fp32 buffer and
a third launch) gives.
"""

import functools
import math
from typing import NamedTuple

import torch

from kmbart_tpu_torch.ops import _cuda
from kmbart_tpu_torch.ops.layers import mm_f32
from kmbart_tpu_torch.utils.profiling import count

_INV_SQRT2 = 1.0 / math.sqrt(2.0)
_INV_SQRT_2PI = 1.0 / math.sqrt(2.0 * math.pi)
ROW_TILE = 128    # csrc/ffn.cu BM: output tile rows
COL_TILE = 128    # csrc/ffn.cu BN: output tile columns
K_TILE = 64       # csrc/ffn.cu BK: the depth of one pipeline stage


def _gelu_f32(z):
    return z * 0.5 * (1.0 + torch.erf(z * _INV_SQRT2))


def _dgelu_f32(z):
    # d/dz [z Phi(z)] = Phi(z) + z phi(z)
    return 0.5 * (1.0 + torch.erf(z * _INV_SQRT2)) + z * _INV_SQRT_2PI * torch.exp(-0.5 * z * z)


def fused_ffn_plain(x, w1, b1, w2, b2, with_a=False):
    """Plain PyTorch version of the kernel, on any device. x [..., D] bf16;
    w1 [F, D], w2 [D, F] (any float dtype, rounded to bf16); b1 [F], b2 [D]
    fp32. Returns bf16 [..., D], and the bf16 [..., F] pre-activation when
    ``with_a``."""
    bf16 = torch.bfloat16
    a = (x.to(bf16).float() @ w1.to(bf16).float().t() + b1.float()).to(bf16)
    h = _gelu_f32(a.float()).to(bf16)
    y = (h.float() @ w2.to(bf16).float().t() + b2.float()).to(bf16)
    return (y, a) if with_a else y


def supported(d, f):
    """Widths the kernel takes (the wrapper raises on others): any D % 16 and
    F % 64 (TMA zero-fills the tiles' ragged edges)."""
    return d % 16 == 0 and f % 64 == 0


class GemmPlan(NamedTuple):
    """One GEMM of a K2 or K2b call (or the projection of K7, K9 and K10's
    first pass, ops/lm_ce.py coop_plan): [rows, cols] = [rows, depth] @ [depth, cols] in ``tile_rows``
    x ``tile_cols`` output tiles, with the depth walk in ``splits`` parts of
    ``kper`` K_TILE-deep slices each (the last part may be shorter): split
    p covers depth [p·kper·K_TILE, min(depth, (p+1)·kper·K_TILE)), and the
    parts are added in split order. ``mode`` says where the parts meet:
    "plain" (each split is its own tile, t of row_tiles·col_tiles·splits,
    columns fastest, then rows, then splits, computed by block t % ctas of
    the persistent grid; the parts through an fp32 buffer), "sum" (tile t
    of row_tiles·col_tiles walks every part, block t % ctas) or "cluster"
    (clusters of ``cluster`` blocks, splits / cluster parts each: block t of
    the ctas = row_tiles·col_tiles·cluster takes parts r·splits/cluster, ...
    of tile t // cluster, r = t % cluster). ``layout`` names a training
    layout (TRAIN_LAYOUTS): the first GEMM's epilogue, on Legacy's tiles."""
    rows: int
    cols: int
    depth: int
    row_tiles: int
    col_tiles: int
    splits: int
    kper: int
    ctas: int
    tile_rows: int = ROW_TILE
    mode: str = "plain"
    cluster: int = 1
    tile_cols: int = COL_TILE
    layout: str = "legacy"


# An inference forward walks the second GEMM's depth in parts of this many
# K_TILE slices at every row count, so a row's bits do not depend on the batch
# it shares (a split chosen from the row count would change the order of the
# fp32 sums between a 32-sample and a 112-sample decode step).
INFERENCE_KPER = 8


def gemm_plan(rows, cols, depth, sms, split, kper=None):
    """``split``: split the depth walk when the output tiles alone would
    leave SMs idle; ``kper``: walk it in parts of ``kper`` slices whatever
    the row count (overrides ``split``)."""
    row_tiles, col_tiles = -(-rows // ROW_TILE), -(-cols // COL_TILE)
    ksteps = -(-depth // K_TILE)
    if kper is not None:
        kper = min(kper, ksteps)
    else:
        kper = ksteps
        if split:
            want = max(1, min(ksteps, sms // (row_tiles * col_tiles)))
            kper = -(-ksteps // want)
    splits = -(-ksteps // kper)
    return GemmPlan(rows, cols, depth, row_tiles, col_tiles, splits, kper,
                    min(sms, row_tiles * col_tiles * splits))


def plan(n, d, f, sms, invariant=False):
    """The launch plan of one call at N rows, D and F widths, on a card with
    ``sms`` SMs (one persistent block each): (first GEMM, second GEMM). The
    first (x @ W1ᵀ or g @ W2, [N, F] over depth D) feeds a nonlinear epilogue
    and never splits. The second (h @ W2ᵀ or da @ W1, [N, D] over depth F)
    splits its depth walk into fp32 partials: with ``invariant`` (the
    inference forward on the partials route, ``fused_ffn_partials``) in
    parts of INFERENCE_KPER slices at any N, else when its tiles alone would
    leave SMs idle (training, where N is the same every step and large)."""
    return gemm_plan(n, f, d, sms, False), gemm_plan(
        n, d, f, sms, True, kper=INFERENCE_KPER if invariant else None)


# csrc/wgmma_gemm.cuh: the depth modes (their codes), and the portable
# cluster size, which is also the most parts a cluster's tile may have
# (cluster_reduce reads that many at most): one or two parts a block
MODES = {"plain": 0, "sum": 1, "cluster": 2}
MAX_CLUSTER = 8
# F2's cluster modes, "cluster<parts a block>@<rows>x<cols>": (parts a
# block, tile), in the order infer_plan tries them. The tiles are
# csrc/wgmma_gemm.cuh's layouts, each consumer's share an m64n128
# accumulator: 64 x 128 (one consumer a tile), 64 x 256 (the two
# consumers' columns side by side). "sum" takes 128 x 128 tiles (the two
# consumers on their 64-row halves), F1 128 x 128 (ping-pong) or 64 x 128.
CLUSTER_MODES = {"cluster1@64x128": (1, (64, 128)), "cluster1@64x256": (1, (64, 256)),
                 "cluster2@64x256": (2, (64, 256))}


def _tiles(n, cols, tile):
    return -(-n // tile[0]), -(-cols // tile[1])


def _one_wave(n, cols, tile, at_once):
    """Whether ``at_once`` blocks (or clusters) take every tile at once."""
    rt, ct = _tiles(n, cols, tile)
    return rt * ct <= at_once


def _at_once(size, sms, slots):
    """Clusters of ``size`` blocks the card holds at once."""
    return (slots or {}).get(size, sms // size)


def f2_modes(splits, sms, slots=None):
    """{F2 mode: (tile, blocks a cluster)} the card can run for ``splits``
    parts: "sum" (128 x 128 tiles, persistent), and the cluster modes whose
    tile has at most MAX_CLUSTER parts and whose cluster size the card holds
    (``slots``, cluster_slots; default sms // size)."""
    out = {"sum": ((128, 128), 1)}
    for mode, (ppc, tile) in CLUSTER_MODES.items():
        size = splits // ppc
        if splits % ppc == 0 and splits <= MAX_CLUSTER and _at_once(size, sms, slots):
            out[mode] = (tile, size)
    return out


def infer_plan(n, d, f, sms, slots=None, mode=None):
    """The launch plan of an inference forward (no ``a``) at N rows, D and
    F widths, on ``sms`` SMs: (F1, F2), as csrc/ffn.cu kmb_ffn_infer runs
    them. F1 ([N, F] over depth D, the GELU epilogue; never split) takes
    64-row tiles when they all fit in one wave of the SMs (a decode step),
    else 128-row ones. F2 ([N, D] over depth F) walks its depth in
    INFERENCE_KPER-slice parts at every N: on the blocks of a cluster (a
    tile's parts, one or two a block, summed from distributed shared memory)
    in the first of CLUSTER_MODES whose clusters all fit in one wave
    (``slots`` {cluster size: clusters the card holds at once},
    ``cluster_slots``; default sms // size), else summed in one block over a
    128 x 128 tile ("sum"). ``mode`` forces one of ``f2_modes`` (a test's
    hook). N never changes a part or its order, so a row's bits are the same
    at every N."""
    tile1 = (64, 128) if _one_wave(n, f, (64, 128), sms) else (128, 128)
    rt1, ct1 = _tiles(n, f, tile1)
    first = GemmPlan(n, f, d, rt1, ct1, 1, -(-d // K_TILE), min(sms, rt1 * ct1), tile1[0])

    ksteps = -(-f // K_TILE)
    kper = min(INFERENCE_KPER, ksteps)
    splits = -(-ksteps // kper)
    modes = f2_modes(splits, sms, slots)
    if mode is None:   # modes lists "sum" first, then CLUSTER_MODES in order
        mode = next((m for m, (tile, size) in modes.items()
                     if m != "sum" and _one_wave(n, d, tile, _at_once(size, sms, slots))), "sum")
    elif mode not in modes:
        raise ValueError(f"infer_plan: mode {mode!r} not among {sorted(modes)} for F {f}")
    tile2, size = modes[mode]
    rt2, ct2 = _tiles(n, d, tile2)
    ctas = min(sms, rt2 * ct2) if mode == "sum" else rt2 * ct2 * size
    second = GemmPlan(n, d, f, rt2, ct2, splits, kper, ctas, tile2[0],
                      "sum" if mode == "sum" else "cluster", size, tile2[1])
    return first, second


@functools.lru_cache(maxsize=1024)
def _infer_args(n, d, f, device, mode=None):
    """infer_plan's scalars for kmb_ffn_infer on ``device``, once a shape."""
    first, second = infer_plan(n, d, f, sm_count(device), cluster_slots(device), mode)
    return (first.tile_rows, first.ctas, MODES[second.mode], second.tile_rows,
            second.tile_cols, second.ctas, second.kper, second.cluster)


# The training layouts of the first GEMM (csrc/wgmma_gemm.cuh Legacy, Fast,
# Table): {name: code}. "legacy" is the parent kernel's epilogue; "fast"
# keeps its tiles and ring, with the epilogue reading and writing the tile
# buffer in batches by shared-memory address; "table" is "fast" with
# gelu(a) read from a table of the bf16 a (one ring stage less). Both give
# Legacy's bits. TRAIN_FIRST is each direction's: the forward's GELU from
# the table, the backward's gelu' by the formula.
TRAIN_LAYOUTS = {"legacy": 0, "fast": 1, "table": 2}
TRAIN_FIRST = {False: "table", True: "fast"}
# Consumer 1 builds Table's table while consumer 0 runs its first main loop
# (D / 64 slices); at D 32 the build outlasted it and Table measured slower
# than Legacy, at D 768 and 1024 faster (PERF.md §6). F1 takes Table
# from this depth, Legacy below it.
TABLE_MIN_DEPTH = 768


def waves(g):
    """The most tiles one block of a ``plan`` GEMM's persistent grid runs."""
    return -(-(g.row_tiles * g.col_tiles * g.splits) // g.ctas)


def train_plan(n, d, f, sms, backward=False, layout=None):
    """The launch plan of a training call at N rows, D and F widths, on
    ``sms`` SMs: (first GEMM, second GEMM), as csrc/ffn.cu kmb_ffn_fwd (the
    forward with ``a``) and csrc/ffn_bwd.cu kmb_ffn_bwd (``backward``) run
    them: ``plan``'s, the second GEMM on Legacy with ``plan``'s depth split,
    the first on TRAIN_FIRST's layout (B1 at every N; F1 where D is at least
    TABLE_MIN_DEPTH, else "legacy"). ``layout`` forces the first GEMM's
    layout, "legacy" or TRAIN_FIRST's (a test's hook: chip_smoke.py times
    both in one run)."""
    own = TRAIN_FIRST[backward]
    if layout is None:
        layout = own if backward or d >= TABLE_MIN_DEPTH else "legacy"
    elif layout not in ("legacy", own):
        raise ValueError(f"train_plan: the {'backward' if backward else 'forward'}'s first "
                         f"GEMM runs 'legacy' or {own!r}, not {layout!r}")
    first, second = plan(n, d, f, sms)
    return first._replace(layout=layout), second


_CLUSTER_SLOTS = {}


def cluster_slots(device):
    """{cluster size: clusters of F2's cluster kernel the card holds at
    once (0: none fits, and infer_plan takes no mode of that size)}, sizes
    1-MAX_CLUSTER, read from the card once."""
    if device not in _CLUSTER_SLOTS:
        lib = _cuda.lib()
        slots = {size: lib.kmb_ffn_cluster_slots(size, device.index or 0)
                 for size in range(1, MAX_CLUSTER + 1)}
        for size, n in slots.items():
            if n < 0:
                _cuda.check(-n, f"cudaOccupancyMaxActiveClusters at cluster size {size}")
        _CLUSTER_SLOTS[device] = slots
    return _CLUSTER_SLOTS[device]


_SM_COUNTS = {}


def sm_count(device):
    if device not in _SM_COUNTS:
        _SM_COUNTS[device] = torch.cuda.get_device_properties(device).multi_processor_count
    return _SM_COUNTS[device]


def _check_widths(name, D, F):
    if not supported(D, F):
        raise ValueError(f"{name} kernel takes D % 16 == 0 and F % 64 == 0; got D {D}, F {F}")


def check_aligned(name, *tensors):
    """TMA reads and the epilogue's paired stores want 16-byte aligned bases."""
    for t in tensors:
        if t is not None and t.data_ptr() % 16:
            raise ValueError(f"{name}: kernel takes 16-byte aligned tensors")


@functools.lru_cache(maxsize=1024)
def _plan_args(N, D, F, device, invariant=False, backward=False, layout=None):
    """The scalars of kmb_ffn_fwd and kmb_ffn_bwd on ``device``, once a
    shape: ``train_plan``'s, or with ``invariant`` (the partials route)
    ``plan``'s at the inference split; and the second GEMM's splits."""
    if invariant:
        first, second = plan(N, D, F, sm_count(device), True)
    else:
        first, second = train_plan(N, D, F, sm_count(device), backward, layout)
    return second.splits, (first.ctas, second.ctas, second.splits, second.kper,
                           TRAIN_LAYOUTS[first.layout])


def _launch_args(dev, N, D, F, invariant=False, backward=False, layout=None):
    """The plan's scalars for the C entry points, and the partial-sum
    scratch of the second GEMM when it splits."""
    splits, args = _plan_args(N, D, F, dev, invariant, backward, layout)
    partial = (torch.empty((splits, N, D), dtype=torch.float32, device=dev)
               if splits > 1 else None)
    return partial, args


def fused_ffn(x, w1, b1, w2, b2, with_a=False):
    """Fused FFN; same contract as ``fused_ffn_plain`` except that on a CUDA
    device the weights must already be bf16 and the biases fp32. Without
    ``a`` (an inference forward) the call takes ``infer_plan``'s route; with
    it (training) ``train_plan``'s."""
    if x.device.type == "cpu":
        return fused_ffn_plain(x, w1, b1, w2, b2, with_a=with_a)
    if not with_a:
        return _fused_ffn_infer(x, w1, b1, w2, b2)
    return _fused_ffn_split(x, w1, b1, w2, b2, with_a=True)


def fused_ffn_partials(x, w1, b1, w2, b2):
    """The inference forward on the partials route: F2's INFERENCE_KPER
    parts written to an fp32 [splits, N, D] buffer and added by a third
    launch (csrc/ffn.cu kmb_ffn_fwd on ``plan``'s Legacy layout at the
    inference split). The same function as ``fused_ffn`` without ``a``, bit
    for bit; kept as that route's yardstick (chip_smoke.py holds the two
    equal)."""
    if x.device.type == "cpu":
        return fused_ffn_plain(x, w1, b1, w2, b2)
    return _fused_ffn_split(x, w1, b1, w2, b2, with_a=False)


def _check_fwd(x, w1, b1, w2, b2):
    D = x.shape[-1]
    F = w1.shape[0]
    if w1.shape != (F, D) or w2.shape != (D, F) or b1.shape != (F,) or b2.shape != (D,):
        raise ValueError(f"fused_ffn: shapes x {tuple(x.shape)}, w1 {tuple(w1.shape)}, "
                         f"b1 {tuple(b1.shape)}, w2 {tuple(w2.shape)}, b2 {tuple(b2.shape)}")
    _check_widths("fused_ffn", D, F)
    if not (x.dtype == w1.dtype == w2.dtype == torch.bfloat16):
        raise TypeError("fused_ffn kernel takes bf16 x and weights")
    if not (b1.dtype == b2.dtype == torch.float32):
        raise TypeError("fused_ffn kernel takes fp32 biases")
    return D, F


def _fused_ffn_infer(x, w1, b1, w2, b2, mode=None):
    """``fused_ffn`` without ``a`` on a CUDA device: infer_plan's two
    launches, with no more host work than the call needs (the plan cached a
    shape, the weights' tensor maps cached in the library, PyTorch's raw
    current stream). ``mode`` forces infer_plan's F2 mode (chip_smoke.py
    holds each to the partials route and times it)."""
    D, F, dev = x.shape[-1], w1.shape[0], x.device
    # every check in one expression (the call's host time is the decode
    # step's); the helpers below name what failed
    if not (x.is_cuda and w1.device == dev and b1.device == dev and w2.device == dev
            and b2.device == dev and x.is_contiguous() and w1.is_contiguous()
            and b1.is_contiguous() and w2.is_contiguous() and b2.is_contiguous()
            and x.dtype == w1.dtype == w2.dtype == torch.bfloat16
            and b1.dtype == b2.dtype == torch.float32 and w1.shape == (F, D)
            and w2.shape == (D, F) and b1.shape == (F,) and b2.shape == (D,)
            and D % 16 == 0 and F % 64 == 0):
        _cuda.require_cuda("fused_ffn", x, w1, b1, w2, b2)
        _check_fwd(x, w1, b1, w2, b2)
    N = x.numel() // D   # x is contiguous: its rows are [N, D] as they lie
    y = torch.empty_like(x)
    if N > 0:
        h = torch.empty(N * F, dtype=torch.bfloat16, device=dev)   # [N, F]
        ptrs = (x.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(), b2.data_ptr(),
                y.data_ptr(), h.data_ptr())
        if (ptrs[0] | ptrs[1] | ptrs[2] | ptrs[3] | ptrs[4] | ptrs[5] | ptrs[6]) % 16:
            raise ValueError("fused_ffn: kernel takes 16-byte aligned tensors")
        index = dev.index or 0
        # the raw handle of PyTorch's current stream (torch.cuda.current_stream
        # builds a Stream object a call)
        _cuda.check(_cuda.lib().kmb_ffn_infer(
            *ptrs, N, D, F, *_infer_args(N, D, F, dev, mode), index,
            torch._C._cuda_getCurrentRawStream(index)), "fused_ffn")
        count("launch.ffn")
    return y


def _fused_ffn_split(x, w1, b1, w2, b2, with_a, layout=None):
    """The training forward on a CUDA device (``with_a``: ``train_plan``'s
    route; ``layout`` forces its first GEMM's, a test's hook), or the
    inference forward on the partials route (``plan``'s, at the
    INFERENCE_KPER split)."""
    dev = _cuda.require_cuda("fused_ffn", x, w1, b1, w2, b2)
    D, F = _check_fwd(x, w1, b1, w2, b2)
    xf = x.reshape(-1, D)
    N = xf.shape[0]
    y = torch.empty_like(xf)
    a = torch.empty((N, F), dtype=torch.bfloat16, device=dev) if with_a else None
    if N > 0:
        h = torch.empty((N, F), dtype=torch.bfloat16, device=dev)
        partial, plan_args = _launch_args(dev, N, D, F, not with_a, layout=layout)
        check_aligned("fused_ffn", xf, w1, b1, w2, b2, y, h, partial, a)
        lib, stream = _cuda.prepare(dev)
        _cuda.check(lib.kmb_ffn_fwd(
            xf.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(), b2.data_ptr(),
            y.data_ptr(), h.data_ptr(), _ptr(partial), _ptr(a), N, D, F, *plan_args, stream),
            "fused_ffn")
        count("launch.ffn")
    y = y.reshape(x.shape)
    return (y, a.reshape(*x.shape[:-1], F)) if with_a else y


def _ptr(t):
    return None if t is None else t.data_ptr()


def fused_ffn_bwd_plain(g, a, w1, w2):
    """Plain PyTorch version of the backward kernel, on any device.
    g [N, D] and a [N, F] bf16; w1 [F, D], w2 [D, F] rounded to bf16.
    Returns (da [N, F], dx [N, D]), both bf16."""
    bf16 = torch.bfloat16
    dh = g.to(bf16).float() @ w2.to(bf16).float()
    da = (dh * _dgelu_f32(a.float())).to(bf16)
    dx = (da.float() @ w1.to(bf16).float()).to(bf16)
    return da, dx


def fused_ffn_bwd(g, a, w1, w2):
    """Backward of ``fused_ffn`` for the input; same contract as
    ``fused_ffn_bwd_plain`` except that on a CUDA device every operand must
    already be bf16."""
    if g.device.type == "cpu":
        return fused_ffn_bwd_plain(g, a, w1, w2)
    return _fused_ffn_bwd(g, a, w1, w2)


def _fused_ffn_bwd(g, a, w1, w2, layout=None):
    """``fused_ffn_bwd`` on a CUDA device, on ``train_plan``'s route
    (``layout`` forces its first GEMM's, a test's hook)."""
    dev = _cuda.require_cuda("fused_ffn_bwd", g, a, w1, w2)
    N, D = g.shape
    F = w1.shape[0]
    if a.shape != (N, F) or w1.shape != (F, D) or w2.shape != (D, F):
        raise ValueError(f"fused_ffn_bwd: shapes g {tuple(g.shape)}, a {tuple(a.shape)}, "
                         f"w1 {tuple(w1.shape)}, w2 {tuple(w2.shape)}")
    _check_widths("fused_ffn_bwd", D, F)
    if not (g.dtype == a.dtype == w1.dtype == w2.dtype == torch.bfloat16):
        raise TypeError("fused_ffn_bwd kernel takes bf16 g, a and weights")
    da = torch.empty_like(a)
    dx = torch.empty_like(g)
    if N == 0:
        return da, dx
    partial, plan_args = _launch_args(dev, N, D, F, backward=True, layout=layout)
    check_aligned("fused_ffn_bwd", g, a, w1, w2, da, dx, partial)
    lib, stream = _cuda.prepare(dev)
    _cuda.check(lib.kmb_ffn_bwd(
        g.data_ptr(), a.data_ptr(), w1.data_ptr(), w2.data_ptr(), da.data_ptr(),
        dx.data_ptr(), _ptr(partial), N, D, F, *plan_args, stream), "fused_ffn_bwd")
    count("launch.ffn_bwd")
    return da, dx


class _FusedFFN(torch.autograd.Function):
    # the module-level kernel wrappers are looked up at call time, so a
    # caller can route both directions to the plain versions

    @staticmethod
    def forward(ctx, x, w1, b1, w2, b2):
        bf16 = torch.bfloat16
        w1c, w2c = w1.to(bf16), w2.to(bf16)
        y, a = fused_ffn(x, w1c, b1, w2c, b2, with_a=True)
        ctx.save_for_backward(x, a, w1c, w2c)
        return y

    @staticmethod
    def backward(ctx, g):
        x, a, w1c, w2c = ctx.saved_tensors
        D, F = x.shape[-1], a.shape[-1]
        x2, a2 = x.reshape(-1, D), a.reshape(-1, F)
        g16 = g.reshape(-1, D).to(torch.bfloat16).contiguous()
        da, dx = fused_ffn_bwd(g16, a2, w1c, w2c)
        # weight and bias gradients in fp32 (the parameters' dtype), from
        # bf16 operands with fp32 accumulation, as pallas_ffn.py:294-302
        h = _gelu_f32(a2.float()).to(torch.bfloat16)
        dw2 = mm_f32(g16.t(), h)
        dw1 = mm_f32(da.t(), x2.to(torch.bfloat16))
        db2 = g16.float().sum(dim=0)
        db1 = da.float().sum(dim=0)
        return dx.reshape(x.shape).to(x.dtype), dw1, db1, dw2, db2


def ffn(x, w1, b1, w2, b2):
    """Differentiable fused FFN on the fp32 parameters (bf16 compute); the
    forward alone when no gradient is needed."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, w1, b1, w2, b2)):
        return _FusedFFN.apply(x, w1, b1, w2, b2)
    return fused_ffn(x, w1.to(torch.bfloat16), b1, w2.to(torch.bfloat16), b2)
