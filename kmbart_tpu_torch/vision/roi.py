"""ROI pooling and ROI align, in PyTorch.

Counterpart of kmbart_tpu/vision/roi.py: crop each ROI from the stride-16
C4 feature map to a fixed grid (detectron2's ``_shared_roi_transform``).
Features are [H, W, C] and outputs [N, P, P, C], as there.

``roi_pool`` computes the JAX function without its sample tensor. The JAX
version gathers [N, P, S, P, S, C] samples (S = ``max_bin``) and lets XLA
fuse the max; eager PyTorch would build that tensor, 7.7 GB in bf16 for the
detector's 300 proposals. Here each bin's samples are first reduced to the
integer range they cover (clamping to the map makes the sampled pixels a
contiguous run), and the max over a range of up to S pixels is read from a
sparse table of the feature map: window maxima of 1, 2, 4, ... pixels in
each direction, so every bin is the max of four table entries. Max is
exact, so the result equals the JAX function's bit for bit, bins wider than
``max_bin`` included (they keep their first ``max_bin`` pixels there too).
"""

import torch


def _bilinear_sample(features, y, x):
    """features [H, W, C]; y/x same-shaped float grids -> [*grid, C]
    bilinearly interpolated values (zero outside the map)."""
    H, W, _ = features.shape
    y0 = torch.floor(y)
    x0 = torch.floor(x)
    wy1 = (y - y0)[..., None]
    wx1 = (x - x0)[..., None]

    def at(yi, xi):
        inside = (yi >= 0) & (yi <= H - 1) & (xi >= 0) & (xi <= W - 1)
        vals = features[yi.clamp(0, H - 1).long(), xi.clamp(0, W - 1).long()]
        return torch.where(inside[..., None], vals, 0.0)

    top = at(y0, x0) * (1 - wx1) + at(y0, x0 + 1) * wx1
    bot = at(y0 + 1, x0) * (1 - wx1) + at(y0 + 1, x0 + 1) * wx1
    return top * (1 - wy1) + bot * wy1


def roi_align(features, boxes, output_size, spatial_scale, sampling_ratio=2, aligned=True):
    """ROIAlign (Mask R-CNN): features [H, W, C], boxes [N, 4] xyxy in image
    coords -> [N, P, P, C]. ``aligned=True`` applies the detectron2 -0.5
    pixel-centre shift."""
    boxes = boxes.float()
    P, S = output_size, sampling_ratio
    b = boxes * spatial_scale - (0.5 if aligned else 0.0)
    x1, y1, x2, y2 = b.unbind(1)
    floor = 1e-6 if aligned else 1.0
    bin_w = torch.clamp(x2 - x1, min=floor) / P
    bin_h = torch.clamp(y2 - y1, min=floor) / P
    ii = torch.arange(P, device=boxes.device)
    ss = (torch.arange(S, device=boxes.device) + 0.5) / S
    offs = ii[None, :, None] + ss[None, None, :]                       # [1, P, S]
    ys = y1[:, None, None] + offs * bin_h[:, None, None]               # [N, P, S]
    xs = x1[:, None, None] + offs * bin_w[:, None, None]
    N = boxes.shape[0]
    yg = ys[:, :, :, None, None].expand(N, P, S, P, S)
    xg = xs[:, None, None, :, :].expand(N, P, S, P, S)
    sampled = _bilinear_sample(features, yg, xg)                       # [N, P, S, P, S, C]
    return sampled.mean(dim=(2, 4))


def _window_max_table(features, levels):
    """[levels², H, W, C]: entry (ky·levels + kx)[y, x] is the max over the
    2^ky x 2^kx window whose top-left pixel is (y, x). Windows that run off
    the map hold partial maxima; ``roi_pool`` never reads them."""
    rows = [features]
    for k in range(1, levels):
        prev, h = rows[-1], 1 << (k - 1)
        nxt = prev.clone()
        nxt[:-h] = torch.maximum(prev[:-h], prev[h:])
        rows.append(nxt)
    tables = []
    for t in rows:
        cols = [t]
        for k in range(1, levels):
            prev, h = cols[-1], 1 << (k - 1)
            nxt = prev.clone()
            nxt[:, :-h] = torch.maximum(prev[:, :-h], prev[:, h:])
            cols.append(nxt)
        tables += cols
    return torch.stack(tables)


def _bin_ranges(o, bin_sz, P, S, size):
    """Caffe bin edges for one axis: o, bin_sz [N] -> the first pixel, the
    last pixel and the sparse-table level of every bin, [N, P] each. The
    JAX version samples clip(start + t) for t < min(end - start, S); clamping
    makes that the contiguous run [clip(start), clip(start + n - 1)]."""
    ii = torch.arange(P, dtype=torch.float32, device=o.device)
    start = torch.floor(o[:, None] + ii[None, :] * bin_sz[:, None]).long()
    end = torch.ceil(o[:, None] + (ii[None, :] + 1) * bin_sz[:, None]).long()
    n = torch.clamp(end - start, max=S)
    lo = start.clamp(0, size - 1)
    hi = (start + n - 1).clamp(0, size - 1)
    level = torch.floor(torch.log2((hi - lo + 1).double())).long()
    return lo, hi, level


def roi_pool(features, boxes, output_size, spatial_scale, max_bin=8):
    """Max ROIPool (Fast R-CNN / caffe bottom-up-attention flavour):
    quantised bins, exact integer-pixel max per bin within a ``max_bin``
    sample budget. features [H, W, C] (any float dtype, kept), boxes [N, 4]
    xyxy in image coords -> [N, P, P, C]."""
    H, W, C = features.shape
    P, S = output_size, max_bin
    levels = S.bit_length()
    b = torch.round(boxes.float() * spatial_scale)
    x1, y1, x2, y2 = b.unbind(1)
    roi_w = torch.clamp(x2 - x1 + 1, min=1.0)
    roi_h = torch.clamp(y2 - y1 + 1, min=1.0)
    # the bin size by IEEE division: PyTorch's CUDA kernel divides by a
    # Python scalar as a multiply by its reciprocal, one bit off, which moves
    # a bin edge that falls on an integer (a device tensor divides exactly)
    P_t = torch.full((), float(P), device=boxes.device)
    ylo, yhi, ky = _bin_ranges(y1, roi_h / P_t, P, S, H)
    xlo, xhi, kx = _bin_ranges(x1, roi_w / P_t, P, S, W)
    flat = _window_max_table(features, levels).reshape(-1, C)
    t = ky[:, :, None] * levels + kx[:, None, :]                       # [N, P, P]
    out = None
    for ys in (ylo, yhi - 2 ** ky + 1):
        for xs in (xlo, xhi - 2 ** kx + 1):
            idx = (t * H + ys[:, :, None]) * W + xs[:, None, :]
            vals = flat[idx]
            out = vals if out is None else torch.maximum(out, vals, out=out)
    return torch.where(torch.isfinite(out), out, 0.0)
