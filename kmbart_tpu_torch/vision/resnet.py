"""Caffe-style ResNet backbone and res5 ROI head, in PyTorch.

Counterpart of kmbart_tpu/vision/resnet.py: the bottom-up-attention C4
Faster R-CNN trunk (frozen BN folded to a scale/bias affine, the stride in
the 1x1 conv, res5 dilated by 2). Tensors keep the JAX package's NHWC
shapes; a convolution views them as NCHW in PyTorch's ``channels_last``
memory format, which is the same bytes, so no layout copy is made between
layers. Parameters are a plain dict shaped like the JAX pytree, with conv
kernels in PyTorch's [out, in, kh, kw] layout.

Mixed precision as in the JAX package: a convolution takes its operands in
the compute dtype and returns fp32 (``preferred_element_type``), and the
frozen BN, ReLU and residual add run on that fp32 result. On the card a
bf16 convolution returns bf16, which is widened (one more rounding than
the JAX program's, bounded in ``chip_smoke.py``); elsewhere the convolution
is computed in fp32 from operands rounded to the compute dtype.
"""

import math

import torch
import torch.nn.functional as F

STAGE_BLOCKS = {50: (3, 4, 6, 3), 101: (3, 4, 23, 3), 152: (3, 8, 36, 3)}


def _conv_init(generator, kh, kw, cin, cout, device="cpu"):
    std = math.sqrt(2.0 / (kh * kw * cin))
    return torch.randn((cout, cin, kh, kw), generator=generator, device=device) * std


def _bn_init(c, device="cpu"):
    return {"scale": torch.ones(c, device=device), "bias": torch.zeros(c, device=device)}


def conv(x, kernel, stride=1, dilation=1, dtype=torch.bfloat16):
    """x [N, H, W, Cin], kernel [Cout, Cin, kh, kw] -> fp32 [N, H', W', Cout],
    with the JAX package's symmetric padding of dilation·(k-1)/2."""
    pad = (dilation * (kernel.shape[2] - 1) // 2, dilation * (kernel.shape[3] - 1) // 2)
    nchw = x.permute(0, 3, 1, 2)
    if x.is_cuda:
        nchw = nchw.to(dtype).contiguous(memory_format=torch.channels_last)
        w = kernel.to(dtype).contiguous(memory_format=torch.channels_last)
    else:
        nchw = nchw.to(dtype).float()
        w = kernel.to(dtype).float()
    y = F.conv2d(nchw, w, stride=stride, padding=pad, dilation=dilation)
    return y.float().permute(0, 2, 3, 1)


def frozen_bn(x, p):
    return x * p["scale"] + p["bias"]


def max_pool_same(x):
    """3x3/2 max pool with XLA's "SAME" padding: the output has ceil(H/2)
    rows, and an even size is padded at the bottom (right) only."""
    _, H, W, _ = x.shape
    pad_h = max((-(-H // 2) - 1) * 2 + 3 - H, 0)
    pad_w = max((-(-W // 2) - 1) * 2 + 3 - W, 0)
    nchw = F.pad(x.permute(0, 3, 1, 2),
                 (pad_w // 2, pad_w - pad_w // 2, pad_h // 2, pad_h - pad_h // 2),
                 value=-math.inf)
    return F.max_pool2d(nchw, 3, 2).permute(0, 2, 3, 1)


def init_bottleneck(generator, cin, cmid, cout, shortcut, device="cpu"):
    p = {
        "conv1": _conv_init(generator, 1, 1, cin, cmid, device), "bn1": _bn_init(cmid, device),
        "conv2": _conv_init(generator, 3, 3, cmid, cmid, device), "bn2": _bn_init(cmid, device),
        "conv3": _conv_init(generator, 1, 1, cmid, cout, device), "bn3": _bn_init(cout, device),
    }
    if shortcut:
        p["shortcut"] = _conv_init(generator, 1, 1, cin, cout, device)
        p["shortcut_bn"] = _bn_init(cout, device)
    return p


def bottleneck(x, p, stride=1, dilation=1, dtype=torch.bfloat16):
    """Caffe ordering: the stride lives in the 1x1 conv (stride_in_1x1)."""
    out = F.relu(frozen_bn(conv(x, p["conv1"], stride=stride, dtype=dtype), p["bn1"]))
    out = F.relu(frozen_bn(conv(out, p["conv2"], dilation=dilation, dtype=dtype), p["bn2"]))
    out = frozen_bn(conv(out, p["conv3"], dtype=dtype), p["bn3"])
    if "shortcut" in p:
        sc = frozen_bn(conv(x, p["shortcut"], stride=stride, dtype=dtype), p["shortcut_bn"])
    else:
        sc = x
    return F.relu(out + sc)


def init_resnet_c4(generator, depth=101, device="cpu"):
    """stem + res2/3/4 (the C4 backbone) and res5 (the ROI head)."""
    n2, n3, n4, n5 = STAGE_BLOCKS[depth]

    def stage(n_blocks, cin, cmid, cout):
        return [init_bottleneck(generator, cin if i == 0 else cout, cmid, cout,
                                shortcut=i == 0, device=device) for i in range(n_blocks)]

    return {
        "stem": {"conv1": _conv_init(generator, 7, 7, 3, 64, device),
                 "bn1": _bn_init(64, device)},
        "res2": stage(n2, 64, 64, 256),
        "res3": stage(n3, 256, 128, 512),
        "res4": stage(n4, 512, 256, 1024),
        "res5": stage(n5, 1024, 512, 2048),
    }


def backbone_c4(params, images, dtype=torch.bfloat16):
    """images [N, H, W, 3] (BGR, pixel-mean subtracted) -> res4 feature map
    [N, H/16, W/16, 1024]."""
    x = conv(images, params["stem"]["conv1"], stride=2, dtype=dtype)
    x = max_pool_same(F.relu(frozen_bn(x, params["stem"]["bn1"])))
    for stage, first_stride in (("res2", 1), ("res3", 2), ("res4", 2)):
        for i, block in enumerate(params[stage]):
            x = bottleneck(x, block, stride=first_stride if i == 0 else 1, dtype=dtype)
    return x


def res5_head(params, roi_features, dilation=2, dtype=torch.bfloat16):
    """roi_features [N, P, P, 1024] -> [N, P', P', 2048]. With dilation 2
    the first block keeps stride 1 and the 3x3 convs dilate, preserving the
    pooled resolution."""
    x = roi_features
    stride = 1 if dilation == 2 else 2
    for i, block in enumerate(params["res5"]):
        x = bottleneck(x, block, stride=stride if i == 0 else 1, dilation=dilation, dtype=dtype)
    return x
