"""Elementary layers with the JAX package's mixed-precision policy.

Counterpart of kmbart_tpu/ops/layers.py. Parameters stay fp32; a matmul
takes its operands in the compute dtype (bf16 by default), accumulates in
fp32, adds the bias in fp32 and rounds once to the compute dtype. Layer-norm
statistics are fp32. With ``dtype=torch.float32`` every cast is a no-op.

On a CUDA tensor in bf16 the product runs on the tensor cores with an fp32
output (``torch.mm(..., out_dtype=torch.float32)``), inside an autograd
function whose backward forms dx = g·W and dW = gᵀ·x the same way, both
rounded to bf16 as XLA's dot transpose emits them in the operand dtype.
Elsewhere it is computed in fp32 from bf16-rounded operands, which is what
XLA's CPU path does, so the CPU tests pin the port to the JAX package.

Dropout is inverted dropout at the exact rate, with its keep mask drawn
from a ``torch.Generator``. The JAX package quantises the keep probability
to a uint8 threshold of the TPU's hardware RNG (230/256 at rate 0.1,
kmbart_tpu/ops/layers.py:67-95); that workaround is not carried over, so the
two differ in their random bits and, slightly, in the keep share.

Weights are in PyTorch's ``[out, in]`` layout (``nn.Linear.weight``).
"""

import math

import torch
import torch.nn.functional as F

_SQRT_2 = math.sqrt(2.0)


def gelu(x):
    return x * 0.5 * (1.0 + torch.erf(x / _SQRT_2))


def gelu_new(x):
    return 0.5 * x * (1.0 + torch.tanh(0.7978845608028654 * (x + 0.044715 * x ** 3)))


ACTIVATIONS = {"gelu": gelu, "gelu_new": gelu_new, "relu": F.relu}


def mm_f32(a, b):
    """a @ b with an fp32 result: on a CUDA device bf16 operands go to the
    tensor cores with fp32 accumulation, elsewhere the product is fp32."""
    if a.is_cuda and a.dtype == b.dtype == torch.bfloat16:
        return torch.mm(a, b, out_dtype=torch.float32)
    return torch.mm(a.float(), b.float())


class _MatmulF32(torch.autograd.Function):
    """x2 @ w.T for bf16 CUDA operands with an fp32 output. The backward is
    written out because ``torch.mm``'s ``out_dtype`` form need not have a
    derivative; its products are library matmuls, as in JAX, where XLA
    computes them outside any kernel."""

    @staticmethod
    def forward(ctx, x2, w):
        ctx.save_for_backward(x2, w)
        return torch.mm(x2, w.t(), out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, g):
        x2, w = ctx.saved_tensors
        g16 = g.to(torch.bfloat16)
        dx = torch.mm(g16, w, out_dtype=torch.float32).to(torch.bfloat16)
        dw = torch.mm(g16.t(), x2, out_dtype=torch.float32).to(torch.bfloat16)
        return dx, dw


def matmul_f32(x, weight, dtype=torch.bfloat16):
    """x @ weight.T with operands rounded to ``dtype`` and an fp32 result."""
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1]).to(dtype)
    w = weight.to(dtype)
    if x2.is_cuda and dtype == torch.bfloat16:
        y = _MatmulF32.apply(x2, w)
    else:
        y = torch.mm(x2.float(), w.float().t())
    return y.reshape(*lead, weight.shape[0])


def dense(x, weight, bias=None, dtype=torch.bfloat16):
    """y = x @ weight.T + bias: operands in ``dtype``, fp32 accumulation and
    bias add, output rounded once to ``dtype``."""
    y = matmul_f32(x, weight, dtype)
    if bias is not None:
        y = y + bias.float()
    return y.to(dtype)


def layer_norm(x, scale, bias, eps=1e-5):
    """Layer norm over the last axis, statistics in fp32, output in the
    input's dtype."""
    out_dtype = x.dtype
    x = x.float()
    mean = x.mean(dim=-1, keepdim=True)
    var = (x - mean).square().mean(dim=-1, keepdim=True)
    y = (x - mean) * torch.rsqrt(var + eps)
    return (y * scale.float() + bias.float()).to(out_dtype)


def dropout(x, rate, generator, train):
    """Inverted dropout at the exact rate: keep with probability 1 - rate
    and scale the kept values by 1 / (1 - rate) in x's dtype. The identity
    when not training, at rate 0, or without a generator."""
    if not train or rate == 0.0 or generator is None:
        return x
    keep = torch.rand(x.shape, generator=generator, device=x.device) >= rate
    return torch.where(keep, scale_as(x, 1.0 / (1.0 - rate)), 0.0).to(x.dtype)


def scale_as(x, scale):
    """x * scale with the scalar rounded to x's dtype first, as JAX treats a
    Python scalar multiplying a bf16 array."""
    return x * torch.tensor(scale, dtype=x.dtype, device=x.device)
