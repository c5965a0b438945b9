"""Megatron tensor parallelism over the grid's model axis.

Counterpart of kmbart_tpu/parallel/tp.py. There GSPMD partitions the step
from the partition specs; here each rank holds its slice of every split
tensor (``shard_params``) and the model functions call the collectives:

- column-parallel: the q/k/v projections and fc1, weight rows and bias
  (``_LAYER_RULES`` "model" on the output axis); each rank computes its
  heads, or its columns of the FFN, from the whole input;
- row-parallel: out_proj and fc2, weight columns; each rank's product is a
  partial sum, all-reduced over the model axis, and the bias is added once
  after the reduce;
- everything else is replicated. The JAX package also splits the ends on
  d_model (``_TOP_RULES``: the shared embedding, the positions, the image
  projection and the heads); that changes memory only, and the port keeps
  them whole on every rank (ROADMAP.md, known differences).

The two Megatron functions carry the gradients: ``copy_to`` (identity
forward, sum over the axis backward) where a replicated tensor enters the
column-parallel products, ``reduce_from`` (sum forward, identity backward)
after the row-parallel ones. Sums run in fp32.

Sequence parallelism (parallel/sp.py) swaps those two for an all-gather and
a reduce-scatter along T; between them each rank holds T/tp rows, so the
layer norms and the row-parallel biases there see only their rank's rows,
and their gradients are summed over the model axis by the train step
(``TensorParallel.partial``).

The npz checkpoint and ``params_from_jax`` always carry whole tensors:
``shard_params`` cuts a rank's part, ``gather_params`` joins the parts again
(the model axis and, under pipeline parallelism, the stages).
"""

import re

import torch
from torch import nn

from kmbart_tpu_torch.parallel import distributed

# port tensor name ([out, in] weights) -> the axis the model axis splits
# (kmbart_tpu/parallel/tp.py:21-34 _LAYER_RULES)
_RULES = (
    (re.compile(r"layers\.\d+\.(self_attn|encoder_attn)\.[qkv]_proj\.(weight|bias)$"), 0),
    (re.compile(r"layers\.\d+\.(self_attn|encoder_attn)\.out_proj\.weight$"), 1),
    (re.compile(r"layers\.\d+\.fc1\.(weight|bias)$"), 0),
    (re.compile(r"layers\.\d+\.fc2\.weight$"), 1),
)
_LAYER = re.compile(r"\.layers\.(\d+)\.")


def tp_axis(name):
    """The axis of port tensor ``name`` that tensor parallelism splits, or
    None for a replicated tensor."""
    for pattern, axis in _RULES:
        if pattern.search(name):
            return axis
    return None


def _sum(x, axis):
    y = x.float().contiguous().clone()
    distributed.all_reduce_axis(y, axis)
    return y.to(x.dtype)


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _sum(g, ctx.axis), None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        return _sum(x, axis)

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_to(x, axis):
    """Identity forward; the gradient summed over ``axis``: where a tensor
    whole on every rank of the axis feeds products that each rank computes
    a part of."""
    return x if axis.size == 1 else _CopyTo.apply(x, axis)


def reduce_from(x, axis):
    """The sum over ``axis`` forward (in fp32, returned in x's dtype); the
    gradient passes through."""
    return x if axis.size == 1 else _ReduceFrom.apply(x, axis)


def _local_seed(generator, salt, rank):
    from kmbart_tpu_torch.parallel.train_step import step_seed
    return step_seed(generator.initial_seed(), salt, 0, rank + 1)


class TensorParallel:
    """The model axis as the model functions use it. ``partial`` collects
    the parameters whose gradient each rank holds a part of (sequence
    parallelism's layer norms and row-parallel biases); the train step sums
    them over the model axis and empties it."""

    def __init__(self, axis, sequence_parallel=False):
        self.axis, self.size, self.rank = axis, axis.size, axis.index
        self.sequence_parallel = sequence_parallel
        self.partial = {}

    def heads(self, num_heads):
        """This rank's head count. The JAX partitioner replicates the head
        axis where the degree does not divide it
        (pallas_train_attention.py:316); the port refuses."""
        if num_heads % self.size:
            raise ValueError(f"model_parallel={self.size} does not divide the "
                             f"{num_heads} attention heads")
        return num_heads // self.size

    def any(self, flag):
        """Whether the bool tensor ``flag`` holds on any rank of the model
        axis, read on the host: one scalar all-reduce. The decode loops
        agree their stop test with it, so that no rank leaves the loop while
        another waits in the next step's all-reduce (the all-reduced logits
        need not be bit-equal on every rank)."""
        votes = flag.reshape(1).to(torch.float32)
        distributed.all_reduce_axis(votes, self.axis)
        return bool(votes.item() > 0)

    def stack(self, length, generator=None, salt=0):
        """The context of one stack run on ``length`` tokens: sequence
        parallel when asked for and the length splits evenly
        (kmbart_tpu/parallel/sp.py:80-91 ``constrain``), with this rank's
        own dropout generator for the regions it computes alone."""
        sp = self.sequence_parallel and length % self.size == 0 and length >= self.size
        local = None
        if generator is not None:
            local = torch.Generator(device=generator.device).manual_seed(
                _local_seed(generator, salt, self.rank))
        return Stack(self, sp, local)


class Stack:
    """Tensor parallelism inside one stack (``TensorParallel.stack``)."""

    def __init__(self, tp, sp, generator):
        self.tp, self.sp, self.generator = tp, sp, generator

    def heads(self, num_heads):
        return self.tp.heads(num_heads)

    def begin(self, x):
        """The replicated stack input -> this rank's part of the stream."""
        if not self.sp:
            return x
        from kmbart_tpu_torch.parallel.sp import scatter
        return scatter(x, self.tp.axis)

    def end(self, x):
        """This rank's part of the stream -> the whole output, replicated."""
        if not self.sp:
            return x
        from kmbart_tpu_torch.parallel.sp import gather_replicated
        return gather_replicated(x, self.tp.axis)

    def enter(self, x):
        """The stream as the column-parallel products read it: whole."""
        if not self.sp:
            return copy_to(x, self.tp.axis)
        from kmbart_tpu_torch.parallel.sp import gather
        return gather(x, self.tp.axis)

    def row(self, x, weight, bias, dtype):
        """The row-parallel product ``dense(x, weight, bias, dtype)``: the
        parts summed over the model axis (reduce-scattered along T under
        sequence parallelism) in fp32, then the bias once, then one
        rounding."""
        from kmbart_tpu_torch.ops.layers import matmul_f32
        y = matmul_f32(x, weight, dtype)
        if self.sp:
            from kmbart_tpu_torch.parallel.sp import reduce_scatter
            y = reduce_scatter(y, self.tp.axis)
            self.mark(bias)
        else:
            y = reduce_from(y, self.tp.axis)
        return (y + bias.float()).to(dtype)

    def stream_generator(self, generator):
        """The generator of the residual stream's dropout: the replicated one,
        or this rank's own where it holds its own rows."""
        return self.generator if self.sp else generator

    def mark(self, *params):
        if self.sp:
            for p in params:
                self.tp.partial[id(p)] = p


# --------------------------------------------------------------------------
# Whole tensors <-> a rank's parts
# --------------------------------------------------------------------------

def stage_of(name, cfg, stages):
    """The pipeline stage holding port tensor ``name`` (0 for tensors
    outside the layer stacks, which every stage holds)."""
    m = _LAYER.search(name)
    if m is None or stages == 1:
        return 0
    n_layers = cfg.encoder_layers if ".encoder." in name else cfg.decoder_layers
    return int(m.group(1)) // (n_layers // stages)


def held(name, cfg, grid):
    """Whether this rank holds (a part of) port tensor ``name``."""
    return _LAYER.search(name) is None or stage_of(name, cfg, grid.stage.size) == grid.coords[1]


def shard_tensor(name, t, axis):
    a = tp_axis(name)
    if a is None or axis.size == 1:
        return t
    n = t.shape[a] // axis.size
    return t.narrow(a, axis.index * n, n).clone()


def shard_params(full, cfg, grid):
    """{name: whole tensor} -> this rank's {name: part}: its stage's layers
    and everything outside the stacks, the split tensors cut to its slice."""
    return {n: shard_tensor(n, t, grid.model) for n, t in full.items() if held(n, cfg, grid)}


@torch.no_grad()
def shard_model_(model, cfg, grid):
    """Cut a whole model to this rank's part, in place: the stacks keep this
    stage's layers (a ``ModuleDict`` under their global indices, so the
    tensor names stay those of the whole model) and the split tensors their
    slice."""
    if grid.stage.size > 1:
        for side in ("encoder", "decoder"):
            stack = getattr(model.model, side)
            stack.layers = nn.ModuleDict(
                {str(i): layer for i, layer in enumerate(stack.layers)
                 if held(f".{side}.layers.{i}.", cfg, grid)})
    if grid.model.size > 1:
        for name, p in model.named_parameters():
            if tp_axis(name) is not None:
                p.data = shard_tensor(name, p.data, grid.model)
    return model


def _generic(name):
    return _LAYER.sub(".layers.*.", name)


@torch.no_grad()
def gather_params(local, cfg, grid, names):
    """This rank's {name: part} -> {name: whole tensor} for every name of
    ``names`` (the whole model's) that ``local`` holds outside the layer
    stacks or that a stage holds inside them, on every rank: the model
    axis's parts joined, then each stage's layers broadcast over the stage
    axis. A collective: every rank calls it."""
    out = dict(local)
    split = [n for n in local if tp_axis(n) is not None]
    if grid.model.size > 1 and split:
        rows = distributed.all_gather_flat(
            torch.cat([local[n].reshape(-1).float() for n in split]), grid.model)
        offset = 0
        for n in split:
            t = local[n]
            parts = []
            for r in range(grid.model.size):
                parts.append(rows[r, offset:offset + t.numel()].view(t.shape).to(t.dtype))
            out[n] = torch.cat(parts, dim=tp_axis(n))
            offset += t.numel()
    if grid.stage.size == 1:
        return {n: out[n] for n in names if n in out}
    shapes = {_generic(n): (t.shape, t.dtype) for n, t in out.items()}
    ref = next(iter(out.values()))
    for s in range(grid.stage.size):
        members = [n for n in names if _LAYER.search(n) and stage_of(n, cfg, grid.stage.size) == s]
        sizes = [torch.Size(shapes[_generic(n)][0]).numel() for n in members]
        if s == grid.coords[1]:
            flat = torch.cat([out[n].reshape(-1).float() for n in members])
        else:
            flat = torch.empty(sum(sizes), dtype=torch.float32, device=ref.device)
        distributed.broadcast(flat, s, grid.stage)
        for n, part in zip(members, flat.split(sizes)):
            shape, dtype = shapes[_generic(n)]
            out[n] = part.view(shape).to(dtype)
    return {n: out[n] for n in names if n in out}
