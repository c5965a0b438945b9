"""Megatron sequence parallelism over the grid's model axis.

Counterpart of kmbart_tpu/parallel/sp.py. There one sharding constraint on
the residual stream (after each residual layer norm and after the two
embeddings, kmbart_tpu/models/bart.py:196-200, 326, 378) lets GSPMD turn
each tensor-parallel all-reduce into a reduce-scatter plus an all-gather.
Here the four moves are autograd functions over [B, T, D] tensors, split
along T into the model axis's ranks in order:

- ``gather``: all-gather before the column-parallel products; backward a
  reduce-scatter (each rank's products give a part of the gradient);
- ``reduce_scatter``: after the row-parallel products; backward an
  all-gather;
- ``scatter``: from a tensor whole on every rank (the embeddings) to this
  rank's rows; backward an all-gather;
- ``gather_replicated``: from the rows to a tensor whole on every rank
  whose consumers run replicated (the decoder's LM head, the encoder
  output); backward this rank's rows of the gradient, which every rank
  holds whole.

Between them the layer norms, dropouts and residual adds run on T/tp rows a
rank. ``TensorParallel.stack`` skips a stack whose length the degree does
not divide, as ``constrain`` does. Gloo has no reduce-scatter: there it is
an all-reduce and a slice (and CUDA tensors go through the host,
parallel/distributed.py); NCCL runs ``reduce_scatter_tensor``.
"""

import torch
import torch.distributed as dist

from kmbart_tpu_torch.parallel import distributed


def _rows(x, axis):
    n = x.shape[1] // axis.size
    return x.narrow(1, axis.index * n, n).contiguous()


def _all_gather(x, axis):
    B, t, D = x.shape
    rows = distributed.all_gather_flat(x.float().contiguous().reshape(-1), axis)
    return rows.view(axis.size, B, t, D).transpose(0, 1).reshape(B, axis.size * t, D).to(x.dtype)


def _reduce_scatter(x, axis):
    B, T, D = x.shape
    t = T // axis.size
    if dist.get_backend(axis.group) == "nccl":
        parts = x.float().reshape(B, axis.size, t, D).transpose(0, 1).contiguous()
        out = torch.empty((B, t, D), dtype=torch.float32, device=x.device)
        dist.reduce_scatter_tensor(out, parts, group=axis.group)
        return out.to(x.dtype)
    whole = x.float().contiguous().clone()
    distributed.all_reduce_axis(whole, axis)
    return _rows(whole, axis).to(x.dtype)


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return _all_gather(x, axis)

    @staticmethod
    def backward(ctx, g):
        return _reduce_scatter(g, ctx.axis), None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return _reduce_scatter(x, axis)

    @staticmethod
    def backward(ctx, g):
        return _all_gather(g, ctx.axis), None


class _Scatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return _rows(x, axis)

    @staticmethod
    def backward(ctx, g):
        return _all_gather(g, ctx.axis), None


class _GatherReplicated(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return _all_gather(x, axis)

    @staticmethod
    def backward(ctx, g):
        return _rows(g, ctx.axis), None


def gather(x, axis):
    return _Gather.apply(x, axis)


def reduce_scatter(x, axis):
    return _ReduceScatter.apply(x, axis)


def scatter(x, axis):
    return _Scatter.apply(x, axis)


def gather_replicated(x, axis):
    return _GatherReplicated.apply(x, axis)
