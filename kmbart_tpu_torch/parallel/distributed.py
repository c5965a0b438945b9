"""Multi-process data parallelism: the rendezvous, the rank helpers and the
collectives of the data-parallel step.

Counterpart of the ``--multihost`` branch of kmbart_tpu/cli_common.py
(:111-125) and of its ``is_main_process``, ``sync_timestamp`` and
``data_feed``. The JAX package runs one pjit program over the global batch;
the port runs one process per card, each on its own rows, and makes the
step's arithmetic global by hand:

- every masked mean divides its local sum by the count over all ranks
  (``global_count`` inside ``global_counts(axis)``), so the per-rank losses add
  up to the loss of the global batch;
- the gradients are summed over the ranks (``all_reduce_sum``, in a few
  flat buckets), which then gives the global batch's gradient.

The rendezvous reads ``KMBART_COORDINATOR_ADDRESS`` (host:port),
``KMBART_NUM_PROCESSES`` and ``KMBART_PROCESS_ID`` first, as the JAX
package does, and otherwise torchrun's ``MASTER_ADDR``/``MASTER_PORT``,
``RANK`` and ``WORLD_SIZE``. The backend follows the device: NCCL for a
CUDA device, each rank on ``cuda:{LOCAL_RANK}`` (default: its rank modulo
the visible cards), and gloo on the CPU. A process feeds one device, so a
per-process batch splits no further (the JAX ``local_batch_divisor`` is 1).

Under tensor, sequence and pipeline parallelism the ranks form a grid
(parallel/mesh.py) and each collective runs over one of its axes
(``Axis``): the counts, the gradient sums and the loss over the data axis,
the non-finite guard over every rank.
"""

import contextlib
import os

import torch
import torch.distributed as dist

BUCKET_ELEMS = 1 << 25     # 128 MiB of fp32 per flat all-reduce


def init_distributed(device="cuda", backend=None):
    """Join the process group; returns this rank's torch.device. ``device``
    is ``--device``: "cpu" takes gloo, "cuda" NCCL on ``cuda:{LOCAL_RANK}``,
    an explicit "cuda:N" NCCL on that card. ``backend`` overrides the
    choice (gloo on cards: several ranks sharing one card, which NCCL
    refuses)."""
    addr = os.environ.get("KMBART_COORDINATOR_ADDRESS")
    if addr:
        world = int(os.environ["KMBART_NUM_PROCESSES"])
        rank = int(os.environ["KMBART_PROCESS_ID"])
        init_method = f"tcp://{addr}"
    elif "MASTER_ADDR" in os.environ:
        world = int(os.environ["WORLD_SIZE"])
        rank = int(os.environ["RANK"])
        init_method = "env://"
    else:
        raise ValueError("--multihost needs KMBART_COORDINATOR_ADDRESS, KMBART_NUM_PROCESSES "
                         "and KMBART_PROCESS_ID, or torchrun's MASTER_ADDR, MASTER_PORT, "
                         "RANK and WORLD_SIZE")
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("--device cuda, but torch.cuda.is_available() is False")
        if dev.index is None:
            local = os.environ.get("LOCAL_RANK")
            local = int(local) if local is not None else rank % torch.cuda.device_count()
            dev = torch.device("cuda", local)
        torch.cuda.set_device(dev)
    elif dev.type != "cpu":
        raise ValueError(f"--multihost runs on cuda or cpu, not {device!r}")
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    kwargs = {"device_id": dev} if backend == "nccl" else {}
    dist.init_process_group(backend, init_method=init_method, world_size=world, rank=rank,
                            **kwargs)
    return dev


def shutdown():
    if dist.is_initialized():
        dist.destroy_process_group()


def world_size():
    return dist.get_world_size() if dist.is_initialized() else 1


def rank():
    return dist.get_rank() if dist.is_initialized() else 0


def is_main_process():
    return rank() == 0


def data_feed(grid=None):
    """(num_replicas, rank) for ShardedSampler: the slice of the global
    index stream this process loads. Under a process grid
    (parallel/mesh.py) the ranks of one data coordinate form a feed group
    and load the same rows."""
    if grid is not None:
        return grid.data.size, grid.data.index
    return world_size(), rank()


def sync_timestamp(timestamp):
    """Rank 0's run timestamp on every rank, so the job writes one
    checkpoint and log directory."""
    if world_size() == 1:
        return timestamp
    box = [timestamp]
    dist.broadcast_object_list(box, src=0)
    return box[0]


def barrier():
    if world_size() > 1:
        dist.barrier()


class Axis:
    """One axis of the process grid (parallel/mesh.py), as this rank sees
    it: its ``size``, this rank's ``index`` on it, the global ``ranks`` of
    this rank's group in axis order, and the ``group`` (None: the world,
    when the axis spans it). A size-1 axis needs no collective."""

    def __init__(self, size, index, ranks, group=None):
        self.size, self.index, self.ranks, self.group = size, index, tuple(ranks), group

    def __repr__(self):
        return f"Axis(size={self.size}, index={self.index}, ranks={self.ranks})"


def world_axis():
    return Axis(world_size(), rank(), range(world_size()))


_COUNT_AXIS = [None]


@contextlib.contextmanager
def global_counts(axis):
    """Within the block, ``global_count`` sums counts over the ranks of
    ``axis``, the data axis, whose ranks hold different rows (None, or a
    size-1 axis: no sum)."""
    prev = _COUNT_AXIS[0]
    _COUNT_AXIS[0] = axis if axis is not None and axis.size > 1 else None
    try:
        yield
    finally:
        _COUNT_AXIS[0] = prev


def _staged(t, group):
    """Gloo takes CUDA tensors through a host copy (several ranks on one
    card rendezvous over gloo, since NCCL refuses them)."""
    return t.is_cuda and dist.get_backend(group) == "gloo"


def _all_reduce(t, group=None):
    """Sum ``t`` over the ranks of ``group`` in place."""
    if _staged(t, group):
        host = t.cpu()
        dist.all_reduce(host, group=group)
        t.copy_(host)
    else:
        dist.all_reduce(t, group=group)


def all_reduce_axis(t, axis):
    """``t`` summed over ``axis`` in place (nothing for a size-1 axis)."""
    if axis is not None and axis.size > 1:
        _all_reduce(t, axis.group)
    return t


def global_count(n):
    """The count a masked mean divides by: ``n`` itself, or inside
    ``global_counts(axis)`` its sum over the axis's ranks (one all-reduce;
    exact for counts below 2^24)."""
    axis = _COUNT_AXIS[0]
    if axis is None:
        return n
    total = n.detach().to(torch.float32).reshape(1).clone()
    _all_reduce(total, axis.group)
    return total.reshape(()).to(n.dtype)


def _buckets(tensors, limit):
    bucket, size = [], 0
    for t in tensors:
        if bucket and size + t.numel() > limit:
            yield bucket
            bucket, size = [], 0
        bucket.append(t)
        size += t.numel()
    if bucket:
        yield bucket


def all_reduce_sum(tensors, bucket_elems=BUCKET_ELEMS, axis=None):
    """Sum each tensor (all of one dtype) over the ranks of ``axis``
    (default: every rank) in place, in flat buckets of at most
    ``bucket_elems`` elements: one all-reduce a bucket."""
    axis = world_axis() if axis is None else axis
    if axis.size == 1:
        return
    for bucket in _buckets(tensors, bucket_elems):
        flat = torch.cat([t.reshape(-1) for t in bucket])
        _all_reduce(flat, axis.group)
        for t, part in zip(bucket, flat.split([t.numel() for t in bucket])):
            t.copy_(part.view_as(t))


def all_gather_flat(local, axis=None):
    """[axis size, n]: every rank's 1-D ``local`` (all of length n) over
    ``axis`` (default: every rank), exactly. NCCL gathers in one call; gloo
    takes one broadcast per rank, through a host copy for CUDA tensors."""
    axis = world_axis() if axis is None else axis
    out = torch.empty((axis.size, local.numel()), dtype=local.dtype, device=local.device)
    if axis.size == 1:
        out[0].copy_(local)
        return out
    if dist.get_backend(axis.group) == "nccl":
        dist.all_gather_into_tensor(out, local.contiguous(), group=axis.group)
        return out
    host = out.cpu()
    host[axis.index].copy_(local)
    for i, r in enumerate(axis.ranks):
        dist.broadcast(host[i], src=r, group=axis.group)
    out.copy_(host)
    return out


def all_gather_blocks(block, max_rows, fill, axis, tag=0):
    """Each rank's integer ``block`` [n, W] (n <= ``max_rows``) and an int
    ``tag`` -> (the ranks' blocks joined in axis order [sum n, W], [each
    rank's tag]) on every rank of ``axis``. One ``all_gather_flat`` of
    int32: the block padded to ``max_rows`` rows with ``fill``, its row
    count and the tag appended. The gather copies the bits, so int32
    round-trips exactly (generation's token blocks over the data axis)."""
    n, W = block.shape
    flat = torch.full((max_rows * W + 2,), fill, dtype=torch.int32, device=block.device)
    flat[:n * W] = block.reshape(-1).to(torch.int32)
    flat[-2], flat[-1] = n, tag
    rows = all_gather_flat(flat, axis).cpu()
    counts, tags = rows[:, -2].tolist(), rows[:, -1].tolist()
    joined = torch.cat([rows[i, :c * W].view(c, W) for i, c in enumerate(counts)])
    return joined.to(block.device), tags


def broadcast(t, src_index, axis):
    """``t`` in place from the rank at ``src_index`` on ``axis``."""
    if axis.size == 1:
        return t
    src = axis.ranks[src_index]
    if _staged(t, axis.group):
        host = t.cpu()
        dist.broadcast(host, src=src, group=axis.group)
        t.copy_(host)
    else:
        dist.broadcast(t, src=src, group=axis.group)
    return t


def send(t, dst):
    """Point-to-point send to global rank ``dst`` (gloo: CUDA tensors
    through a host copy)."""
    if _staged(t, None):
        t = t.cpu()
    dist.send(t.contiguous(), dst=dst)


def recv(shape, dtype, device, src):
    """The tensor global rank ``src`` sends (``send``)."""
    out = torch.empty(shape, dtype=dtype, device=device)
    if _staged(out, None):
        host = torch.empty(shape, dtype=dtype)
        dist.recv(host, src=src)
        return out.copy_(host)
    dist.recv(out, src=src)
    return out
