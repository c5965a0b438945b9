"""K12: AdamW over many tensors in a few launches (``csrc/adamw.cu``).

The wrapper of the kernels behind ``training/adamw.py AdamW.update`` on
CUDA tensors; that module keeps the plain per-tensor version, which runs
on CPU tensors. Its source note says what the kernels compute, what bounds
them on an H100 and how the design answers that.

Each tensor the update touches is described as ``rows`` rows of ``cols``
contiguous fp32 elements, row i at i times a row stride (``rows_of``): a
contiguous tensor is one row, a ``narrow`` of one (a ZeRO-1 part, on any
dimension) many; any other layout raises. A launch takes up to ``TABLE``
tensors, passed by value as kernel arguments (``Table``, the C struct
``AdamWTable`` byte for byte), so nothing is copied to the card but the
launch itself. A step is ``Plan.launch``: the "used" test over the whole
gradients (a memset and one launch per ``TABLE`` tensors), the caller's
``any_over`` on the flags, the steps kernel (each group's step count and
step size, the global step), then the update (one launch per ``TABLE``
tensors): four device operations a step at BART-base. A ``Plan`` holds
what does not change between steps (the tables with the p, m and v
addresses, the flag, step and step-size buffers); a step writes only the
gradients' addresses into the tables.
"""

import math

import numpy as np
import torch

from kmbart_tpu_torch.ops import _cuda
from kmbart_tpu_torch.utils.profiling import count

TABLE = 384      # tensors a launch (csrc/adamw.cu kTensors)
CHUNK = 4096     # elements a block (kChunk)
TABLE_BYTES = 68 * TABLE
_INT_MAX = 2 ** 31 - 1


def rows_of(*tensors):
    """(rows, cols, [row stride of each tensor]): tensors of one shape as
    ``rows`` rows of ``cols`` contiguous elements, row i at i x stride
    (elements); the largest ``cols`` that every tensor holds contiguous.
    Raises ValueError for a layout that is not so (a transposed or expanded
    tensor, a view strided in two outer dimensions)."""
    shape = tuple(tensors[0].shape)
    if any(tuple(t.shape) != shape for t in tensors):
        raise ValueError(f"adamw kernel: shapes differ {[tuple(t.shape) for t in tensors]}")
    dims = [d for d, n in enumerate(shape) if n != 1]
    k, cols = len(dims), 1
    while k and all(t.stride(dims[k - 1]) == cols for t in tensors):
        k -= 1
        cols *= shape[dims[k]]
    if not k:
        return 1, cols, [cols] * len(tensors)
    outer = dims[:k]
    rows = math.prod(shape[d] for d in outer)
    strides = []
    for t in tensors:
        stride = span = t.stride(outer[-1])
        for d in reversed(outer):
            if t.stride(d) != span:
                raise ValueError(f"adamw kernel takes rows of contiguous elements with one "
                                 f"row stride, got shape {shape} strides {t.stride()}")
            span *= shape[d]
        if stride < cols:
            raise ValueError(f"adamw kernel: overlapping rows, shape {shape} strides "
                             f"{t.stride()}")
        strides.append(stride)
    return rows, cols, strides


def blocks_of(rows, cols):
    """The kernels' blocks over a tensor: ``CHUNK`` elements of one row
    each."""
    return rows * -(-cols // CHUNK)


def launch_slices(n, capacity=TABLE):
    """[(start, end)]: n tensors in launches of at most ``capacity``."""
    return [(i, min(i + capacity, n)) for i in range(0, n, capacity)]


class Table:
    """One launch's ``AdamWTable`` in host memory: four address columns (p,
    g, m, v), three int64 row-stride columns (p, g, m and v) and three int32
    columns (cols, group, cumulative blocks), ``TABLE`` entries each.
    ``entries``: (p, m, v addresses, cols, p, g, m and v row strides, group,
    blocks) per tensor."""

    def __init__(self, entries):
        if not 0 < len(entries) <= TABLE:
            raise ValueError(f"adamw kernel: {len(entries)} tensors in a launch of {TABLE}")
        self.buf = np.zeros(TABLE_BYTES, np.uint8)
        T = TABLE
        self.addr = self.buf[:32 * T].view(np.uint64).reshape(4, T)
        strides = self.buf[32 * T:56 * T].view(np.int64).reshape(3, T)
        ints = self.buf[56 * T:].view(np.int32).reshape(3, T)
        n = self.count = len(entries)
        cols = np.array([e[3] for e in entries], np.int64)
        blocks = np.cumsum([e[8] for e in entries])
        if cols.max() > _INT_MAX or blocks[-1] > _INT_MAX:
            raise ValueError("adamw kernel: a row or a launch past 2**31 elements or blocks")
        self.blocks = int(blocks[-1])
        for col, i in ((0, 0), (2, 1), (3, 2)):
            self.addr[col, :n] = [e[i] for e in entries]
        strides[:, :n] = np.array([e[4:7] for e in entries], np.int64).T
        ints[:, :n] = [cols, [e[7] for e in entries], blocks]
        self.address = self.buf.ctypes.data

    def set_grads(self, addresses):
        """This step's gradient addresses (0: a zero gradient)."""
        self.addr[1, :self.count] = addresses


class Plan:
    """K12 over fixed tensors. ``used``: (rows, cols, row stride, group) of
    each whole gradient the "used" test reads; ``update``: (p, m, v, group,
    gradient offset in bytes) of each tensor this process updates, p, m and
    v tensors of one shape (``rows_of``), the gradient in p's layout (its
    part at that offset from the whole gradient's address); ``groups``: how
    many groups. ``steps`` [1 + groups] int32 holds the global step, then
    each group's (``AdamWState.step`` and ``leaf_steps`` view it)."""

    def __init__(self, used, update, groups, device):
        lib = _cuda.lib()
        if lib.kmb_adamw_table_bytes() != TABLE_BYTES:
            raise RuntimeError("ops/adamw.py Table and csrc/adamw.cu AdamWTable differ")
        self.device, self.groups = device, groups
        self.used_tables = [Table([(0, 0, 0, cols, 0, stride, 0, grp, blocks_of(rows, cols))
                            for rows, cols, stride, grp in used[a:b]])
                     for a, b in launch_slices(len(used))]
        entries, self.goff = [], []
        for p, m, v, grp, goff in update:
            rows, cols, (sp, sm, sv) = rows_of(p, m, v)
            if sm != sv:
                raise ValueError("adamw kernel: the two moments' layouts differ")
            entries.append((p.data_ptr(), m.data_ptr(), v.data_ptr(), cols, sp, sp, sm, grp,
                            blocks_of(rows, cols)))
            self.goff.append(goff)
        self.goff = np.array(self.goff, np.uint64)
        self.update_tables = [Table(entries[a:b]) for a, b in launch_slices(len(entries))]
        self.flags = torch.zeros(groups, dtype=torch.bool, device=device)
        self.steps = torch.zeros(1 + groups, dtype=torch.int32, device=device)
        self.gused = torch.empty(groups, dtype=torch.int32, device=device)
        self.gstep = torch.empty(groups, dtype=torch.float32, device=device)

    def launch(self, grads, update_grads, ok, any_over, per_leaf, correct_bias, lr, b1, b2,
               eps, weight_decay):
        """One step. ``grads``: the whole gradients' addresses in ``used``'s
        order, ``update_grads`` the indices into it of ``update``'s tensors
        (np.uint64, np.intp; address 0: a zero gradient); ``ok``: a bool
        scalar on the card or None; ``any_over``: ORs the groups' flags
        over other ranks, or None."""
        if ok is not None and ok.dtype != torch.bool:
            raise TypeError(f"adamw kernel takes a bool guard, got {ok.dtype}")
        lib, stream = _cuda.prepare(self.device)
        flags = self.flags.data_ptr()
        start = 0
        for i, table in enumerate(self.used_tables):
            table.set_grads(grads[start:start + table.count])
            start += table.count
            _cuda.check(lib.kmb_adamw_used(table.address, table.count, table.blocks, flags,
                                           self.groups, int(i == 0), stream), "adamw used")
            count("launch.adamw")
        used = self.flags if any_over is None else any_over(self.flags)
        _cuda.check(lib.kmb_adamw_steps(self.steps.data_ptr(), used.data_ptr(),
                                        None if ok is None else ok.data_ptr(),
                                        self.gused.data_ptr(), self.gstep.data_ptr(),
                                        self.groups, int(per_leaf), int(correct_bias), lr, b1,
                                        b2, stream), "adamw steps")
        count("launch.adamw")
        src = grads[update_grads]
        addresses = np.where(src != 0, src + self.goff, np.uint64(0))
        start = 0
        for table in self.update_tables:
            table.set_grads(addresses[start:start + table.count])
            start += table.count
            _cuda.check(lib.kmb_adamw_update(table.address, table.count, table.blocks,
                                             self.gused.data_ptr(), self.gstep.data_ptr(), b1,
                                             1.0 - b1, b2, 1.0 - b2, eps, lr * weight_decay,
                                             int(weight_decay > 0.0), stream), "adamw update")
            count("launch.adamw")
