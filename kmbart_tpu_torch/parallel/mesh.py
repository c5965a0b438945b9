"""The process grid of the parallel axes: data x stage x model.

Counterpart of kmbart_tpu/parallel/mesh.py (``make_mesh``,
``data_feed_layout``) and of kmbart_tpu/parallel/pp.py:51-146
(``make_pp_mesh``, ``_span_process_grid``). A JAX mesh holds devices; the
port runs one process per device, so each mesh axis becomes a group of
processes and each rank holds one coordinate (d, s, m) of the grid:

- the model axis (tensor parallelism, parallel/tp.py) is innermost, then the
  stage axis (pipeline parallelism, parallel/pp.py), then the data axis, as
  ``make_pp_mesh`` lays them out;
- ``span_processes`` (``--pipeline_span_processes``) puts the stage axis
  outermost instead: stage j is the j-th contiguous block of ranks, the
  layout ``_span_process_grid`` gives when each process holds one device;
- the ranks of one data coordinate (all its stages and model shards) cover
  the same rows: they form a feed group and load identical batches
  (``data_feed_layout``). ``--batch_size`` is per feed group, as it is per
  process in the JAX package.

Every rank builds every group (``torch.distributed.new_group`` is a
collective over the world), in one order.
"""

import numpy as np
import torch.distributed as dist

from kmbart_tpu_torch.parallel import distributed
from kmbart_tpu_torch.parallel.distributed import Axis


def grid_ranks(world, model_parallel=1, stages=1, span_processes=False):
    """[data, stage, model] array of the global ranks, with the errors of
    the JAX mesh functions (kmbart_tpu/cli_common.py:316, pp.py:74,97)."""
    if stages > 1:
        if world % stages:
            raise ValueError(f"{world} devices not divisible by stages={stages}")
        if model_parallel > 1 and world % (stages * model_parallel):
            raise ValueError(f"{world} devices not divisible by stages={stages} x "
                             f"model_parallel={model_parallel}")
    elif world % model_parallel:
        raise ValueError(f"{world} devices not divisible by model_parallel={model_parallel}")
    n_data = world // (stages * model_parallel)
    if span_processes and stages > 1:
        d, s, m = np.meshgrid(np.arange(n_data), np.arange(stages), np.arange(model_parallel),
                              indexing="ij")
        return s * (world // stages) + d * model_parallel + m
    return np.arange(world).reshape(n_data, stages, model_parallel)


class Grid:
    """This rank's place in the grid and the groups of its axes: ``data``,
    ``stage``, ``model`` and ``feed`` (the ranks of this data coordinate),
    each a ``distributed.Axis``; ``world`` is every rank. Without a process
    group every axis has size 1. ``tp`` is the tensor-parallel context
    (parallel/tp.py) when the model axis is longer than 1."""

    def __init__(self, model_parallel=1, stages=1, span_processes=False,
                 sequence_parallel=False):
        world, me = distributed.world_size(), distributed.rank()
        self.ranks = grid_ranks(world, model_parallel, stages, span_processes)
        d, s, m = (int(i[0]) for i in np.nonzero(self.ranks == me))
        self.coords = (d, s, m)
        n_data = self.ranks.shape[0]
        lines = {
            "data": [self.ranks[:, j, k] for j in range(stages) for k in range(model_parallel)],
            "stage": [self.ranks[i, :, k] for i in range(n_data) for k in range(model_parallel)],
            "model": [self.ranks[i, j, :] for i in range(n_data) for j in range(stages)],
            "feed": [self.ranks[i].reshape(-1) for i in range(n_data)],
        }
        for name, groups in lines.items():
            axis = None
            for ranks in groups:
                ranks = [int(r) for r in ranks]
                group = None
                if 1 < len(ranks) < world:
                    group = dist.new_group(ranks)
                if me in ranks:
                    axis = Axis(len(ranks), ranks.index(me), ranks, group)
            setattr(self, name, axis)
        self.world = distributed.world_axis()
        self.sequence_parallel = sequence_parallel and model_parallel > 1
        self.tp = None
        if model_parallel > 1:
            from kmbart_tpu_torch.parallel.tp import TensorParallel
            self.tp = TensorParallel(self.model, self.sequence_parallel)

    @property
    def parallel(self):
        """Whether the model is split (tensor or pipeline parallelism)."""
        return self.model.size > 1 or self.stage.size > 1

    def __repr__(self):
        return (f"Grid(data={self.data.size}, stage={self.stage.size}, "
                f"model={self.model.size}, coords={self.coords})")
