"""ZeRO-1: the AdamW moments sharded over the data-parallel ranks.

Counterpart of kmbart_tpu/parallel/tp.py:71-88 (``_zero1_spec``,
``zero1_moment_specs``). There each moment leaf is sharded on the first
axis that the tensor-parallel rules leave free and that the data-axis size
divides; a leaf with no such axis stays replicated. The port picks the same
axis of the same JAX leaf (``leaf_axes``) and maps it onto its own
tensors, one per layer where JAX stacks the layers:

- the stacked layer axis: each rank owns whole tensors, the layers
  ``[r·L/W, (r+1)·L/W)``;
- any other axis: each rank owns a slice of every tensor of the leaf, on
  the port tensor's matching axis ([out, in] kernels are transposed);
- no axis: every rank updates the whole tensor.

Parameters and gradients stay replicated (plain data parallelism): each
rank updates its part of each parameter from the summed gradient, then the
parts are all-gathered.

Under tensor and pipeline parallelism (parallel/mesh.py) the moments of a
rank's own part of the model (its slice, its stage's layers) are sharded
over the data axis only, on the first axis that the composed JAX specs
leave free (``stage_param_specs``: the stage axis takes the layer axis,
and without a model axis the tensor-parallel axes stay free). The "used" test and the per-leaf step counts read
whole gradients (training/adamw.py ``part``), so each element's arithmetic
is the replicated run's, and the parameters are bit-equal to it.
"""

import torch

from kmbart_tpu_torch.checkpoint.io import _leaf_map
from kmbart_tpu_torch.parallel.distributed import all_gather_flat

# which axes the JAX tensor-parallel rules (kmbart_tpu/parallel/tp.py:20-43)
# give the "model" axis; ZeRO-1 leaves them alone
_LAYER_MODEL_AXIS = {"q_kernel": 2, "k_kernel": 2, "v_kernel": 2, "q_bias": 1, "k_bias": 1,
                     "v_bias": 1, "o_kernel": 1, "fc1_kernel": 2, "fc1_bias": 1,
                     "fc2_kernel": 1}
_TOP_MODEL_AXIS = {"shared": 1, "embed_positions": 1, "dense_kernel": 1, "dense_bias": 0,
                   "out_kernel": 0, "kernel": 1}


def _jax_leaves(cfg, shapes, heads):
    """{JAX leaf key: (JAX shape, [(port name, layer or None, transpose)])}
    for the port tensors of ``shapes`` ({name: shape})."""
    leaves = {}
    for name, key, layer, transpose in _leaf_map(cfg, heads):
        if name not in shapes:
            continue
        shape = tuple(shapes[name])
        if name == "final_logits_bias":
            shape = shape[-1:]
        elif transpose:
            shape = shape[::-1]
        entry = leaves.setdefault(key, [shape, []])
        entry[1].append((name, layer, transpose))
        if layer is not None:
            entry[0] = (len(entry[1]),) + shape
    return {k: (tuple(v[0]), v[1]) for k, v in leaves.items()}


def _zero1_axis(key, shape, world, tp_rules=True, stages=False):
    """The first axis of the leaf that the partition specs leave free and
    ``world`` divides, or None. ``tp_rules``: the tensor-parallel rules
    name their axes (always, but under pipeline parallelism without a model
    axis); ``stages``: the stage axis takes a stacked leaf's layer axis."""
    name = key.rsplit("/", 1)[-1]
    layer = "/layers/" in key
    rules = _LAYER_MODEL_AXIS if layer else _TOP_MODEL_AXIS
    taken = {rules.get(name)} if tp_rules else set()
    if stages and layer:
        taken.add(0)
    for i, dim in enumerate(shape):
        if i not in taken and dim >= world and dim % world == 0:
            return i
    return None


def leaf_axes(cfg, shapes, world, heads=False, tp_rules=True, stages=False):
    """{JAX leaf key: the axis ZeRO-1 shards its moments on, or None}: the
    axis that ``kmbart_tpu.parallel.tp.zero1_moment_specs`` names "data"
    (over the specs of ``stage_param_specs`` under ``stages``)."""
    return {k: _zero1_axis(k, shape, world, tp_rules, stages)
            for k, (shape, _) in _jax_leaves(cfg, shapes, heads).items()}


class Zero1:
    """The moment layout of one rank. ``tensors``: {port name: tensor} that
    the optimizer updates (training/state.py ``model_tensors``)."""

    def __init__(self, cfg, tensors, world, rank, heads=False, grid=None):
        self.world, self.rank = world, rank
        self.axis = None if grid is None else grid.data
        stages = grid is not None and grid.stage.size > 1
        tp_rules = not stages or grid.model.size > 1
        shapes = {n: tuple(t.shape) for n, t in tensors.items()}
        self.kind = {}
        for key, (shape, members) in _jax_leaves(cfg, shapes, heads).items():
            axis = _zero1_axis(key, shape, world, tp_rules, stages)
            per_rank = shape[0] // world if axis is not None else 0
            for name, layer, transpose in members:
                if axis is None:
                    self.kind[name] = ("replicated",)
                elif layer is not None and axis == 0:
                    self.kind[name] = ("owner", layer // per_rank)
                else:
                    a = axis - (layer is not None)
                    if name == "final_logits_bias":
                        a = 1
                    elif transpose:
                        a = 1 - a
                    self.kind[name] = ("slice", a)
        names = list(tensors)
        self._sliced = [n for n in names if self.kind[n][0] == "slice"]
        self._owned = [[n for n in names if self.kind[n] == ("owner", r)]
                       for r in range(world)]

    def part(self, name, t):
        """This rank's part of ``t`` (a view), or None for a tensor another
        rank owns."""
        kind = self.kind[name]
        if kind[0] == "replicated":
            return t
        if kind[0] == "owner":
            return t if kind[1] == self.rank else None
        n = t.shape[kind[1]] // self.world
        return t.narrow(kind[1], self.rank * n, n)

    def shard_state(self, state):
        """A whole AdamW state (every moment full size) -> this rank's."""
        pick = lambda moments: {n: self.part(n, m).clone() for n, m in moments.items()
                                if self.part(n, m) is not None}
        return state._replace(mu=pick(state.mu), nu=pick(state.nu))

    @torch.no_grad()
    def _gather(self, local, full):
        """Every rank's parts of ``full`` ({name: tensor}, updated in place
        from ``local`` = this rank's parts, {name: tensor})."""
        own = [local[n] for n in self._sliced + self._owned[self.rank]]
        rows = all_gather_flat(torch.cat([t.reshape(-1) for t in own]), self.axis)
        for r in range(self.world):
            offset = 0
            for name in self._sliced + self._owned[r]:
                dst = full[name]
                if self.kind[name][0] == "slice":
                    axis = self.kind[name][1]
                    n = dst.shape[axis] // self.world
                    dst = dst.narrow(axis, r * n, n)
                size = dst.numel()
                dst.copy_(rows[r, offset:offset + size].view(dst.shape))
                offset += size

    def gather_params(self, params):
        """After each rank updated its parts: every parameter whole on every
        rank, bit for bit."""
        self._gather({n: self.part(n, params[n]) for n in self._sliced + self._owned[self.rank]},
                     params)

    def full_state(self, state, tensors):
        """This rank's AdamW state -> the whole one on every rank (a
        collective: call it on all ranks); ``tensors`` give the shapes."""
        out = {}
        for field in ("mu", "nu"):
            moments = getattr(state, field)
            full = {}
            for name, t in tensors.items():
                if self.kind[name][0] == "replicated":
                    full[name] = moments[name]
                else:
                    full[name] = torch.zeros(t.shape, dtype=torch.float32, device=t.device)
            self._gather(moments, full)
            out[field] = full
        return state._replace(**out)

    def update(self, optimizer, grads, state, params, ok=None, **kw):
        """AdamW on this rank's parts, then the parameters gathered."""
        new = optimizer.update(grads, state, params, ok=ok, part=self.part, **kw)
        self.gather_params(params)
        return new
