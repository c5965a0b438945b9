"""Sharded train checkpoints on ``torch.distributed.checkpoint``.

Counterpart of kmbart_tpu/checkpoint/sharded.py (``save_sharded`` :44,
``load_sharded`` :72), in the port's own format: the JAX package writes
orbax's layout, which the port cannot read, and the port's cannot be read
by the JAX package (the portable npz checkpoint, checkpoint/io.py, goes
both ways). A checkpoint directory holds ``config.json`` and
``sharded_state/``, written by every rank of the job together:

- the parameters and every replicated moment are written once (the
  checkpoint planner gives each replicated tensor one writer);
- under ZeRO-1 (parallel/zero1.py) each rank writes its own moment parts,
  a sliced part under ``{mu,nu}/{name}@{axis}.{rank}.{world}``;
- under tensor parallelism (parallel/tp.py) each rank writes its slice of a
  split tensor under ``{params,mu,nu}/{name}#{axis}.{m}.{M}`` (its place m
  of M on the model axis, before any ZeRO-1 suffix); under pipeline
  parallelism each stage writes its own layers, whose names are its own.

``load_sharded`` reads every tensor whole into the calling process, so a
checkpoint written by W ranks loads into any number of processes (each
then takes its parts again, ``parallel/tp.py shard_params``, and its
ZeRO-1 parts).
"""

import os
import re

import torch
import torch.distributed.checkpoint as dcp

from kmbart_tpu_torch.training.adamw import AdamWState
from kmbart_tpu_torch.training.state import model_tensors

STATE_DIR = "sharded_state"
_KEY = re.compile(r"^(params|mu|nu)/([^#@]+)(?:#(\d+)\.(\d+)\.(\d+))?(?:@(\d+)\.(\d+)\.(\d+))?$")


def sharded_state_dir(path):
    return os.path.join(path, STATE_DIR) if path else None


def has_sharded_state(path):
    return bool(path) and os.path.isdir(sharded_state_dir(path))


def _tp_suffix(name, grid):
    from kmbart_tpu_torch.parallel.tp import tp_axis
    axis = None if grid is None or grid.model.size == 1 else tp_axis(name)
    return "" if axis is None else f"#{axis}.{grid.model.index}.{grid.model.size}"


def save_sharded(path, state, epoch, zero1=None, grid=None):
    """Write ``state`` (a TrainState) and ``epoch`` to ``path/sharded_state``;
    a collective when a process group is up: every rank calls it. ``grid``:
    the process grid of a split model (parallel/mesh.py)."""
    sd = {f"params/{n}{_tp_suffix(n, grid)}": t.detach()
          for n, t in model_tensors(state.params).items()}
    opt = state.opt_state
    for field in ("mu", "nu"):
        for name, m in getattr(opt, field).items():
            kind = zero1.kind[name] if zero1 is not None else ("replicated",)
            key = f"{field}/{name}{_tp_suffix(name, grid)}"
            if kind[0] == "slice":
                sd[f"{key}@{kind[1]}.{zero1.rank}.{zero1.world}"] = m
            else:
                sd[key] = m
    for key, v in (opt.leaf_steps or {}).items():
        sd[f"leaf_steps/{key}"] = v
    sd["opt_step"] = opt.step
    sd["meta"] = torch.tensor([epoch, state.step], dtype=torch.int64)
    dcp.save(sd, checkpoint_id=sharded_state_dir(path))


def load_sharded(path, device="cpu"):
    """{"params", "opt_state", "epoch", "step"} of the checkpoint at ``path``
    (the directory holding ``sharded_state/``), every tensor whole, on
    ``device``."""
    root = sharded_state_dir(path)
    meta = dcp.FileSystemReader(root).read_metadata().state_dict_metadata
    sd = {k: torch.empty(tuple(m.size), dtype=m.properties.dtype) for k, m in meta.items()}
    dcp.load(sd, checkpoint_id=root)
    # {(field, name): {(tp axis, m): {(zero1 axis, r): tensor}}}
    pieces = {}
    for key, t in sd.items():
        m = _KEY.match(key)
        if m:
            field, name, tp_ax, tp_m, _, z_ax, z_r, _ = m.groups()
            tp_part = None if tp_ax is None else (int(tp_ax), int(tp_m))
            z_part = None if z_ax is None else (int(z_ax), int(z_r))
            pieces.setdefault((field, name), {}).setdefault(tp_part, {})[z_part] = t
    whole = {"params": {}, "mu": {}, "nu": {}}
    join = lambda parts: (parts[None] if None in parts else
                          torch.cat([parts[k] for k in sorted(parts)], dim=min(parts)[0]))
    for (field, name), by_tp in pieces.items():
        whole[field][name] = join({k: join(v) for k, v in by_tp.items()})
    to = lambda d: {k: v.to(device) for k, v in d.items()}
    leaf_steps = {k[len("leaf_steps/"):]: v.to(device) for k, v in sd.items()
                  if k.startswith("leaf_steps/")}
    epoch, step = (int(x) for x in sd["meta"])
    return {"params": to(whole["params"]),
            "opt_state": AdamWState(step=sd["opt_step"].to(device), mu=to(whole["mu"]),
                                    nu=to(whole["nu"]), leaf_steps=leaf_steps or None),
            "epoch": epoch, "step": step}


@torch.no_grad()
def load_params_into(model, params):
    """Copy ``load_sharded``'s parameters into ``model``; a tensor the
    checkpoint lacks (a fine-tune checkpoint's in the pretraining model:
    the heads) keeps its initialisation."""
    for name, t in model_tensors(model).items():
        if name in params:
            t.copy_(params[name].to(t.device))
