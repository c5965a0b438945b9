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
  a sliced part under ``{mu,nu}/{name}@{axis}.{rank}.{world}``.

``load_sharded`` reads every tensor whole into the calling process, so a
checkpoint written by W ranks loads into any number of processes (each
then takes its ZeRO-1 parts again).
"""

import os
import re

import torch
import torch.distributed.checkpoint as dcp

from kmbart_tpu_torch.training.adamw import AdamWState
from kmbart_tpu_torch.training.state import model_tensors

STATE_DIR = "sharded_state"
_PART = re.compile(r"^(mu|nu)/(.+)@(\d+)\.(\d+)\.(\d+)$")


def sharded_state_dir(path):
    return os.path.join(path, STATE_DIR) if path else None


def has_sharded_state(path):
    return bool(path) and os.path.isdir(sharded_state_dir(path))


def save_sharded(path, state, epoch, zero1=None):
    """Write ``state`` (a TrainState) and ``epoch`` to ``path/sharded_state``;
    a collective when a process group is up: every rank calls it."""
    sd = {f"params/{n}": t.detach() for n, t in model_tensors(state.params).items()}
    opt = state.opt_state
    for field in ("mu", "nu"):
        for name, m in getattr(opt, field).items():
            kind = zero1.kind[name] if zero1 is not None else ("replicated",)
            if kind[0] == "slice":
                sd[f"{field}/{name}@{kind[1]}.{zero1.rank}.{zero1.world}"] = m
            else:
                sd[f"{field}/{name}"] = m
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
    moments = {"mu": {}, "nu": {}}
    parts = {}
    for key, t in sd.items():
        m = _PART.match(key)
        if m:
            field, name, axis, r, _ = m.groups()
            parts.setdefault((field, name, int(axis)), {})[int(r)] = t
        elif key.startswith(("mu/", "nu/")):
            field, name = key.split("/", 1)
            moments[field][name] = t
    for (field, name, axis), by_rank in parts.items():
        moments[field][name] = torch.cat([by_rank[r] for r in sorted(by_rank)], dim=axis)
    to = lambda d: {k: v.to(device) for k, v in d.items()}
    leaf_steps = {k[len("leaf_steps/"):]: v.to(device) for k, v in sd.items()
                  if k.startswith("leaf_steps/")}
    epoch, step = (int(x) for x in sd["meta"])
    return {"params": to({k[len("params/"):]: v for k, v in sd.items()
                          if k.startswith("params/")}),
            "opt_state": AdamWState(step=sd["opt_step"].to(device), mu=to(moments["mu"]),
                                    nu=to(moments["nu"]), leaf_steps=leaf_steps or None),
            "epoch": epoch, "step": step}


@torch.no_grad()
def load_params_into(model, params):
    """Copy ``load_sharded``'s parameters into ``model``; a tensor the
    checkpoint lacks (a fine-tune checkpoint's in the pretraining model:
    the heads) keeps its initialisation."""
    for name, t in model_tensors(model).items():
        if name in params:
            t.copy_(params[name].to(t.device))
