"""Worker of tests/test_torch_multiprocess.py: one rank of a data-parallel
job of the PyTorch port on the CPU (gloo), or the one process it is held
to. ``python -m tests._torch_dp_workers <out_dir>``; the rendezvous comes
from KMBART_COORDINATOR_ADDRESS, KMBART_NUM_PROCESSES and
KMBART_PROCESS_ID, and a run without them is the single process.

It writes ``<out_dir>/rank<r>.pt``: the gradients of one step at fp32 on an
8-row batch whose two halves hold unequal numbers of labels (rank r takes
rows [4r, 4r + 4)), with and without two accumulation micro-batches, and the
parameters after three AdamW steps, replicated and with ZeRO-1, and the
non-finite guard's verdict on a step whose last rank alone sees NaN
features. The ZeRO-1 state is also saved sharded (``<out_dir>/sharded``)
and as the portable npz (``<out_dir>/npz``).
"""

import os
import sys

import numpy as np
import torch

from kmbart_tpu_torch.checkpoint.io import jax_leaf_groups
from kmbart_tpu_torch.cli_common import save_train_checkpoint
from kmbart_tpu_torch.config import tiny_config
from kmbart_tpu_torch.models.conditional import conditional_loss, init_conditional_model
from kmbart_tpu_torch.parallel import distributed
from kmbart_tpu_torch.parallel.mesh import Grid
from kmbart_tpu_torch.parallel.train_step import build_train_step
from kmbart_tpu_torch.parallel.zero1 import Zero1
from kmbart_tpu_torch.training.adamw import AdamW
from kmbart_tpu_torch.training.state import TrainState, model_tensors

ROWS, T_ENC, T_DEC = 8, 12, 10


def make_batch(cfg, seed=0):
    """8 rows; rows 0-3 keep 9 labels each, rows 4-7 one or two."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(4, cfg.vocab_size, (ROWS, T_ENC))
    ids[:, 1:1 + cfg.max_img_num] = cfg.img_feat_id
    labels = rng.integers(4, cfg.vocab_size, (ROWS, T_DEC))
    labels[:4, 9:] = -100
    labels[4:, 2:] = -100
    labels[5, 1] = -100
    dec = np.concatenate([np.zeros((ROWS, 1), np.int64), np.maximum(labels[:, :-1], 1)], 1)
    feats = rng.normal(size=(ROWS, cfg.max_img_num, cfg.image_feature_size))
    return {"input_ids": torch.as_tensor(ids), "attention_mask": torch.ones((ROWS, T_ENC),
                                                                           dtype=torch.long),
            "image_features": torch.as_tensor(feats, dtype=torch.float32),
            "decoder_input_ids": torch.as_tensor(dec), "labels": torch.as_tensor(labels)}


def rows_of(batch, idx):
    return {k: v[idx] for k, v in batch.items()}


class _Capture:
    """AdamW that keeps the gradients it was given."""

    def __init__(self, inner):
        self.inner, self.grads = inner, None

    def update(self, grads, state, params, lr=None, ok=None, part=None):
        self.grads = {n: g.clone() for n, g in grads.items() if g is not None}
        return self.inner.update(grads, state, params, lr=lr, ok=ok, part=part)


def main(out_dir):
    world = int(os.environ.get("KMBART_NUM_PROCESSES", "1"))
    if world > 1:
        distributed.init_distributed("cpu")
    rank = distributed.rank()
    dp = world > 1
    cfg = tiny_config()
    batch = make_batch(cfg)
    if dp:
        mine = rows_of(batch, slice(4 * rank, 4 * rank + 4))
    else:
        mine = batch
    # the one process's micro-batch i is rank r's rows [2i, 2i + 2) of both ranks
    interleaved = rows_of(batch, [0, 1, 4, 5, 2, 3, 6, 7])

    def loss_fn(m, b, generator):
        loss, _ = conditional_loss(m, cfg, b, train=True, generator=generator)
        return loss, {}

    out = {}
    # the gradients at fp32 compute: in bf16 the tied embedding's cotangent
    # is rounded per rank (ops/lm_ce.py), before the ranks' sum
    fp32 = cfg.replace(dtype="float32")

    def fp32_loss_fn(m, b, generator):
        loss, _ = conditional_loss(m, fp32, b, train=True, generator=generator)
        return loss, {}

    # grads_accum_contiguous: the one process's micro-batches as the JAX
    # package cuts the global batch (rows [0, 4) and [4, 8))
    runs = (("grads", 1), ("grads_accum", 2)) + ((("grads_accum_contiguous", 2),) if not dp
                                                 else ())
    for name, G in runs:
        model = init_conditional_model(fp32, seed=0, device="cpu")
        opt = _Capture(AdamW(lr=1e-3, groups=jax_leaf_groups(cfg)))
        step = build_train_step(fp32_loss_fn, opt, grad_accum_steps=G, grid=Grid())
        state = TrainState.create(model, opt.inner)
        b = mine if dp or name != "grads_accum" else interleaved
        state, metrics = step(state, b, 0)
        out[name] = opt.grads
        out[name + "_loss"] = metrics["loss"]

    for name, use_zero1 in (("replicated", False), ("zero1", True)):
        model = init_conditional_model(cfg, seed=0, device="cpu")
        opt = AdamW(lr=1e-2, groups=jax_leaf_groups(cfg))
        zero1 = Zero1(cfg, model_tensors(model), world, rank) if use_zero1 and dp else None
        state = TrainState.create(model, opt)
        if zero1 is not None:
            state = state._replace(opt_state=zero1.shard_state(state.opt_state))
        step = build_train_step(loss_fn, opt, zero1=zero1, grid=Grid())
        for i in range(3):
            state, _ = step(state, mine, 0)
        out[name] = {n: t.detach().clone() for n, t in model_tensors(model).items()}
        if use_zero1:
            class Flags:
                sharded_checkpoints = True
            save_train_checkpoint(os.path.join(out_dir, "sharded"), cfg, state, 0, Flags, zero1)
            save_train_checkpoint(os.path.join(out_dir, "npz"), cfg, state, 0, None, zero1)
        if not use_zero1:
            # a non-finite loss on the last rank only: every rank skips the step
            bad = dict(mine)
            if rank == world - 1:
                bad["image_features"] = mine["image_features"] * float("nan")
            before = {n: t.detach().clone() for n, t in model_tensors(model).items()}
            state, metrics = step(state, bad, 0)
            out["skipped"] = float(metrics["skipped"])
            out["unchanged_after_skip"] = all(torch.equal(t, before[n])
                                              for n, t in model_tensors(model).items())
    torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    distributed.shutdown()


if __name__ == "__main__":
    main(sys.argv[1])
