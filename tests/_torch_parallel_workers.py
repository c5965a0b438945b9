"""Worker of tests/test_torch_{tp,sp,pp}.py: one rank of the PyTorch port's
tensor, sequence and pipeline parallelism on the CPU (gloo).
``python -m tests._torch_parallel_workers <out_dir> <case>...``; the
rendezvous comes from KMBART_COORDINATOR_ADDRESS, KMBART_NUM_PROCESSES and
KMBART_PROCESS_ID (``spawn`` sets them).

Every case loads the parameters of ``<out_dir>/params.npz`` (JAX layout,
written by the test) into the tiny model at fp32, cuts them to the rank's
part of a process grid, and takes one train step on a batch made by
``make_batch``; rank 0 writes ``<out_dir>/<case>.pt``: the loss and the
whole gradients the optimizer received (gathered from every rank's parts).
The cases (``CASES``) at 2 ranks: TP 2, TP 2 with SP (and at lengths SP
skips), PP 2 at 1, 2 and 4 micro-batches, with remat, the pretraining loss
under PP 2, and AdamW's "used" flag over a rank whose part got no gradient
("used"); at 4 ranks: PP 2 x TP 2, DP 2 x TP 2 and PP 2 with the stage axis
spanning process blocks under DP 2.
"""

import os
import sys

import numpy as np
import torch

from kmbart_tpu_torch.checkpoint.io import (_flatten, jax_leaf_groups, load_state_dict,
                                            params_from_jax)
from kmbart_tpu_torch.cli_common import whole_tensors
from kmbart_tpu_torch.config import tiny_config
from kmbart_tpu_torch.models.conditional import conditional_loss, init_conditional_model
from kmbart_tpu_torch.models.pretraining import init_pretraining_model, pretraining_loss
from kmbart_tpu_torch.parallel import distributed, pp
from kmbart_tpu_torch.parallel.mesh import Grid
from kmbart_tpu_torch.parallel.tp import shard_model_
from kmbart_tpu_torch.parallel.train_step import build_train_step
from kmbart_tpu_torch.training.adamw import AdamW
from kmbart_tpu_torch.training.state import TrainState, model_tensors

ROWS = 8


def config():
    return tiny_config(dtype="float32")


def make_batch(cfg, S=12, T=6, seed=0, pretrain=False):
    """8 rows of numpy arrays (int32 ids, fp32 features) made from ``seed``:
    the inputs of both packages."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(4, 80, (ROWS, S)).astype(np.int32)
    ids[:, 1:3] = cfg.img_feat_id
    labels = rng.integers(4, 80, (ROWS, T)).astype(np.int32)
    labels[4:, T - 2:] = -100
    batch = dict(input_ids=ids, attention_mask=np.ones((ROWS, S), np.int32),
                 image_features=rng.normal(size=(ROWS, cfg.max_img_num, cfg.image_feature_size))
                 .astype(np.float32),
                 decoder_input_ids=rng.integers(4, 80, (ROWS, T)).astype(np.int32),
                 decoder_attention_mask=np.ones((ROWS, T), np.int32), labels=labels)
    if pretrain:
        batch.update(
            mrm_soft_labels=rng.dirichlet(np.ones(cfg.num_labels), (ROWS, T)).astype(np.float32),
            mrm_mask=rng.random((ROWS, T)) < 0.3,
            attribute_labels=rng.integers(0, cfg.num_attributes, (ROWS, T)).astype(np.int32),
            attribute_mask=(rng.random((ROWS, T)) < 0.3).astype(np.float32),
            relation_pairs=rng.integers(0, T, (ROWS, 4, 2)).astype(np.int32),
            relation_labels=rng.integers(0, cfg.num_relations, (ROWS, 4)).astype(np.int32),
            relation_mask=np.ones((ROWS, 4), bool))
    return batch


def to_torch(batch):
    out = {}
    for k, v in batch.items():
        t = torch.from_numpy(np.ascontiguousarray(v))
        out[k] = t if t.is_floating_point() or t.dtype == torch.bool else t.long()
    return out


class _Capture:
    """AdamW that keeps the gradients it was given."""

    def __init__(self, inner):
        self.inner, self.grads = inner, None

    def update(self, grads, state, params, **kw):
        self.grads = {n: g.clone() for n, g in grads.items() if g is not None}
        return self.inner.update(grads, state, params, **kw)


def run_case(out_dir, name, grid, cfg, *, pretrain=False, n_micro=None, S=12, T=6):
    """One train step of ``name`` on this rank (see the module docstring)."""
    init = init_pretraining_model if pretrain else init_conditional_model
    model = init(cfg, seed=1, device="cpu")
    with np.load(os.path.join(out_dir, "pretrain.npz" if pretrain else "params.npz")) as f:
        load_state_dict(model, params_from_jax(dict(f), cfg))
    if grid.parallel:
        shard_model_(model, cfg, grid)
    batch = to_torch(make_batch(cfg, S, T, pretrain=pretrain))
    rows = ROWS // grid.data.size
    batch = {k: v[grid.data.index * rows:(grid.data.index + 1) * rows] for k, v in batch.items()}

    def loss_fn(m, b, generator):
        if n_micro is not None:
            fn = pp.pipelined_pretraining_loss if pretrain else pp.pipelined_conditional_loss
            loss, _ = fn(m, cfg, b, grid, n_micro=n_micro, train=True, generator=generator)
        else:
            fn = pretraining_loss if pretrain else conditional_loss
            loss, _ = fn(m, cfg, b, train=True, generator=generator, tp=grid.tp)
        return loss, {}

    opt = _Capture(AdamW(lr=1e-3, groups=jax_leaf_groups(cfg, heads=pretrain)))
    step = build_train_step(loss_fn, opt, grid=grid)
    state = TrainState.create(model, opt.inner)
    _, metrics = step(state, batch, 0)
    grads = whole_tensors(opt.grads, cfg, grid)
    if distributed.rank() == 0:
        torch.save({"loss": float(metrics["loss"]), "grads": grads,
                    "local_names": sorted(model_tensors(model)),
                    "partial": len(grid.tp.partial) if grid.tp is not None else 0},
                   os.path.join(out_dir, f"{name}.pt"))


def used_flag_case(out_dir):
    """A leaf split over two ranks whose part on rank 0 got no gradient:
    with the OR over the ranks both parts step, without it rank 0's does
    not."""
    grid = Grid(model_parallel=2)
    p = {"w": torch.ones(3)}
    g = {"w": torch.zeros(3) if grid.model.index == 0 else torch.ones(3)}
    opt = AdamW(lr=1e-1, groups={"leaf": ["w"]})

    def any_over(flags):
        votes = flags.float()
        distributed.all_reduce_axis(votes, grid.feed)
        return votes > 0

    steps = {}
    for label, reduce in (("or", any_over), ("local", None)):
        state = opt.update(g, opt.init(p), p, any_over=reduce)
        steps[label] = int(state.leaf_steps["leaf"])
    out = [None] * 2
    torch.distributed.all_gather_object(out, steps)
    if distributed.rank() == 0:
        torch.save(out, os.path.join(out_dir, "used.pt"))


# case -> (grid options, run_case options)
CASES = {
    "tp": (dict(model_parallel=2), {}),
    "sp": (dict(model_parallel=2, sequence_parallel=True), {}),
    "sp_odd": (dict(model_parallel=2, sequence_parallel=True), dict(S=13, T=7)),
    "pp_m1": (dict(stages=2), dict(n_micro=1)),
    "pp_m2": (dict(stages=2), dict(n_micro=2)),
    "pp_m4": (dict(stages=2), dict(n_micro=4)),
    "pp_remat": (dict(stages=2), dict(n_micro=2, remat=True)),
    "pp_pretrain": (dict(stages=2), dict(n_micro=4, pretrain=True)),
    "pp_tp": (dict(model_parallel=2, stages=2), dict(n_micro=2)),
    "dp_tp": (dict(model_parallel=2), {}),
    "dp_pp_span": (dict(stages=2, span_processes=True), dict(n_micro=2)),
}


def main(out_dir, *cases):
    torch.set_num_threads(2)
    distributed.init_distributed("cpu")
    cfg = config()
    for case in cases:
        if case == "used":
            used_flag_case(out_dir)
            continue
        grid_kw, kw = CASES[case]
        grid = Grid(**grid_kw)
        if grid_kw.get("span_processes"):
            torch.save(grid.ranks.tolist(), os.path.join(out_dir, f"span_rank{distributed.rank()}.pt"))
        remat = kw.pop("remat", False)
        run_case(out_dir, case, grid, cfg.replace(remat=remat), **kw)
    distributed.shutdown()


def spawn(out_dir, world, *cases, timeout=300):
    """Run ``cases`` in ``world`` gloo ranks of this module; raises with the
    output of a rank that failed."""
    import socket
    import subprocess
    sock = socket.socket()
    sock.bind(("127.0.0.1", 0))
    port = sock.getsockname()[1]
    sock.close()
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    procs = []
    for r in range(world):
        env = dict(os.environ, OMP_NUM_THREADS="2", KMBART_COORDINATOR_ADDRESS=f"127.0.0.1:{port}",
                   KMBART_NUM_PROCESSES=str(world), KMBART_PROCESS_ID=str(r))
        procs.append(subprocess.Popen([sys.executable, "-m", "tests._torch_parallel_workers",
                                       str(out_dir), *cases], cwd=repo, env=env, text=True,
                                      stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, p in enumerate(procs):
        assert p.returncode == 0, f"rank {r} exited {p.returncode}:\n{outs[r][-4000:]}"


def write_params(out_dir):
    """The JAX package's parameters of both tiny models (PRNGKey 0 and 1)
    as ``params.npz`` and ``pretrain.npz``; returns (cfg, params,
    pretraining params) of the JAX package. Imports JAX: for the tests."""
    import jax
    from kmbart_tpu.config import tiny_config as jax_tiny_config
    from kmbart_tpu.models.conditional import init_conditional_params
    from kmbart_tpu.models.pretraining import init_pretraining_params
    jcfg = jax_tiny_config(dtype="float32")
    params = init_conditional_params(jax.random.PRNGKey(0), jcfg)
    pre = init_pretraining_params(jax.random.PRNGKey(1), jcfg)
    for name, tree in (("params", params), ("pretrain", pre)):
        np.savez(os.path.join(out_dir, f"{name}.npz"), **_flatten(jax.tree.map(np.asarray, tree)))
    return jcfg, params, pre


if __name__ == "__main__":
    main(sys.argv[1], *sys.argv[2:])
