"""Train and eval steps.

Counterpart of kmbart_tpu/parallel/train_step.py. Eager PyTorch has no jit;
a step is a forward, a backward and the AdamW update, queued on the device
without a host sync.

``grad_accum_steps`` G splits dim 0 of the batch into G micro-batches,
each with its own dropout generator, and averages their gradients before
the one update. The non-finite guard drops an update whose loss or any
gradient is not finite and sets ``metrics["skipped"]``. Each step's
dropout generator is seeded from (seed, state.step[, micro-batch][, rank]):
the counterpart of ``fold_in(rng, state.step)``, so a resumed run draws what
an uninterrupted one would have.

With a ``grid`` whose data axis has several ranks, the process is one rank of a multi-process job
(parallel/distributed.py) and the step computes what the JAX package's
pjit step computes over the global batch, the ranks' batches side by side:
each masked mean divides by its count over all ranks, the gradients and the
loss terms are summed over the ranks (in a few flat all-reduces), and the
guard then reads the summed values, so every rank skips the same steps.
Under grad accumulation rank r's micro-batch i is its own rows
``[i·B/G, (i+1)·B/G)``, normalised by micro-batch i's count over all ranks;
the JAX package cuts the global batch into G contiguous blocks instead, so
the two group rows differently when G > 1 (ROADMAP.md, known differences).
``zero1`` (parallel/zero1.py) shards the AdamW moments over the ranks.

With a ``grid`` (parallel/mesh.py) the step is one rank of tensor, sequence
and pipeline parallelism (the counterpart of the JAX step under
``param_partition_specs`` / ``stage_param_specs``): the loss function runs
this rank's part of the model (parallel/tp.py, parallel/pp.py), the data
axis takes the place of the ranks above, the gradients that sequence
parallelism leaves in parts are summed over the model axis, the guard reads
every rank, and the per-leaf "used" test of AdamW is ORed over the ranks of
one data coordinate, where a JAX leaf's parts live. Under pipeline
parallelism each accumulation micro-batch splits again into the pipeline's
micro-batches inside the loss, in the JAX order
(kmbart_tpu/cli_common.py:328 ``validate_batch_layout``).
"""

import torch

from kmbart_tpu_torch.parallel import distributed
from kmbart_tpu_torch.training.state import TrainState, model_tensors
from kmbart_tpu_torch.utils.profiling import span

_MASK = (1 << 63) - 1


def step_seed(seed, step, micro=0, rank=0):
    """A 63-bit generator seed for (seed, step, micro-batch, rank)
    (splitmix64 finaliser: neighbouring steps get unrelated streams)."""
    z = (seed * 0x9E3779B97F4A7C15 + step * 0xBF58476D1CE4E5B9 + micro + 1
         + rank * 0xD1B54A32D192ED03) & ((1 << 64) - 1)
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & ((1 << 64) - 1)
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & ((1 << 64) - 1)
    return (z ^ (z >> 31)) & _MASK


def _split(batch, G):
    return [{k: v.reshape((G, v.shape[0] // G) + tuple(v.shape[1:]))[i] for k, v in batch.items()}
            for i in range(G)]


def _sum_over_ranks(loss, metrics, axis=None):
    """The loss and each metric summed over the ranks of ``axis`` (default:
    every rank; one all-reduce)."""
    keys = list(metrics)
    stats = torch.stack([torch.as_tensor(loss).float().reshape(())] +
                        [torch.as_tensor(metrics[k]).float().reshape(()) for k in keys])
    distributed.all_reduce_sum([stats], axis=axis)
    return stats[0], dict(zip(keys, stats[1:]))


def _data_axis(grid):
    return grid.data if grid is not None and grid.data.size > 1 else None


def build_train_step(loss_fn, optimizer, skip_nonfinite=True, grad_accum_steps=1,
                     zero1=None, grid=None):
    """loss_fn(model, batch, generator) -> (loss, metrics dict of scalars);
    over several data ranks the metrics are parts of the loss (each rank's
    share of a global mean), summed over the ranks like it.

    ``grid`` (parallel/mesh.py) makes the step a rank of data parallelism
    over its data axis and of tensor, sequence and pipeline parallelism over
    the others: the counts, the gradients and the loss are summed over the
    data axis, the
    gradients that sequence parallelism leaves in parts over the model
    axis, the non-finite guard reads every rank, and AdamW's "used" test is
    ORed over the ranks of a data coordinate. Each step's dropout generator
    is seeded from the data coordinate, so the ranks of one model axis draw
    the same masks on the replicated stream.

    Returns step(state, batch, seed) -> (state, metrics); metrics stay
    device tensors (read them at the logging cadence)."""
    G = grad_accum_steps
    data = _data_axis(grid)
    tp = None if grid is None else grid.tp
    split = grid is not None and grid.parallel

    def any_over(flags):
        votes = flags.to(torch.float32)
        distributed.all_reduce_axis(votes, grid.feed)
        return votes > 0

    def step(state: TrainState, batch, seed):
        with span("train.step", id=state.step):
            return _step(state, batch, seed)

    def _step(state, batch, seed):
        model = state.params
        tensors = model_tensors(model)
        device = next(iter(tensors.values())).device
        rank = 0 if data is None else data.index
        model.zero_grad(set_to_none=True)
        if tp is not None:
            tp.partial.clear()
        micro = [batch] if G == 1 else _split(batch, G)
        losses, per_micro = [], []
        with distributed.global_counts(data):
            for i, mb in enumerate(micro):
                gen = torch.Generator(device=device).manual_seed(
                    step_seed(seed, state.step, i, rank))
                with span("train.forward"):
                    loss, metrics = loss_fn(model, mb, gen)
                with span("train.backward"):
                    loss.backward()
                losses.append(loss.detach())
                per_micro.append(metrics)
        grads = {n: None if t.grad is None else (t.grad if G == 1 else t.grad / G)
                 for n, t in tensors.items()}
        loss = losses[0] if G == 1 else sum(losses) / G
        metrics = {k: torch.stack([torch.as_tensor(m[k]).detach() for m in per_micro])
                   .float().mean() for k in per_micro[0]}
        if data is not None:
            grads = {n: torch.zeros_like(t, dtype=torch.float32) if g is None else g
                     for (n, t), g in zip(tensors.items(), grads.values())}
            distributed.all_reduce_sum(list(grads.values()), axis=data)
            loss, metrics = _sum_over_ranks(loss, metrics, data)
        if tp is not None and tp.partial:
            ids = {id(t): n for n, t in tensors.items()}
            distributed.all_reduce_sum([grads[ids[i]] for i in tp.partial
                                        if grads.get(ids[i]) is not None], axis=tp.axis)
        ok = None
        if skip_nonfinite:
            with span("train.guard"):
                finite = [torch.isfinite(loss).reshape(())]
                finite += [torch.isfinite(g).all() for g in grads.values() if g is not None]
                ok = torch.stack(finite).all()
                if split:
                    bad = (~ok).to(torch.float32).reshape(1)
                    distributed.all_reduce_axis(bad, grid.world)
                    ok = bad[0] == 0
                metrics["skipped"] = 1.0 - ok.float()
        # the guard is fused into the optimizer's update (adamw.py ``ok``)
        extra = {"any_over": any_over} if split and grid.feed.size > 1 else {}
        with span("train.optimizer"):
            if zero1 is not None:
                opt_state = zero1.update(optimizer, grads, state.opt_state, tensors, ok=ok,
                                         **extra)
            else:
                opt_state = optimizer.update(grads, state.opt_state, tensors, ok=ok, **extra)
        model.zero_grad(set_to_none=True)
        metrics["loss"] = loss
        return TrainState(params=model, opt_state=opt_state, step=state.step + 1), metrics

    return step


def build_eval_step(loss_fn, grid=None):
    """loss_fn(model, batch, generator) -> (loss, metrics); returns
    step(model, batch) -> metrics, without gradients or dropout. Over a
    ``grid``'s data axis the loss and metrics are the global batch's, on
    every rank."""
    data = _data_axis(grid)

    @torch.no_grad()
    def step(model, batch):
        with distributed.global_counts(data):
            loss, metrics = loss_fn(model, batch, None)
        metrics = dict(metrics)
        if data is not None:
            loss, metrics = _sum_over_ranks(loss, metrics, data)
        metrics["loss"] = loss
        return metrics

    return step
