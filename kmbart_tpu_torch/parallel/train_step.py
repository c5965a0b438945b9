"""Train and eval steps.

Counterpart of kmbart_tpu/parallel/train_step.py for one device: no mesh
arguments (DDP is later work). Eager PyTorch has no jit; a step is a
forward, a backward and the AdamW update, queued on the device without a
host sync.

``grad_accum_steps`` G splits dim 0 of the batch into G micro-batches,
each with its own dropout generator, and averages their gradients before
the one update. The non-finite guard drops an update whose loss or any
gradient is not finite and sets ``metrics["skipped"]``. Each step's
dropout generator is seeded from (seed, state.step[, micro-batch]): the
counterpart of ``fold_in(rng, state.step)``, so a resumed run draws what
an uninterrupted one would have.
"""

import torch

from kmbart_tpu_torch.training.state import TrainState, model_tensors

_MASK = (1 << 63) - 1


def step_seed(seed, step, micro=0):
    """A 63-bit generator seed for (seed, step, micro-batch) (splitmix64
    finaliser: neighbouring steps get unrelated streams)."""
    z = (seed * 0x9E3779B97F4A7C15 + step * 0xBF58476D1CE4E5B9 + micro + 1) & ((1 << 64) - 1)
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & ((1 << 64) - 1)
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & ((1 << 64) - 1)
    return (z ^ (z >> 31)) & _MASK


def _split(batch, G):
    return [{k: v.reshape((G, v.shape[0] // G) + tuple(v.shape[1:]))[i] for k, v in batch.items()}
            for i in range(G)]


def build_train_step(loss_fn, optimizer, skip_nonfinite=True, grad_accum_steps=1):
    """loss_fn(model, batch, generator) -> (loss, metrics dict of scalars).

    Returns step(state, batch, seed) -> (state, metrics); metrics stay
    device tensors (read them at the logging cadence)."""
    G = grad_accum_steps

    def step(state: TrainState, batch, seed):
        model = state.params
        tensors = model_tensors(model)
        device = next(iter(tensors.values())).device
        model.zero_grad(set_to_none=True)
        micro = [batch] if G == 1 else _split(batch, G)
        losses, per_micro = [], []
        for i, mb in enumerate(micro):
            gen = torch.Generator(device=device).manual_seed(step_seed(seed, state.step, i))
            loss, metrics = loss_fn(model, mb, gen)
            loss.backward()
            losses.append(loss.detach())
            per_micro.append(metrics)
        grads = {n: None if t.grad is None else (t.grad if G == 1 else t.grad / G)
                 for n, t in tensors.items()}
        loss = losses[0] if G == 1 else sum(losses) / G
        metrics = {k: torch.stack([torch.as_tensor(m[k]).detach() for m in per_micro])
                   .float().mean() for k in per_micro[0]}
        ok = None
        if skip_nonfinite:
            finite = [torch.isfinite(loss).reshape(())]
            finite += [torch.isfinite(g).all() for g in grads.values() if g is not None]
            ok = torch.stack(finite).all()
            metrics["skipped"] = 1.0 - ok.float()
        # the guard is fused into the optimizer's update (adamw.py ``ok``)
        opt_state = optimizer.update(grads, state.opt_state, tensors, ok=ok)
        model.zero_grad(set_to_none=True)
        metrics["loss"] = loss
        return TrainState(params=model, opt_state=opt_state, step=state.step + 1), metrics

    return step


def build_eval_step(loss_fn):
    """loss_fn(model, batch, generator) -> (loss, metrics); returns
    step(model, batch) -> metrics, without gradients or dropout."""

    @torch.no_grad()
    def step(model, batch):
        loss, metrics = loss_fn(model, batch, None)
        metrics = dict(metrics)
        metrics["loss"] = loss
        return metrics

    return step
