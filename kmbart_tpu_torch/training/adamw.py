"""AdamW as the JAX package writes it (kmbart_tpu/training/adamw.py), not
``torch.optim.AdamW``.

The parity target is the ``transformers.AdamW`` the reference trains with:
betas (0.9, 0.999), eps 1e-6 added to sqrt(v) (not to sqrt(v̂)), bias
correction on the step size, decoupled weight decay with the uncorrected
lr, an ``ok`` flag that turns the whole update into a no-op (the
non-finite guard), and with ``skip_unused`` no update at all for a leaf
whose gradient is exactly zero, with its own step count.

A JAX leaf is one array, and a stacked one holds a weight of every layer
(``encoder/layers/fc1_kernel``); the port holds one tensor per layer. So
the optimizer works on *groups*: {JAX leaf key: [port tensor names]}. The
"used" test and the step count are kept per group, so the two states hold
the same numbers and convert both ways (checkpoint/io.py). Moments are
kept per port tensor, in fp32.

Everything runs on the tensors' device with no host sync: ``ok`` and the
per-group "used" flags stay device booleans. Parameters are updated in
place (JAX returns new arrays).

Two versions of one update. On CUDA tensors ``update`` launches K12
(ops/adamw.py, csrc/adamw.cu): a few launches a step over every tensor,
with the same arithmetic in the same order. There the moments are updated
in place, and the returned state's ``step`` and ``leaf_steps`` are views
of one int32 vector that each later update advances in place: a state
handed to ``update`` on the card is spent, and a caller that wants one
kept copies it first. The optimizer caches K12's launch tables for the
tensors and moments it saw last (rebuilt when another state, model or
``part`` comes). On other devices ``update_plain`` runs, the per-tensor
version (new moments each step), which K12 is held to.
"""

from typing import NamedTuple, Optional

import numpy as np
import torch


class AdamWState(NamedTuple):
    step: torch.Tensor              # int32 scalar: updates taken (for logging)
    mu: dict                        # port tensor name -> first moment (fp32)
    nu: dict                        # port tensor name -> second moment (fp32)
    leaf_steps: Optional[dict]      # group key -> int32 scalar (HF per-param t)


class AdamW:
    """``opt = AdamW(lr, groups=...); state = opt.init(params);
    state = opt.update(grads, state, params)``. ``params`` and ``grads``
    are {name: tensor} (a gradient may be None: a zero gradient); ``groups``
    defaults to one group per name."""

    def __init__(self, lr, b1=0.9, b2=0.999, eps=1e-6, weight_decay=0.0,
                 correct_bias=True, skip_unused=True, groups=None):
        self.lr, self.b1, self.b2 = lr, b1, b2
        self.eps, self.weight_decay = eps, weight_decay
        self.correct_bias = correct_bias
        self.skip_unused = skip_unused
        self.groups = groups
        self._kernel = None

    def groups_for(self, params):
        """The groups over the tensors of ``params``: a rank of a split model
        holds some members of a group (its stage's layers), or a part of
        each."""
        if self.groups is None:
            return {n: [n] for n in params}
        groups = {k: [n for n in names if n in params] for k, names in self.groups.items()}
        return {k: names for k, names in groups.items() if names}

    def init(self, params):
        dev = next(iter(params.values())).device
        zero = lambda: torch.zeros((), dtype=torch.int32, device=dev)
        return AdamWState(
            step=zero(),
            mu={n: torch.zeros_like(p, dtype=torch.float32) for n, p in params.items()},
            nu={n: torch.zeros_like(p, dtype=torch.float32) for n, p in params.items()},
            leaf_steps={k: zero() for k in self.groups_for(params)})

    @torch.no_grad()
    def update(self, grads, state, params, lr=None, ok=None, part=None, any_over=None):
        """Update ``params`` in place; return the new state: K12 on CUDA
        tensors, ``update_plain`` on others (the module docstring)."""
        if next(iter(params.values())).device.type == "cuda":
            return self._update_kernel(grads, state, params, lr, ok, part, any_over)
        return self.update_plain(grads, state, params, lr, ok, part, any_over)

    @torch.no_grad()
    def update_plain(self, grads, state, params, lr=None, ok=None, part=None, any_over=None):
        """Update ``params`` in place; return the new state. ``part(name,
        tensor)``, when given, is the part of a tensor this process updates
        (ZeRO-1, parallel/zero1.py; None: a tensor another rank owns), and
        the state's moments hold those parts; the "used" test still reads
        the whole gradients, so every rank decides it alike. ``any_over``,
        when given, ORs the groups' "used" flags (a bool vector) over the
        ranks that hold other parts of the same groups (tensor and pipeline
        parallelism: a JAX leaf is split over them, and a rank whose part
        got no gradient must still step)."""
        lr = self.lr if lr is None else lr
        b1, b2, eps = self.b1, self.b2, self.eps
        step = state.step + (1 if ok is None else ok.to(torch.int32))
        per_leaf = self.skip_unused and state.leaf_steps is not None
        mu, nu = dict(state.mu), dict(state.nu)
        leaf_steps = None if state.leaf_steps is None else dict(state.leaf_steps)
        groups = self.groups_for(params)
        grads_of = {key: [torch.zeros_like(params[n], dtype=torch.float32) if grads.get(n) is None
                          else grads[n].float() for n in names] for key, names in groups.items()}
        if per_leaf:
            flags = torch.stack([torch.stack([(g != 0).any() for g in gs]).any()
                                 for gs in grads_of.values()])
            if any_over is not None:
                flags = any_over(flags)
            used_of = dict(zip(groups, flags))
        for key, names in groups.items():
            gs = grads_of[key]
            if per_leaf:
                used = used_of[key]
                if ok is not None:
                    used = used & ok
                leaf_steps[key] = state.leaf_steps[key] + used.to(torch.int32)
                t = leaf_steps[key].float()
            else:
                used = ok
                t = step.float()
            if self.correct_bias:
                # t == 0 only where the update is discarded below
                t = t.clamp(min=1.0)
                step_size = lr * torch.sqrt(1.0 - b2 ** t) / (1.0 - b1 ** t)
            else:
                step_size = lr
            for name, g in zip(names, gs):
                p = params[name]
                if part is not None:
                    p = part(name, p)
                    if p is None:
                        continue
                    g = part(name, g)
                m, v = state.mu[name], state.nu[name]
                new_m = b1 * m + (1.0 - b1) * g
                new_v = b2 * v + (1.0 - b2) * torch.square(g)
                new_p = p - step_size * new_m / (torch.sqrt(new_v) + eps)
                if self.weight_decay > 0.0:
                    new_p = new_p - lr * self.weight_decay * p
                if used is not None:
                    new_p = torch.where(used, new_p, p)
                    new_m = torch.where(used, new_m, m)
                    new_v = torch.where(used, new_v, v)
                p.copy_(new_p)
                mu[name], nu[name] = new_m, new_v
        return AdamWState(step=step, mu=mu, nu=nu, leaf_steps=leaf_steps)

    def _update_kernel(self, grads, state, params, lr, ok, part, any_over):
        lr = self.lr if lr is None else lr
        per_leaf = self.skip_unused and state.leaf_steps is not None
        run = self._kernel
        if run is None or not run.serves(state, params, part, per_leaf):
            run = self._kernel = _KernelRun(self, grads, state, params, part, per_leaf)
        return run.step(grads, state, ok, any_over, lr)


class _KernelRun:
    """K12's plan for one state, model and ``part`` (ops/adamw.py
    ``Plan``), and the state it hands back."""

    def __init__(self, opt, grads, state, params, part, per_leaf):
        from kmbart_tpu_torch.ops import _cuda
        from kmbart_tpu_torch.ops.adamw import Plan, rows_of

        self.opt, self.part, self.per_leaf = opt, part, per_leaf
        self.mu, self.nu = state.mu, state.nu
        self.tensors = list(params.items())
        self.groups = opt.groups_for(params)
        dev = _cuda.require_cuda("AdamW", *params.values(), *state.mu.values(),
                                 *state.nu.values(), contiguous=False)
        used, update, self.names, self.update_index = [], [], [], []
        for grp, names in enumerate(self.groups.values()):
            for name in names:
                p, g = params[name], grads.get(name)
                q = p if part is None else part(name, p)
                moments = () if q is None else (state.mu[name], state.nu[name])
                if any(t is not None and t.dtype != torch.float32 for t in (p, g, *moments)):
                    raise TypeError(f"AdamW kernel takes fp32 tensors and moments ({name})")
                if g is not None and any(a != b for a, b, n in zip(g.stride(), p.stride(), p.shape)
                                         if n != 1):
                    raise ValueError(f"AdamW kernel: {name}'s gradient is laid out unlike it")
                rows, cols, (stride,) = rows_of(p)
                used.append((rows, cols, stride, grp))
                if q is not None:
                    update.append((q, *moments, grp, q.data_ptr() - p.data_ptr()))
                    self.update_index.append(len(self.names))
                self.names.append(name)
        self.update_index = np.array(self.update_index, np.intp)
        self.plan = Plan(used, update, len(self.groups), dev)
        self.step_view = self.plan.steps[0]
        self.leaf_views = None

    def serves(self, state, params, part, per_leaf):
        """Whether this plan's tables still describe the call's tensors."""
        return (state.mu is self.mu and state.nu is self.nu and part == self.part
                and per_leaf == self.per_leaf and len(params) == len(self.tensors)
                and all(params.get(n) is t for n, t in self.tensors))

    def step(self, grads, state, ok, any_over, lr):
        opt, plan = self.opt, self.plan
        if state.step is not self.step_view:
            self.step_view.copy_(state.step)
        if self.per_leaf and state.leaf_steps is not self.leaf_views:
            plan.steps[1:].copy_(torch.stack([state.leaf_steps[k] for k in self.groups]))
            self.leaf_views = {**state.leaf_steps,
                               **{k: plan.steps[1 + i] for i, k in enumerate(self.groups)}}
        addresses = np.fromiter((0 if g is None else g.data_ptr()
                                 for g in map(grads.get, self.names)),
                                np.uint64, len(self.names))
        plan.launch(addresses, self.update_index, ok, any_over, self.per_leaf,
                    opt.correct_bias, lr, opt.b1, opt.b2, opt.eps, opt.weight_decay)
        return AdamWState(step=self.step_view, mu=state.mu, nu=state.nu,
                          leaf_steps=self.leaf_views if self.per_leaf else state.leaf_steps)
