"""Training steps back to back: ``parallel/train_step.py build_train_step``
with ``training/adamw.py``, fed by ``training/trainer.py
prefetch_to_device``, as ``vcg_train`` and ``pretrain`` run them.

Set-up builds one train state (the model with the benchmark's weights and
the optimizer's state) and one feed, and drives them through the first
``check_steps`` steps with the window's own call. Those steps are the
warm-up and the run's check: the loss of each step, each leaf's first
gradient as the optimizer got it (its first moment after one step over
1 - beta1) and each leaf's change after the last of them, read before
the window's steps move the weights on. After the window the reference
follows the same steps from the same weights, batches and dropout masks,
in float32.

The numbers compared (``numbers``): the widest relative gap of a step's
loss, and, by the worst leaf, the gap between the system's and the
reference's norm of the first gradient and of the change, over the
reference's norm of that leaf or of the median leaf, whichever is larger.
Norm gaps are second order in errors that do not lean one way, so a
fourth number, ``grad_err``, takes the norm of the first gradient's
difference by the same rule: it is the one that separates a step computed
one precision lower. Leaves whose reference gradient is under a
thousandth of the median leaf's are left out (they move by round-off
alone).
"""

import itertools
import threading
import time

import torch

from gpubench.harness import feed
from gpubench.reference import bart as ref

BETA1 = 0.9


class _Pool:
    """An endless loader over the pool that stops when told."""

    def __init__(self, pool):
        self.pool, self.stop = pool, threading.Event()

    def __iter__(self):
        for b in itertools.cycle(self.pool):
            if self.stop.is_set():
                return
            yield b


class Loop:
    kind = "train"

    def __init__(self, ctx):
        from kmbart_tpu_torch.checkpoint.io import jax_leaf_groups
        from kmbart_tpu_torch.parallel.train_step import build_train_step
        from kmbart_tpu_torch.training.adamw import AdamW
        from kmbart_tpu_torch.training.state import TrainState
        from kmbart_tpu_torch.training.trainer import prefetch_to_device

        self.ctx, self.cfg, self.mix = ctx, ctx.cfg, ctx.mix
        self.pretraining = bool(self.mix.get("relation_pairs"))
        cfg_obj = ctx.cfg_obj
        if self.pretraining:
            from kmbart_tpu_torch.models.pretraining import (MultiModalBartForPreTraining,
                                                             pretraining_loss)

            def loss_fn(m, b, generator):
                loss, aux = pretraining_loss(m, cfg_obj, b, train=True, generator=generator)
                return loss, {k: v for k, v in aux["losses"].items() if k != "loss"}
            cls = MultiModalBartForPreTraining
        else:
            from kmbart_tpu_torch.models.conditional import (
                MultiModalBartForConditionalGeneration, conditional_loss)

            def loss_fn(m, b, generator):
                return conditional_loss(m, cfg_obj, b, train=True, generator=generator)[0], {}
            cls = MultiModalBartForConditionalGeneration
        with torch.device(ctx.device):
            model = cls(cfg_obj)
        flat0 = ctx.load_weights(model, heads=self.pretraining)
        model.train()
        optimizer = AdamW(lr=self.mix["lr"], groups=jax_leaf_groups(cfg_obj,
                                                                     heads=self.pretraining))
        self.step_fn = build_train_step(loss_fn, optimizer)
        self.state = TrainState.create(model, optimizer)
        self.pool = [feed.make_batch(self.mix, self.cfg, ctx.seed, i)
                     for i in range(self.mix["pool"])]
        self.loader = _Pool(self.pool)
        self.feed = prefetch_to_device(self.loader, ctx.device, depth=4)
        self.feed_wait_s = 0.0
        self.skipped = []
        self.setup_readings(flat0)

    def call(self):
        t = time.perf_counter()
        batch = next(self.feed)
        self.feed_wait_s += time.perf_counter() - t
        self.state, metrics = self.step_fn(self.state, batch, self.ctx.step_seed)
        self.skipped.append(metrics.get("skipped"))
        self.losses.append(metrics["loss"])
        return self.mix["batch"]

    def sync(self):
        if self.ctx.device.type == "cuda":
            torch.cuda.synchronize()

    def setup_readings(self, flat0):
        """The first steps, with the readings the check compares."""
        self.losses = []
        names = list(self._leaves())
        n = self.mix["check_steps"]
        for i in range(n):
            self.call()
            if i == 0:
                mu = self.state.opt_state.mu
                with torch.no_grad():
                    self.grad_norms = torch.stack([mu[k].norm() / (1 - BETA1)
                                                   for k in names]).cpu()
                    # kept on the host until the reference has run
                    self.grads = {k: (mu[k] / (1 - BETA1)).cpu() for k in names}
        offs = self.ctx.weight_offsets
        with torch.no_grad():
            self.change_norms = torch.stack([
                (t - flat0[offs[k][0]:offs[k][1]].view(t.shape)).norm()
                for k, t in self._leaves().items()]).cpu()
        self.leaf_names = names
        self.step_losses = [float(x) for x in self.losses[:n]]
        self.losses.clear()
        self.skipped.clear()
        self.feed_wait_s = 0.0

    def _leaves(self):
        return {k: p for k, p in self.state.params.named_parameters()}

    def failed(self):
        return int(sum(float(s) for s in self.skipped if s is not None))

    def free(self):
        self.loader.stop.set()
        for _ in self.feed:     # drain, so the feed's thread sees the stop and ends
            pass
        del self.state, self.step_fn, self.feed

    # ------------------------------------------------------------ the check

    def reference_readings(self, precision="fp32", rows=None):
        """The reference's step losses, first-gradient norms and change
        norms over the same steps; ``rows``: a slice of each batch (the
        half-batch fault)."""
        ctx, cfg = self.ctx, self.cfg
        dev = ctx.device
        flat0, P = ref.make_params(cfg, ctx.seed, dev, heads=self.pretraining)
        flat0 = flat0.clone()
        for p in P.values():
            p.requires_grad_(True)
        prec = ref.Precision(precision)
        adam = ref.AdamW(self.mix["lr"])
        terms = ref.pretraining_terms if self.pretraining else ref.conditional_terms
        losses, grad_norms = [], None
        for i in range(self.mix["check_steps"]):
            b = {k: torch.as_tensor(v, device=dev) for k, v in self.pool[i].items()}
            b = {k: (v.long() if not v.is_floating_point() and v.dtype != torch.bool else v)
                 for k, v in b.items()}
            B = b["input_ids"].shape[0]
            g = torch.Generator(device=dev).manual_seed(ref.step_seed(ctx.step_seed, i))
            masks = ref.Dropout.draw(cfg["dropout"], g, ref.dropout_sites(
                cfg, B, b["input_ids"].shape[1], b["decoder_input_ids"].shape[1]), dev)
            if rows is not None:
                b = {k: v[rows] for k, v in b.items()}
                masks = [m[rows] for m in masks]
            loss, grads = ref.loss_and_grads(prec, P, cfg, b, terms, masks, cfg["dropout"],
                                             self.mix["ref_block"])
            losses.append(loss)
            if i == 0:
                grad_norms = torch.stack([grads[k].norm() for k in self.leaf_names]).cpu()
                first = {k: grads[k].detach().cpu() for k in self.leaf_names}
            adam.step(P, grads)
            del masks, grads
        offs = ctx.weight_offsets
        with torch.no_grad():
            change = torch.stack([(P[k] - flat0[offs[k][0]:offs[k][1]].view(P[k].shape)).norm()
                                  for k in self.leaf_names]).cpu()
        return {"losses": losses, "grad_norms": grad_norms, "change_norms": change,
                "grads": first}

    def program_readings(self):
        return {"losses": self.step_losses, "grad_norms": self.grad_norms,
                "change_norms": self.change_norms, "grads": self.grads}

    def numbers(self):
        want = self.reference_readings()
        g = want["grad_norms"]
        self.left_out = [k for k, n in zip(self.leaf_names, g) if n < 1e-3 * g.median()]
        return compare(self.program_readings(), want)

    def describe(self):
        out = getattr(self, "left_out", None)
        return None if out is None else f"leaves left out of the check: {len(out)} {out}"


def leaf_gap(got, want, keep):
    """max over kept leaves of |got - want| / max(want, median(want))."""
    med = want[keep].median()
    scale = torch.maximum(want, med)
    return float(((got - want).abs() / scale)[keep].max())


def compare(got, want):
    """The three numbers of the training check (module docstring)."""
    g_ref = want["grad_norms"]
    keep = g_ref >= 1e-3 * g_ref.median()
    loss_gap = max(abs(a - b) / abs(b) for a, b in zip(got["losses"], want["losses"]))
    names = list(want["grads"])
    diff = torch.stack([(got["grads"][k].float() - want["grads"][k]).norm() for k in names])
    med = g_ref[keep].median()
    return {"loss_gap": loss_gap,
            "grad_gap": leaf_gap(got["grad_norms"], g_ref, keep),
            "change_gap": leaf_gap(got["change_norms"], want["change_norms"], keep),
            "grad_err": float((diff / torch.maximum(g_ref, med))[keep].max())}
