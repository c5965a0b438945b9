"""Spans recorded from the benchmark's side, around the system's calls.

A target is "module:attribute.path", the name a caller looks up at call
time (``kmbart_tpu_torch.models.bart:ffn`` is the FFN as the trunk calls
it). ``Spans`` swaps each target for a wrapper and puts the originals back
on ``close``.

Device spans wrap a call in a ``record_function`` range named
``span:<op>``, so the profiler ties each kernel launched inside it to the
op. Where the call is differentiated, two identity autograd nodes open the
same range again when the gradient reaches the op's output and close it
when the gradient leaves for the op's activations, so the op's backward
kernels count too. Each call's arguments go to the op's work count
(``work/<op>.py capture``), read after the trace.

Host spans add the host clock's seconds inside each call, and count the
calls.
"""

import importlib
import time

import torch


def resolve(target):
    mod_name, _, path = target.partition(":")
    owner = importlib.import_module(mod_name)
    parts = path.split(".")
    for p in parts[:-1]:
        owner = getattr(owner, p)
    return owner, parts[-1]


class _Range:
    def __init__(self, name):
        self.name, self.rf = name, None

    def open(self):
        self.rf = torch.autograd.profiler.record_function(self.name)
        self.rf.__enter__()

    def close(self):
        if self.rf is not None:
            self.rf.__exit__(None, None, None)
            self.rf = None


class _OpenOnGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, rng):
        ctx.rng = rng
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        ctx.rng.open()
        return g, None


class _CloseOnGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, rng):
        ctx.rng = rng
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        ctx.rng.close()
        return g, None


def _grad_activation(args):
    """Index of the first tensor argument that carries a gradient and is
    not a leaf (the op's activations; the weights are leaves)."""
    for i, a in enumerate(args):
        if isinstance(a, torch.Tensor) and a.requires_grad and a.grad_fn is not None:
            return i
    return None


class Spans:
    def __init__(self):
        self._saved = []
        self.host = {}      # name -> [seconds, calls]
        self.calls = {}     # op -> [captured call]

    def _swap(self, target, make):
        owner, attr = resolve(target)
        orig = getattr(owner, attr)
        self._saved.append((owner, attr, orig))
        setattr(owner, attr, make(orig))

    def add_host(self, name, target):
        acc = self.host.setdefault(name, [0.0, 0])

        def make(orig):
            def wrapped(*args, **kwargs):
                t = time.perf_counter()
                try:
                    return orig(*args, **kwargs)
                finally:
                    acc[0] += time.perf_counter() - t
                    acc[1] += 1
            return wrapped
        self._swap(target, make)

    def add_device(self, op, target, capture):
        calls = self.calls.setdefault(op, [])
        name = "span:" + op

        def make(orig):
            def wrapped(*args, **kwargs):
                grad = torch.is_grad_enabled() and _grad_activation(args) is not None
                calls.append(capture(args, kwargs, grad))
                rng = _Range(name) if grad else None
                if grad:
                    i = _grad_activation(args)
                    args = list(args)
                    args[i] = _CloseOnGrad.apply(args[i], rng)
                with torch.autograd.profiler.record_function(name):
                    out = orig(*args, **kwargs)
                if grad:
                    out = _mark_output(out, rng)
                return out
            return wrapped
        self._swap(target, make)

    def close(self):
        while self._saved:
            owner, attr, orig = self._saved.pop()
            setattr(owner, attr, orig)


def _mark_output(out, rng):
    if isinstance(out, torch.Tensor):
        return _OpenOnGrad.apply(out, rng) if out.requires_grad else out
    if isinstance(out, tuple) and out and isinstance(out[0], torch.Tensor) \
            and out[0].requires_grad:
        return (_OpenOnGrad.apply(out[0], rng),) + out[1:]
    return out
