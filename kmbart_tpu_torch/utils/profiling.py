"""Tracing and profiling hooks: the program's spans and counters, and a
``torch.profiler`` trace that carries them.

- ``span(name, id=None)``: a span of the program's own work, as a context
  manager. Off (the default) it returns a shared no-op context after one
  check of a module flag: no clock, no allocation, no range. On, it
  appends a ``Record`` to the records of ``recording()``, and while a
  ``torch.profiler`` is active on the thread it also opens a
  ``record_function`` range named ``kmb:<name>``, so the spans sit on the
  profiler's timeline beside the device ops they launch.
- ``recording()``: turns the spans on inside its block and yields the list
  their records go to (a block inside another shares the outer list).
- ``trace(log_dir)``: record a ``torch.profiler`` trace of the host and,
  where there is one, the card, with the spans on, and write it under
  ``log_dir`` as a Chrome trace (``<log_dir>/trace_<pid>.pt.trace.json``)
  that TensorBoard's profile plugin and Perfetto read. The profiler object
  is yielded, so a caller can also read ``key_averages()``.
- ``count(name, n=1)``: counters in one dict, ``counters``, always on. The
  kernel wrappers count their launches there as ``launch.<kernel>``
  (ops/__init__.py ``launch_counts``).

The spans the program opens (their names are the contract that the
benchmark's readers use):

==================  =====================================================
``generate``        one ``generation/api.py generate`` call (its id)
``generate.inputs`` the call's host-to-device copies of its inputs
``encode``          the encoder pass (``generation/api.py _decode``)
``beam.step``       one decode step of ``generation/beam.py``'s loop
``sync.stop_test``  the host's read of the loop's stop test (beam, greedy)
``sync.width``      the host's read of the served width (beam)
``sync.outputs``    the tokens' copy back to the host
``train.step``      one ``parallel/train_step.py`` step (id: its step)
``train.forward``   the loss function, per micro-batch
``train.backward``  ``loss.backward()``, per micro-batch
``train.guard``     the non-finite check
``train.optimizer`` the optimizer's update (AdamW or ZeRO-1)
``feed.wait``       ``training/trainer.py prefetch_to_device``: the
                    consumer waiting for a staged batch
``feed.stage``      the feed's thread staging one batch on the device
==================  =====================================================
"""

import contextlib
import os
import threading
import time

import torch

counters = {}

_on = False
_records = None
_local = threading.local()
_OFF = contextlib.nullcontext()


def count(name, n=1):
    counters[name] = counters.get(name, 0) + n


class Record:
    """One span: ``name``; ``id``, the generate call's or train step's it
    belongs to (a span without one takes its parent's); ``parent``, the
    ``Record`` of the span that held it on the same thread, or None;
    ``thread`` (``threading.get_ident``); ``start`` and ``end`` in
    ``time.perf_counter_ns`` (``end`` None while open); ``profiled``,
    whether a ``torch.profiler`` was active on the thread at its start (it
    then opened a ``kmb:<name>`` range)."""

    __slots__ = ("name", "id", "parent", "thread", "start", "end", "profiled")

    def __init__(self, name, id, parent, thread, profiled):
        self.name, self.id, self.parent, self.thread = name, id, parent, thread
        self.profiled = profiled
        self.start = self.end = None


class _Span:
    __slots__ = ("name", "id", "records", "record", "range")

    def __init__(self, name, id, records):
        self.name, self.id, self.records = name, id, records

    def __enter__(self):
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        parent = stack[-1] if stack else None
        profiled = torch.autograd._profiler_enabled()
        rec = Record(self.name, self.id if self.id is not None or parent is None else parent.id,
                     parent, threading.get_ident(), profiled)
        self.range = None
        if profiled:
            self.range = torch.autograd.profiler.record_function("kmb:" + self.name)
            self.range.__enter__()
        stack.append(rec)
        self.records.append(rec)
        self.record = rec
        rec.start = time.perf_counter_ns()
        return rec

    def __exit__(self, *exc):
        rec = self.record
        rec.end = time.perf_counter_ns()
        _local.stack.pop()
        if self.range is not None:
            self.range.__exit__(*exc)
        return False


def span(name, id=None):
    """A span of the program's work named ``name`` (module docstring);
    ``id``: the generate call's or train step's, on the span that opens
    one."""
    if not _on:
        return _OFF
    return _Span(name, id, _records)


@contextlib.contextmanager
def recording():
    """Spans on inside the block; yields the list of their ``Record``s."""
    global _on, _records
    if _on:
        yield _records
        return
    _records, _on = [], True
    try:
        yield _records
    finally:
        _records, _on = None, False


@contextlib.contextmanager
def trace(log_dir):
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with recording(), profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, f"trace_{os.getpid()}.pt.trace.json"))
