"""Tracing and profiling hooks.

Counterpart of kmbart_tpu/utils/profiling.py:
- ``trace(log_dir)``: record a ``torch.profiler`` trace of the host and,
  where there is one, the card, and write it under ``log_dir`` as a Chrome
  trace (``<log_dir>/trace_<pid>.pt.trace.json``) that TensorBoard's
  profile plugin and Perfetto read. The profiler object is yielded, so a
  caller can also read ``key_averages()``.
- ``StepTimer``: per-step wall-clock EMA and items/s, cheap enough to run
  every step (copied as it is).
"""

import contextlib
import os
import time

import torch


@contextlib.contextmanager
def trace(log_dir):
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, f"trace_{os.getpid()}.pt.trace.json"))


class StepTimer:
    def __init__(self, ema=0.9):
        self._ema = ema
        self._avg = None
        self._last = None

    def start(self):
        self._last = time.perf_counter()

    def stop(self, items=1):
        dt = time.perf_counter() - self._last
        self._avg = dt if self._avg is None else \
            self._ema * self._avg + (1 - self._ema) * dt
        return dt, items / dt if dt > 0 else float("inf")

    @property
    def avg_seconds(self):
        return self._avg
