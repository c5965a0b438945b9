"""The traced part of a ``--trace 1`` run, reduced from the profiler's trace.

``profile(fn)`` runs ``fn`` under ``torch.profiler`` (host and device),
writes the Chrome trace into a temporary file under ``TMPDIR``, reads it
back and deletes it. ``reduce_events`` turns its events into:

- ``busy_s``: the union of the device's kernel, copy and set intervals;
- ``window_s``: the host clock over the traced calls, ended by a
  synchronise;
- ``spans``: per ``span:<op>`` range, the summed device time of the
  kernels launched inside it (a launch belongs to a range when the host
  call that launched it lies inside the range on the same host thread);
- ``device_ops``: the 10 device operations with the most time, by name;
- ``idle_gaps``: the 10 longest stretches with nothing on the device, each
  named by the innermost span and host op running at its middle.
"""

import bisect
import json
import os
import tempfile
import time

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
HOST_CATS = ("cpu_op", "user_annotation")


def profile(fn):
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as tprofile
    torch.cuda.synchronize()
    with tprofile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        window_s = time.perf_counter() - t0
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.unlink(path)
    out = reduce_events(events)
    out["window_s"] = window_s
    return out


def _union(intervals):
    merged = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


def _innermost(events, t):
    """Name of the shortest event of ``events`` (sorted by start) that holds t."""
    best = None
    for ts, end, name in events:
        if ts > t:
            break
        if end >= t and (best is None or end - ts < best[0]):
            best = (end - ts, name)
    return None if best is None else best[1]


def _last_before(rs, starts, t):
    """The range of ``rs`` (sorted, not nested) that starts last at or
    before t, or (None, None, None)."""
    i = bisect.bisect_right(starts, t) - 1
    return rs[i] if i >= 0 else (None, None, None)


def reduce_events(events):
    """Reduce Chrome-trace events (times in microseconds) as the module
    docstring says; times out are in seconds."""
    dev, launches, ranges, host = [], {}, {}, []
    for e in events:
        if e.get("ph") != "X":
            continue
        cat, ts, dur = e.get("cat", ""), float(e.get("ts", 0)), float(e.get("dur", 0))
        if cat in DEVICE_CATS:
            dev.append((ts, ts + dur, e.get("name", ""), e.get("args", {}).get("correlation")))
        elif cat in LAUNCH_CATS:
            corr = e.get("args", {}).get("correlation")
            if corr is not None:
                launches[corr] = (e.get("tid"), ts)
        if cat == "user_annotation" and e.get("name", "").startswith("span:"):
            ranges.setdefault(e.get("tid"), []).append((ts, ts + dur, e["name"][5:]))
        if cat in HOST_CATS:
            host.append((ts, ts + dur, e.get("name", "")))
    for r in ranges.values():
        r.sort()
    starts = {tid: [r[0] for r in rs] for tid, rs in ranges.items()}
    spans = {}
    by_name = {}
    for a, b, name, corr in dev:
        by_name[name] = by_name.get(name, 0.0) + (b - a)
        tid, t = launches.get(corr, (None, None))
        if tid not in ranges:
            continue
        ra, rb, op = _last_before(ranges[tid], starts[tid], t)
        if ra is not None and t <= rb:
            spans[op] = spans.get(op, 0.0) + (b - a)
    merged = _union([(a, b) for a, b, _, _ in dev])
    busy = sum(b - a for a, b in merged)
    host.sort()
    gaps = sorted(((a1 - b0, 0.5 * (b0 + a1)) for (_, b0), (a1, _) in zip(merged, merged[1:])),
                  reverse=True)[:10]
    named = []
    for gap, mid in gaps:
        span = _innermost([h for h in host if h[2].startswith("span:")], mid)
        op = _innermost([h for h in host if not h[2].startswith("span:")], mid)
        named.append([" > ".join(x for x in (span, op) if x) or "host (no op)", gap / 1e6])
    top = sorted(by_name.items(), key=lambda kv: kv[1], reverse=True)[:10]
    return {"busy_s": busy / 1e6,
            "spans": {k: v / 1e6 for k, v in spans.items()},
            "device_ops": [[n[:160], s / 1e6] for n, s in top],
            "idle_gaps": [[w[:160], g] for w, g in named]}
