"""The program's own spans (``kmbart_tpu_torch/utils/profiling.py``), for
the readers of the metrics that read them.

A reader that reads them imports this module. Readers of per-layer
metrics are loaded only by ``--trace 1`` runs, before set-up, so the
import does two things for the rest of such a run:

- it turns the program's recorder on (``profiling.recording()``): set-up,
  the window and the traced part keep the program's span records, and
  ``window(run, root)`` picks out the window's;
- it makes ``trace.reduce_events`` return one key more, ``program``
  (``reduce_program``), from the ``kmb:`` ranges that the program's spans
  open under the profiler. The other keys come out as before; the idle
  gaps' names may now be ``kmb:`` ones, where a gap's middle falls in a
  span and in no aten op.

A program without the recorder (older than its spans) leaves both empty,
and the readers return None.
"""

import bisect
import contextlib

from gpubench.harness import trace

PREFIX = "kmb:"
SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize")


def reduce_program(events):
    """Per span name of the ``kmb:`` ranges in Chrome-trace ``events``
    (times in microseconds): ``calls``; ``host_s``, their summed length;
    ``launches``, the device ops (kernels, copies, sets) launched inside
    them, and ``device_s``, those ops' summed device time; ``syncs``, the
    synchronising runtime calls (``SYNC_CALLS``) made inside them; and
    ``idle_after_s``, the summed time from each range's end to the next
    device op's start, where nothing ran on the device at its end.

    A runtime call lies inside every range open at its moment on its own
    thread. A thread that opens no ``kmb:`` range but on which the profiler
    recorded host ops is the autograd engine's device thread, which runs
    the backward for the thread that called ``backward()`` (it carries that
    thread's profiler state): its calls lie inside the ranges open at their
    moment on the thread with the most ranges open then."""
    ranges, dev, calls, syncs, op_threads = [], [], {}, [], set()
    for e in events:
        if e.get("ph") != "X":
            continue
        cat, name = e.get("cat", ""), e.get("name", "")
        ts, dur, tid = float(e.get("ts", 0)), float(e.get("dur", 0)), e.get("tid")
        if cat == "user_annotation" and name.startswith(PREFIX):
            ranges.append((ts, ts + dur, tid, name[len(PREFIX):]))
        elif cat == "cpu_op":
            op_threads.add(tid)
        elif cat in trace.DEVICE_CATS:
            dev.append((ts, ts + dur, e.get("args", {}).get("correlation")))
        elif cat in trace.LAUNCH_CATS:
            corr = e.get("args", {}).get("correlation")
            if corr is not None:
                calls[corr] = (tid, ts)
            if name in SYNC_CALLS:
                syncs.append((tid, ts))
    out = {}
    for _, _, _, name in ranges:
        out[name] = {"calls": 0, "host_s": 0.0, "launches": 0, "device_s": 0.0, "syncs": 0,
                     "idle_after_s": 0.0}
    if not ranges:
        return out
    range_threads = {tid for _, _, tid, _ in ranges}
    lenders = op_threads - range_threads
    # a sweep in time: 0 opens a range, 1 is a runtime call, 2 closes a range
    points = []
    for i, (a, b, tid, _) in enumerate(ranges):
        points += [(a, 0, i, tid), (b, 2, i, tid)]
    for a, b, corr in dev:
        if corr in calls:
            tid, t = calls[corr]
            points.append((t, 1, ("launch", b - a), tid))
    for tid, t in syncs:
        points.append((t, 1, ("sync", 0.0), tid))
    points.sort(key=lambda p: (p[0], p[1]))
    open_ranges = {tid: [] for tid in range_threads}
    for _, kind, x, tid in points:
        if kind == 0:
            open_ranges[tid].append(x)
            continue
        if kind == 2:
            open_ranges[tid].remove(x)
            continue
        holders = open_ranges.get(tid)
        if holders is None and tid in lenders:
            holders = max(open_ranges.values(), key=len)
        for i in holders or ():
            s = out[ranges[i][3]]
            if x[0] == "launch":
                s["launches"] += 1
                s["device_s"] += x[1] / 1e6
            else:
                s["syncs"] += 1
    busy = trace._union([(a, b) for a, b, _ in dev])
    starts = [a for a, _ in busy]
    for a, b, _, name in ranges:
        s = out[name]
        s["calls"] += 1
        s["host_s"] += (b - a) / 1e6
        j = bisect.bisect_right(starts, b)
        inside = j > 0 and busy[j - 1][1] >= b
        if not inside and j < len(busy):
            s["idle_after_s"] += (busy[j][0] - b) / 1e6
    return out


_reduce_events = trace.reduce_events


def _reduce_with_program(events):
    out = _reduce_events(events)
    out["program"] = reduce_program(events)
    return out


def spans(run):
    """The traced part's ``reduce_program`` of a run ({} when untraced)."""
    return (run.trace or {}).get("program", {})


def window(run, root):
    """The program's records made in the run's window: from the start of
    the first of the window's ``root`` spans (``generate``, ``train.step``)
    to the end of the last; they are the last ``run.window["units"]`` made
    before the traced part's. [] without the recorder."""
    if RECORDS is None or not run.window["units"]:
        return []
    roots = [r for r in RECORDS if r.name == root and r.parent is None and r.end is not None]
    i = len(roots)
    while i and roots[i - 1].profiled:
        i -= 1
    roots = roots[max(0, i - run.window["units"]):i]
    if not roots:
        return []
    lo, hi = roots[0].start, roots[-1].end
    return [r for r in RECORDS if r.end is not None and lo <= r.start <= hi]


def mean_ms(records, name):
    """Mean host milliseconds of ``records`` named ``name``, or None."""
    times = [r.end - r.start for r in records if r.name == name]
    return 1e-6 * sum(times) / len(times) if times else None


def _install():
    from kmbart_tpu_torch.utils import profiling
    if trace.reduce_events is _reduce_events:
        trace.reduce_events = _reduce_with_program
    recording = getattr(profiling, "recording", None)
    if recording is None:
        return None
    return _RECORDER.enter_context(recording())


_RECORDER = contextlib.ExitStack()
RECORDS = _install()
