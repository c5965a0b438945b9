"""harness/program.py: the ``program`` key that ``trace.reduce_events``
gains from the program's ``kmb:`` ranges, on synthetic Chrome-trace events
(launches inside nested ranges, the backward's thread, the feed's thread,
sync calls and the idle time after a sync); the other keys unchanged by
the ranges; and the window's records. Importing the module turns the
program's recorder on for the rest of the process, as in a traced run."""

import pytest

from gpubench.harness import program, trace
from kmbart_tpu_torch.utils.profiling import Record

MAIN, BACKWARD, FEED = 1, 2, 3


def _x(cat, name, ts, dur, tid, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "tid": tid, "pid": 0}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def _launch(tid, t, corr, start, dur, name="kernel_a", cat="kernel"):
    return [_x("cuda_runtime", "cudaLaunchKernel", t, 1, tid, corr),
            _x(cat, name, start, dur, 7, corr)]


def _events(with_ranges=True):
    ev = []
    ev += _launch(MAIN, 10, 1, 12, 8)                                  # forward
    ev += _launch(BACKWARD, 40, 2, 41, 9, name="kernel_b")             # backward
    ev += _launch(FEED, 45, 3, 46, 1, name="Memcpy HtoD", cat="gpu_memcpy")  # the feed's copy
    ev += _launch(MAIN, 70, 4, 71, 9)                                  # optimizer
    ev += _launch(MAIN, 110, 5, 120, 5)                                # after the step
    ev += [_x("cuda_runtime", "cudaStreamSynchronize", 90, 2, MAIN, 6),
           _x("cpu_op", "autograd::engine::evaluate_function", 38, 14, BACKWARD),
           _x("cpu_op", "aten::add", 55, 10, MAIN)]
    if with_ranges:
        ev += [_x("user_annotation", "kmb:" + n, a, b - a, MAIN) for n, a, b in (
            ("train.step", 0, 100), ("train.forward", 0, 30), ("train.backward", 30, 60),
            ("train.optimizer", 60, 100), ("sync.stop_test", 85, 95))]
    return ev


def test_program_key():
    got = program.reduce_program(_events())
    step = got["train.step"]
    # the forward's, the backward's (lent by its thread) and the optimizer's
    # launches; not the feed's copy, nor the launch after the step
    assert (step["calls"], step["launches"], step["syncs"]) == (1, 3, 1)
    assert step["host_s"] == pytest.approx(100e-6)
    assert step["device_s"] == pytest.approx((8 + 9 + 9) * 1e-6)
    assert got["train.forward"]["launches"] == 1
    assert got["train.forward"]["device_s"] == pytest.approx(8e-6)
    assert (got["train.backward"]["launches"], got["train.backward"]["syncs"]) == (1, 0)
    assert got["train.backward"]["device_s"] == pytest.approx(9e-6)
    assert (got["train.optimizer"]["launches"], got["train.optimizer"]["syncs"]) == (1, 1)
    sync = got["sync.stop_test"]
    assert (sync["launches"], sync["syncs"]) == (0, 1)
    # idle from the sync's end (95) to the next device op (120)
    assert sync["idle_after_s"] == pytest.approx(25e-6)
    # the forward ends at 30 with nothing on the device until 41
    assert got["train.forward"]["idle_after_s"] == pytest.approx(11e-6)
    assert step["idle_after_s"] == pytest.approx(20e-6)


def test_idle_after_is_zero_while_the_device_is_busy():
    ev = _launch(MAIN, 0, 1, 2, 50) + [_x("user_annotation", "kmb:encode", 0, 10, MAIN)]
    assert program.reduce_program(ev)["encode"]["idle_after_s"] == 0.0


def test_no_ranges_no_program():
    assert program.reduce_program(_events(with_ranges=False)) == {}


def test_existing_keys_unchanged_by_the_ranges():
    """``reduce_events`` (patched by the import) keeps every key of the
    harness's reduction as it was; the ranges only name gaps that fell in
    no host op."""
    assert trace.reduce_events is not program._reduce_events
    plain = program._reduce_events(_events(with_ranges=False))
    got = trace.reduce_events(_events())
    assert set(got) == set(plain) | {"program"}
    for key in ("busy_s", "spans", "device_ops"):
        assert got[key] == plain[key]
    assert [g for _, g in got["idle_gaps"]] == [g for _, g in plain["idle_gaps"]]
    for (name, _), (was, _) in zip(got["idle_gaps"], plain["idle_gaps"]):
        assert name == was or (was == "host (no op)" and name.startswith("kmb:"))
    assert [n for n, _ in got["idle_gaps"]] == ["kmb:train.optimizer", "aten::add",
                                                 "kmb:train.backward"]
    assert got["program"] == program.reduce_program(_events())


class _Run:
    def __init__(self, units, trace=None):
        self.window, self.trace = {"units": units}, trace


def _record(name, start, end, parent=None, profiled=False, thread=MAIN):
    r = Record(name, None, parent, thread, profiled)
    r.start, r.end = start, end
    return r


def test_window_records(monkeypatch):
    """The window: the last ``units`` root spans before the traced part's,
    and every record that starts between the first's start and the last's
    end (the feed's thread's too)."""
    recs = []
    for i, profiled in enumerate([False] * 5 + [True] * 2):     # 2 set-up, 3 window, 2 traced
        step = _record("train.step", 100 * i, 100 * i + 80, profiled=profiled)
        recs += [step, _record("train.forward", 100 * i, 100 * i + 30, step, profiled),
                 _record("feed.stage", 100 * i + 50, 100 * i + 60, thread=FEED)]
    recs.append(_record("feed.wait", 800, 801))                 # the feed drained after
    monkeypatch.setattr(program, "RECORDS", recs)
    got = program.window(_Run(3), "train.step")
    assert [r.start for r in got if r.name == "train.step"] == [200, 300, 400]
    assert [r.start for r in got if r.name == "feed.stage"] == [250, 350, 450]
    assert program.mean_ms(got, "train.step") == pytest.approx(80e-6)
    assert program.mean_ms(got, "beam.step") is None
    monkeypatch.setattr(program, "RECORDS", None)
    assert program.window(_Run(3), "train.step") == []


def test_readers_return_nothing_without_the_programs_spans():
    from conftest import ROOT
    from gpubench.harness.registry import Registry
    reg = Registry(ROOT)
    names = ["host_syncs.gen", "sync_idle_ms.gen", "input_copy_ms.gen",
             "launches_per_step.train", "optimizer_launches.train"]
    for name in names:
        reader = reg.metric(name)
        assert reader.read(_Run(3, trace={"busy_s": 1.0})) is None
        assert reader.read(_Run(3, trace={"program": {}})) is None
        assert reader.read(_Run(3)) is None
