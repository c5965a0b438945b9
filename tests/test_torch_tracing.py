"""PyTorch port: the program's spans and counters (``utils/profiling.py``).

Off, ``span`` reads no clock and opens no range; on, its records nest per
thread and carry their generate call's or train step's id; under a
``torch.profiler`` each span is a ``kmb:<name>`` range of the trace. A
generate call, a train step and the feed give the span tree that
``utils/profiling.py`` names, and the tokens, losses and weights are the
same with the recorder on and off. The launch counters behind
``ops.launch_counts``. CPU, tiny model.
"""

import contextlib
import copy
import json
import os
import threading

import numpy as np
import pytest
import torch

from kmbart_tpu_torch.config import tiny_config
from kmbart_tpu_torch.generation.api import generate
from kmbart_tpu_torch.models.conditional import conditional_loss, init_conditional_model
from kmbart_tpu_torch.ops import LAUNCHES, launch_counts, reset_launch_counts
from kmbart_tpu_torch.parallel.train_step import build_train_step
from kmbart_tpu_torch.training.adamw import AdamW
from kmbart_tpu_torch.training.state import TrainState
from kmbart_tpu_torch.training.trainer import prefetch_to_device
from kmbart_tpu_torch.utils import profiling
from kmbart_tpu_torch.utils.profiling import count, recording, span

TRAIN_PHASES = ["train.forward", "train.backward", "train.guard", "train.optimizer"]


@pytest.fixture(scope="module")
def cfg():
    return tiny_config(dropout=0.1, pad_token_id=1, bos_token_id=0, eos_token_id=2,
                       decoder_start_token_id=0)


@pytest.fixture(scope="module")
def model(cfg):
    return init_conditional_model(cfg, seed=0, device="cpu").eval()


def _prompts(cfg, B=3, S=10):
    rng = np.random.default_rng(0)
    ids = rng.integers(4, 80, (B, S)).astype(np.int32)
    ids[:, 1:3] = cfg.img_feat_id
    mask = np.ones((B, S), np.int32)
    mask[1, -3:] = 0
    feats = rng.normal(size=(B, cfg.max_img_num, cfg.image_feature_size)).astype(np.float32)
    return {"input_ids": ids, "attention_mask": mask, "image_features": feats}


def _train_batch(cfg, B=4, S=10, T=6):
    b = _prompts(cfg, B, S)
    rng = np.random.default_rng(1)
    labels = rng.integers(4, 80, (B, T))
    labels[0, -2:] = -100
    b = {k: torch.from_numpy(v) for k, v in b.items()}
    b["input_ids"] = b["input_ids"].long()
    b["attention_mask"] = b["attention_mask"].long()
    b.update(decoder_input_ids=torch.from_numpy(rng.integers(4, 80, (B, T))),
             decoder_attention_mask=torch.ones((B, T), dtype=torch.long),
             labels=torch.from_numpy(labels))
    return b


def _trainer(model, cfg):
    model = copy.deepcopy(model).train()
    opt = AdamW(lr=1e-3)
    step = build_train_step(
        lambda m, b, g: (conditional_loss(m, cfg, b, train=True, generator=g)[0], {}), opt)
    return TrainState.create(model, opt), step


def _names(records):
    return [r.name for r in records]


def test_span_off_reads_no_clock_and_opens_no_range(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("the recorder is off")
    monkeypatch.setattr(profiling.time, "perf_counter_ns", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    monkeypatch.setattr(profiling, "Record", refuse)
    assert not profiling._on
    a, b = span("generate", id=3), span("beam.step")
    assert a is b                       # one shared no-op context
    with a as inner, b:
        assert inner is None


def test_spans_nest_per_thread_with_ids():
    seen = {}

    def other():
        with span("feed.stage") as rec:
            seen["feed"] = rec

    with recording() as records:
        with span("train.step", id=7) as step:
            with span("train.forward") as fwd:
                with span("inner") as inner:
                    t = threading.Thread(target=other)
                    t.start()
                    t.join(timeout=30)
            with span("train.optimizer", id=9) as opt:
                pass
        with span("loose") as loose:
            pass
    assert not t.is_alive()
    assert profiling._on is False and span("x") is span("y")
    assert set(map(id, records)) == set(map(id, (step, fwd, inner, opt, loose, seen["feed"])))
    assert step.parent is None and fwd.parent is step and inner.parent is fwd
    assert opt.parent is step and loose.parent is None
    assert (step.id, fwd.id, inner.id, opt.id, loose.id) == (7, 7, 7, 9, None)
    feed = seen["feed"]
    assert feed.parent is None and feed.id is None     # parents are per thread
    assert feed.thread != step.thread == threading.get_ident()
    for r in records:
        assert r.end >= r.start and r.profiled is False
    assert step.start <= fwd.start <= inner.start <= inner.end <= fwd.end <= opt.start \
        <= opt.end <= step.end <= loose.start
    assert inner.start <= feed.start <= feed.end <= inner.end


def test_recording_inside_recording_shares_the_records():
    with recording() as outer:
        with recording() as inner:
            with span("a"):
                pass
        assert inner is outer and profiling._on
        with span("b"):
            pass
    assert _names(outer) == ["a", "b"] and not profiling._on


def test_kmb_ranges_in_a_cpu_profiler_trace(tmp_path):
    from torch.profiler import ProfilerActivity, profile
    x = torch.ones(8, 8)
    with recording() as records, profile(activities=[ProfilerActivity.CPU]) as prof:
        with span("train.step", id=0):
            with span("train.forward"):
                torch.mm(x, x)
    assert all(r.profiled for r in records)
    path = str(tmp_path / "t.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
    ranges = {e["name"]: e for e in events if e["name"].startswith("kmb:")}
    assert set(ranges) == {"kmb:train.step", "kmb:train.forward"}
    assert all(ranges[k]["cat"] == "user_annotation" for k in ranges)
    outer, inner = ranges["kmb:train.step"], ranges["kmb:train.forward"]
    mm = next(e for e in events if e["name"] == "aten::mm")
    assert outer["ts"] <= inner["ts"] <= mm["ts"]
    assert mm["ts"] + mm["dur"] <= inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"]
    assert not any(e["name"].startswith("span:") for e in events)


def test_trace_writes_the_programs_ranges(tmp_path):
    with profiling.trace(str(tmp_path / "prof")):
        with span("generate", id=0):
            torch.ones(4).sum()
    assert not profiling._on
    (name,) = os.listdir(tmp_path / "prof")
    with open(tmp_path / "prof" / name) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "kmb:generate" for e in events)


@pytest.mark.parametrize("num_beams", [2, 1])
def test_generate_span_tree(model, cfg, num_beams):
    L = 6
    with recording() as records:
        out = generate(model, cfg, _prompts(cfg), num_beams=num_beams, max_length=L,
                       early_stopping=True)
    (call,) = [r for r in records if r.name == "generate"]
    assert call.parent is None and isinstance(call.id, int)
    assert all(r.id == call.id for r in records)
    kids = [r.name for r in records if r.parent is call]
    stops = [r for r in records if r.name == "sync.stop_test"]
    steps = [r for r in records if r.name == "beam.step"]
    assert all(r.parent is call for r in stops + steps)
    assert kids[:2] == ["generate.inputs", "encode"] and kids[-1] == "sync.outputs"
    if num_beams > 1:
        # a stop test before each step, and one more where the loop ended early
        n = len(steps)
        assert 1 <= n <= L - 1 and out.shape[1] <= L
        assert kids == (["generate.inputs", "encode"] + ["sync.stop_test", "beam.step"] * n
                        + ["sync.stop_test"] * (n < L - 1) + ["sync.width", "sync.outputs"])
    else:
        assert kids == (["generate.inputs", "encode"] + ["sync.stop_test"] * len(stops)
                        + ["sync.outputs"])
    for r in records:
        assert call.start <= r.start <= r.end <= call.end


def test_generate_ids_differ_between_calls(model, cfg):
    with recording() as records:
        for _ in range(2):
            generate(model, cfg, _prompts(cfg, B=2), num_beams=2, max_length=4)
    ids = [r.id for r in records if r.name == "generate"]
    assert len(ids) == 2 and ids[0] != ids[1]


def test_train_step_span_tree(model, cfg):
    state, step = _trainer(model, cfg)
    batch = _train_batch(cfg)
    state, _ = step(state, batch, 5)
    with recording() as records:
        state, _ = step(state, batch, 5)
    (root,) = [r for r in records if r.name == "train.step"]
    assert root.id == 1 and root.parent is None
    assert [r.name for r in records if r.parent is root] == TRAIN_PHASES
    assert all(r.id == 1 for r in records)
    phases = [r for r in records if r.parent is root]
    assert all(a.end <= b.start for a, b in zip(phases, phases[1:]))


def test_train_step_accumulation_repeats_forward_and_backward(model, cfg):
    model = copy.deepcopy(model).train()
    opt = AdamW(lr=1e-3)
    step = build_train_step(
        lambda m, b, g: (conditional_loss(m, cfg, b, train=True, generator=g)[0], {}), opt,
        grad_accum_steps=2)
    with recording() as records:
        step(TrainState.create(model, opt), _train_batch(cfg), 5)
    assert [r.name for r in records if r.parent is records[0]] == \
        ["train.forward", "train.backward"] * 2 + ["train.guard", "train.optimizer"]


def test_feed_spans(cfg):
    batches = [{"x": np.full((2, 3), i, np.float32)} for i in range(3)]
    with recording() as records:
        got = list(prefetch_to_device(batches, torch.device("cpu"), depth=2))
    assert [float(b["x"][0, 0]) for b in got] == [0.0, 1.0, 2.0]
    stages = [r for r in records if r.name == "feed.stage"]
    waits = [r for r in records if r.name == "feed.wait"]
    assert len(stages) == 3 and len(waits) == 4       # the last wait reads the end
    assert {r.thread for r in stages} != {threading.get_ident()}
    assert {r.thread for r in waits} == {threading.get_ident()}


def test_results_identical_with_the_recorder_on_and_off(model, cfg):
    prompts = _prompts(cfg)
    off = generate(model, cfg, prompts, num_beams=2, max_length=6)
    with recording():
        on = generate(model, cfg, prompts, num_beams=2, max_length=6)
    np.testing.assert_array_equal(on, off)

    batch = _train_batch(cfg)
    runs = []
    for recorder in (False, True):
        state, step = _trainer(model, cfg)
        losses = []
        with recording() if recorder else contextlib.nullcontext():
            for _ in range(2):
                state, metrics = step(state, batch, 11)
                losses.append(metrics["loss"])
        runs.append((losses, state.params.state_dict(), state.opt_state.mu))
    (l0, p0, m0), (l1, p1, m1) = runs
    assert all(torch.equal(a, b) for a, b in zip(l0, l1))
    assert all(torch.equal(p0[k], p1[k]) for k in p0)
    assert all(torch.equal(m0[k], m1[k]) for k in m0)


def test_launch_counters():
    reset_launch_counts()
    assert launch_counts() == dict.fromkeys(LAUNCHES, 0)
    count("launch.ffn")
    count("launch.beam_attention", 3)
    count("launch.beam_attention_ring")
    count("sync.other")                  # counters of other names stay apart
    got = launch_counts()
    assert (got["ffn"], got["beam_attention"], got["beam_attention_ring"]) == (1, 3, 1)
    assert list(got) == list(LAUNCHES) and sum(got.values()) == 5
    reset_launch_counts()
    assert launch_counts() == dict.fromkeys(LAUNCHES, 0)
    assert profiling.counters["sync.other"] == 1
    del profiling.counters["sync.other"]
