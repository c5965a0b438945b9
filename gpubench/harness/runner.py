"""One run of one cell: set-up, the measured window, the traced part, the
check, and the result line.

``--trace 0`` prints the cell's end-to-end metrics; ``--trace 1`` its
per-layer metrics, from the same set-up and window with the host spans the
readers ask for, then ``traced_units`` more calls of the loop under the
profiler with the device spans of the readers' ops.
"""

import argparse
import gc
import json
import os
import subprocess
import sys
import time

from gpubench.harness.registry import Registry

FORBIDDEN = {"jax", "jaxlib", "flax", "kmbart_tpu"}


class Context:
    """What a loop gets: the configuration (as the file has it and as the
    system's config object), the mix, the seeds, the device, and the
    benchmark's weights."""

    def __init__(self, cfg, mix, seed, device):
        from kmbart_tpu_torch.config import MultiModalBartConfig
        self.cfg, self.mix, self.seed, self.device = cfg, mix, seed, device
        self.cfg_obj = MultiModalBartConfig.from_dict(cfg)
        self.step_seed = seed % 2 ** 62
        self.weight_offsets = None

    def load_weights(self, model, heads):
        """Copy the benchmark's weights (reference/bart.py ``make_params``)
        into the system's model by name; returns the flat buffer they were
        drawn into."""
        import torch
        from gpubench.reference import bart as ref
        flat, P = ref.make_params(self.cfg, self.seed, self.device, heads=heads)
        params = dict(model.named_parameters())
        if set(params) != set(P):
            raise KeyError(f"model and benchmark weights differ: {sorted(set(params) ^ set(P))}")
        base = flat.data_ptr()
        self.weight_offsets = {}
        with torch.no_grad():
            for name, p in params.items():
                p.copy_(P[name])
                start = (P[name].data_ptr() - base) // flat.element_size()
                self.weight_offsets[name] = (start, start + P[name].numel())
        return flat


class RunView:
    """What a metric reader reads."""

    def __init__(self, **kw):
        self.__dict__.update(kw)

    def op_bound_s(self, op):
        """Σ over the traced calls of ``op`` of its least time on the card,
        or None when a call's work cannot be counted."""
        from gpubench.harness.peaks import bound_s
        if self.peaks is None:
            return None
        work = self.registry.work(op)
        total = 0.0
        for call in self.ops.get(op, []):
            w = work.count(call)
            if w is None:
                return None
            total += bound_s(self.peaks, w.get("bf16_flops", 0.0), w.get("f32_flops", 0.0),
                             w["nbytes"])
        return total


def judge(numbers, limits):
    """``correct``: the check gave every number the cell's limits name, and
    each is at most its limit. A null limit: a number printed beside the
    others but not compared (training's loss gap where no control or fault
    reads far enough above sound runs to set one)."""
    return set(numbers) == set(limits) and all(
        limits[k] is None or numbers[k] <= limits[k] for k in limits)


def parse(argv):
    p = argparse.ArgumentParser(description="Run one benchmark cell (gpubench).")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def _power():
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=20)
        return out.stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "nvidia-smi not readable"


def main(argv=None, *, started=None, root=None, device=None, cfg_override=None,
         mix_override=None):
    """Run a cell; returns the process exit code. ``device``, and the
    overrides of the configuration's and the mix's keys, are for the CPU
    tests: a real run finds the card itself."""
    started = time.perf_counter() if started is None else started
    args = parse(argv)
    reg = Registry(root or os.getcwd())
    cell = reg.cell(args.workload)
    os.environ.update(cell.get("env", {}))
    import torch
    from gpubench.harness import peaks as peaks_mod
    from gpubench.harness import trace as trace_mod
    from gpubench.harness.spans import Spans

    if device is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
            print(f"needs {cell['chips']} CUDA device(s); found "
                  f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
                  file=sys.stderr)
            return 2
        device = torch.device("cuda", 0)
        torch.cuda.set_device(device)
    on_card = device.type == "cuda"
    cfg = dict(reg.config(cell["config"]), **(cfg_override or {}))
    mix = dict(reg.traffic(cell["traffic"]), **(mix_override or {}))
    section = "per_layer" if args.trace else "end_to_end"
    wanted = reg.metrics_of(args.workload, section)
    readers = {m["name"]: reg.metric(m["name"]) for m in wanted}
    kind = torch.cuda.get_device_name(device) if on_card else "cpu"
    peaks = peaks_mod.peaks_for(kind) if on_card else None

    ctx = Context(cfg, mix, args.seed, device)
    loop = reg.loop(mix["loop"]).Loop(ctx)
    loop.sync()
    setup_s = time.perf_counter() - started

    host = Spans()
    if args.trace:
        for r in readers.values():
            for name, target in getattr(r, "HOST", {}).items():
                if name not in host.host:
                    host.add_host(name, target)
    units = rows = 0
    ends = []
    t0 = time.perf_counter()
    try:
        while time.perf_counter() - t0 < args.seconds:
            rows += loop.call()
            units += 1
            ends.append(time.perf_counter() - t0)
        loop.sync()
        window_s = time.perf_counter() - t0
    finally:
        host.close()
    window = {"seconds": window_s, "units": units, "rows": rows}
    if hasattr(loop, "feed_wait_s"):
        window["feed_wait_s"] = loop.feed_wait_s
    attempted = rows if loop.kind == "generate" else units
    failed = loop.failed() if hasattr(loop, "failed") else 0
    mem_peak = torch.cuda.max_memory_allocated(device) if on_card else 0

    traced, ops = None, {}
    if args.trace and on_card:
        dev_spans = Spans()
        for r in readers.values():
            for op in getattr(r, "OPS", ()):
                if op not in dev_spans.calls:
                    work = reg.work(op)
                    for target in work.TARGETS:
                        dev_spans.add_device(op, target, work.capture)
        try:
            traced = trace_mod.profile(
                lambda: [loop.call() for _ in range(mix["traced_units"])])
        finally:
            dev_spans.close()
        ops = dev_spans.calls

    loop.free()
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_check = time.perf_counter()
    numbers = loop.numbers()
    check_s = time.perf_counter() - t_check
    limits = cell["limits"]
    correct = judge(numbers, limits)

    view = RunView(setup_s=setup_s, window=window, host={k: tuple(v) for k, v in
                                                          host.host.items()},
                   trace=traced, ops=ops, cfg=cfg, mix=mix, registry=reg,
                   peaks=peaks)
    metrics = {}
    for m in wanted:
        value = readers[m["name"]].read(view)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    loaded = sorted({name.split(".")[0] for name in sys.modules} & FORBIDDEN)
    if loaded:
        print(f"the run loaded {', '.join(loaded)}: the system under test must not",
              file=sys.stderr)
        return 3

    device_out = {"platform": "gpu" if on_card else "cpu", "kind": kind,
                  "count": cell["chips"], "memory_peak_bytes": mem_peak}
    result = {"correct": correct, "attempted": attempted, "failed": failed,
              "metrics": metrics, "device": device_out}
    if traced is not None:
        device_out.update(busy_s=traced["busy_s"], window_s=traced["window_s"])
        result["breakdown"] = {"device_ops": traced["device_ops"],
                               "idle_gaps": traced["idle_gaps"]}
    result["checks"] = {k: {"value": v, "limit": limits.get(k)} for k, v in numbers.items()}
    print(f"setup {setup_s:.3f} s, window {window_s:.3f} s over {units} calls, "
          f"check {check_s:.3f} s", file=sys.stderr)
    print(f"calls ended by each fifth of the window: "
          f"{[sum(e <= window_s * k / 5 for e in ends) for k in range(1, 6)]}; "
          f"host cpus {sorted(os.sched_getaffinity(0))}; load {os.getloadavg()}",
          file=sys.stderr)
    gaps = sorted(b - a for a, b in zip([0.0] + ends, ends))
    if gaps:
        print(f"host s between call returns: median {gaps[len(gaps) // 2]:.4f}, "
              f"longest {gaps[-3:][::-1]}; torch threads {torch.get_num_threads()}",
              file=sys.stderr)
    note = loop.describe()
    if note:
        print(note, file=sys.stderr)
    if on_card:
        print(f"card: {_power()}", file=sys.stderr)
    for k, v in numbers.items():
        print(f"check {k}: {v!r} limit {limits.get(k)!r}", file=sys.stderr)
    print(json.dumps(result))
    return 0
