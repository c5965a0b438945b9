"""Readings that set a cell's limits: the system's, the control's and the
faults', seed by seed, in one process, each judged by the cell's limits
with the run's own comparison (``runner.judge``).

    python3 gpubench/control.py --workload <cell> --seeds 11,12,13 [--units 2] [--faults 3]

For each seed it builds the cell's loop as a run does, drives ``--units``
calls (generation) or steps (training) past set-up, frees the system and
prints one JSON line: for each side its numbers and ``correct``.

- ``system``: the numbers the run's check compares;
- ``control``: the reference put in the system's place, computed with
  float8 (e4m3) operands and activations, the precision below the bf16
  that the configurations state. Generation serves the rows of the float8
  reference's own beam search, with the scores that search gave them;
- ``half_batch`` (training): the reference on the first half of each batch,
  the mean taken over it, in the system's place;
- the faults of ``FAULTS`` (generation), planted in the system, on the
  first ``--faults`` seeds.

A training step that returns its state unchanged reads 1 on ``change_gap``
by its definition and needs no run. The benchmark's own runs never run
this.
"""

import argparse
import gc
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from gpubench.harness.registry import Registry  # noqa: E402
from gpubench.harness.runner import Context, judge  # noqa: E402


def token_altered(setattr, cfg):
    """Each token of the next beam front moved to the next id where the
    beam step produces it; the scores stay as they were."""
    from kmbart_tpu_torch.generation import beam
    orig = beam.beam_front

    def altered(*args, **kwargs):
        scores, tokens, parents = orig(*args, **kwargs)
        return scores, (tokens + 1) % cfg["img_feat_id"], parents
    setattr(beam, "beam_front", altered)


def decode_step_unchanged(setattr, cfg):
    """The decode step returns its input's embedding: every layer skipped."""
    from kmbart_tpu_torch.models import bart

    def unchanged(model, cfg_obj, token_ids, caches, cache_index, ancestry, *args, **kwargs):
        return bart._decoder_embed(model, cfg_obj, token_ids, cache_index)
    setattr(bart, "decode_step_stationary", unchanged)


FAULTS = {"generate": {"token_altered": token_altered,
                       "decode_step_unchanged": decode_step_unchanged}}


class _Patches:
    def __init__(self):
        self.saved = []

    def __call__(self, owner, name, value):
        self.saved.append((owner, name, getattr(owner, name)))
        setattr(owner, name, value)

    def undo(self):
        while self.saved:
            setattr(*self.saved.pop())


def _judged(numbers, limits):
    return {"numbers": numbers, "correct": judge(numbers, limits)}


def _drive(reg, cfg, mix, seed, device, units):
    import torch
    loop = reg.loop(mix["loop"]).Loop(Context(cfg, mix, seed, device))
    for _ in range(units):
        loop.call()
    loop.sync()
    loop.free()
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return loop


def gen_readings(loop, limits):
    from gpubench.loops.generate import Reference
    prompts, rows, scores = loop.served()
    reference = Reference(loop.ctx, loop.opts)
    rows8, scores8 = reference.beam("fp8", prompts)
    return {"system": _judged(reference.numbers(prompts, rows, scores), limits),
            "control": _judged(reference.numbers(prompts, rows8, scores8), limits)}


def train_readings(loop, limits):
    from gpubench.loops.train import compare
    want = loop.reference_readings("fp32")
    half = slice(0, loop.mix["batch"] // 2)
    return {"system": _judged(compare(loop.program_readings(), want), limits),
            "control": _judged(compare(loop.reference_readings("fp8"), want), limits),
            "half_batch": _judged(compare(loop.reference_readings("fp32", rows=half), want),
                                  limits)}


def main(argv=None, *, device=None, cfg_override=None, mix_override=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--units", type=int, default=2)
    p.add_argument("--faults", type=int, default=3,
                   help="plant each fault on this many of the first seeds")
    args = p.parse_args(argv)
    reg = Registry(ROOT)
    cell = reg.cell(args.workload)
    os.environ.update(cell.get("env", {}))
    import torch
    if device is None:
        device = torch.device("cuda", 0)
        torch.cuda.set_device(device)
    cfg = dict(reg.config(cell["config"]), **(cfg_override or {}))
    mix = dict(reg.traffic(cell["traffic"]), **(mix_override or {}))
    limits = cell["limits"]
    out = []
    for n, seed in enumerate(int(s) for s in args.seeds.split(",")):
        t = time.perf_counter()
        loop = _drive(reg, cfg, mix, seed, device, args.units)
        read = gen_readings if loop.kind == "generate" else train_readings
        line = read(loop, limits)
        del loop
        for name, plant in FAULTS.get(mix["loop"], {}).items() if n < args.faults else ():
            patches = _Patches()
            plant(patches, cfg)
            try:
                faulty = _drive(reg, cfg, mix, seed, device, args.units)
            finally:
                patches.undo()
            line[name] = _judged(faulty.numbers(), limits)
            del faulty
        line.update(workload=args.workload, seed=seed, seconds=time.perf_counter() - t)
        print(json.dumps(line), flush=True)
        out.append(line)
        gc.collect()
    return out


if __name__ == "__main__":
    main()
