"""Device ops launched inside ``kmb:train.optimizer`` a step
(harness/program.py)."""

from gpubench.harness import program


def read(run):
    spans = program.spans(run)
    step, opt = spans.get("train.step"), spans.get("train.optimizer")
    if not step or not step["calls"] or not opt:
        return None
    return opt["launches"] / step["calls"]
