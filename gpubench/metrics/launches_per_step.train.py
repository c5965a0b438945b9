"""Device ops launched inside ``kmb:train.step`` a step, its backward
included (harness/program.py)."""

from gpubench.harness import program


def read(run):
    step = program.spans(run).get("train.step")
    if not step or not step["calls"]:
        return None
    return step["launches"] / step["calls"]
