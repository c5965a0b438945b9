"""Device milliseconds a generate call of the ops launched inside
``kmb:generate.inputs``: the inputs' host-to-device copies
(harness/program.py)."""

from gpubench.harness import program


def read(run):
    spans = program.spans(run)
    call, inputs = spans.get("generate"), spans.get("generate.inputs")
    if not call or not call["calls"] or not inputs:
        return None
    return 1e3 * inputs["device_s"] / call["calls"]
