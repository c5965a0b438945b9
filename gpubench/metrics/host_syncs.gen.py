"""Synchronising runtime calls a generate call (``kmb:generate`` ranges of
the traced calls; harness/program.py)."""

from gpubench.harness import program


def read(run):
    call = program.spans(run).get("generate")
    if not call or not call["calls"]:
        return None
    return call["syncs"] / call["calls"]
