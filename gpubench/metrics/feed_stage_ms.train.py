"""Host milliseconds a batch inside the program's ``feed.stage`` span (the
feed's thread pinning one batch and queueing its copies), over the window
of a ``--trace 1`` run (harness/program.py)."""

from gpubench.harness import program


def read(run):
    return program.mean_ms(program.window(run, "train.step"), "feed.stage")
