"""Host milliseconds a step inside the program's ``train.step`` span, over
the window of a ``--trace 1`` run (harness/program.py)."""

from gpubench.harness import program


def read(run):
    return program.mean_ms(program.window(run, "train.step"), "train.step")
