"""Model FLOP utilisation of training: three times the forward's model
operations (work/model.py) for every step taken in the window, over the
window's seconds and the card's bf16 peak. Read from the untraced window
of a ``--trace 1`` run."""

from gpubench.work import model


def read(run):
    if run.peaks is None:
        return None
    flops = run.window["units"] * model.train_step_flops(run.cfg, run.mix)
    return 100.0 * flops / run.window["seconds"] / run.peaks["bf16_flops"]
