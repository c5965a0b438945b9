"""Model FLOP utilisation of generation: the model operations of the calls
completed in the window (work/model.py, with each call's decode steps as
counted at the decode step's call site) over the window's seconds and the
card's bf16 peak. Read from the untraced window of a ``--trace 1`` run."""

from gpubench.work import model

HOST = {"decode_step": "kmbart_tpu_torch.models.bart:decode_step_stationary"}


def read(run):
    if run.peaks is None or "decode_step" not in run.host:
        return None
    calls = run.window["units"]
    steps = run.host["decode_step"][1]
    per, extra = divmod(steps, calls)
    flops = (calls - extra) * model.generate_flops(run.cfg, run.mix, per) \
        + extra * model.generate_flops(run.cfg, run.mix, per + 1)
    return 100.0 * flops / run.window["seconds"] / run.peaks["bf16_flops"]
