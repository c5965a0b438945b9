"""What the per-layer metrics share: an op's share of its roofline and the
device's idle share, read from a ``--trace 1`` run's trace."""


def roofline_pct(run, op):
    """The sum over the traced calls of ``op`` of its least time on the card
    (``work/<op>.py``, from the op's own shapes) over the summed device time
    of the kernels launched inside its spans, its backward included; None
    where the trace holds none of its kernels."""
    if run.trace is None:
        return None
    device_s = run.trace["spans"].get(op, 0.0)
    bound = run.op_bound_s(op)
    if not device_s or not bound:
        return None
    return 100.0 * bound / device_s


def idle_pct(run):
    """The share of the traced window in which nothing ran on the card
    (kernels, copies and sets), from the profiler's device timeline."""
    if run.trace is None:
        return None
    return 100.0 * (1.0 - run.trace["busy_s"] / run.trace["window_s"])
