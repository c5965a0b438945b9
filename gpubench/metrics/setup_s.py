"""Set-up: from the process's start to the first timed call (imports,
kernel builds on a cold checkout, weights, the feed's pool, warm-up and
the check's first steps)."""


def read(run):
    return run.setup_s
