"""The lm_ce op's share of its roofline (harness/readers.py roofline_pct)."""

from gpubench.harness.readers import roofline_pct

OPS = ["lm_ce"]


def read(run):
    return roofline_pct(run, "lm_ce")
