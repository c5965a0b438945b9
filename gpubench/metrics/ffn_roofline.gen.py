"""The ffn op's share of its roofline (harness/readers.py roofline_pct)."""

from gpubench.harness.readers import roofline_pct

OPS = ["ffn"]


def read(run):
    return roofline_pct(run, "ffn")
