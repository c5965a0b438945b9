"""The beam_attn op's share of its roofline (harness/readers.py roofline_pct)."""

from gpubench.harness.readers import roofline_pct

OPS = ["beam_attn"]


def read(run):
    return roofline_pct(run, "beam_attn")
