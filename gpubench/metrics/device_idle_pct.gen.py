"""The share of the traced window with nothing on the card
(harness/readers.py idle_pct)."""

from gpubench.harness.readers import idle_pct


def read(run):
    return idle_pct(run)
