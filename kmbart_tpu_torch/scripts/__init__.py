"""Data-preparation CLIs: twins of the root scripts/ package, run as ``python -m kmbart_tpu_torch.scripts.<name>``."""
