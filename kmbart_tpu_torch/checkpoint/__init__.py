"""Checkpoint loading for the port (counterpart of kmbart_tpu/checkpoint)."""
