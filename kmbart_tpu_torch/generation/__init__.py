"""Generation for the port (counterpart of kmbart_tpu/generation)."""
