"""Models of the port (counterparts of kmbart_tpu/models)."""
