"""The COMET knowledge generator (counterpart of kmbart_tpu/knowledge)."""
