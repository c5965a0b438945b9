"""Serving: the static coalescing engine, the slot-pool continuous engine
and the HTTP front end (counterpart of kmbart_tpu/serving)."""

from kmbart_tpu_torch.serving.engine import GenerationEngine  # noqa: F401
