"""The bottom-up-attention feature extractor (counterpart of kmbart_tpu/vision)."""
