"""Model-level ``generate``: the generation front end re-exported, as the
JAX package attaches it to its task models
(kmbart_tpu/models/generation_api.py)."""

from kmbart_tpu_torch.generation.api import generate  # noqa: F401
