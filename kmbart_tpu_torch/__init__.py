"""KM-BART in PyTorch, with hand-written Hopper kernels.

The port of ``kmbart_tpu`` (JAX on a TPU) to PyTorch and CUDA on an NVIDIA
H100. It mirrors the JAX package's layout and imports nothing of it, nor
``jax``: the framework-free modules (``config``, ``data``, ``eval``,
``utils``, ``_native``) are its own copies, under the same names. The kernels the
TPU ran in Pallas are CUDA C++ under ``csrc/``, built with ``nvcc`` at first
use (ops/_cuda.py); on CPU tensors every kernel wrapper runs its plain
PyTorch version instead.

Ported so far: VCG conditional generation (greedy and beam search, and
sampling from a ``torch.Generator``) with the ``vcg_generate`` CLI
(``python -m kmbart_tpu_torch.vcg_generate``) and the ``vcg_eval`` CLI;
VCG fine-tuning (the loss, AdamW, the train step, the epoch and validation
loops, checkpoints in the JAX package's format and writing the reference's
``pytorch_model.bin``) with the ``vcg_train`` CLI (``python -m
kmbart_tpu_torch.vcg_train``); multi-task pretraining (the pretraining
heads and losses, the LM loss with or without stored logits, the flash
attention for long captions) with the ``pretrain`` CLI (``python -m
kmbart_tpu_torch.pretrain``); and serving (the static and the continuous
slot-pool engine behind an HTTP server) with the ``serve`` CLI (``python -m
kmbart_tpu_torch.serve``).
"""

__version__ = "0.1.0"

from kmbart_tpu_torch.config import MultiModalBartConfig  # noqa: F401
