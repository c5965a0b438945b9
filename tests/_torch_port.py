"""Helpers shared by the PyTorch-port parity tests (tests/test_torch_*.py):
the port's config and model built from the JAX package's, and dtype
plumbing."""

import jax.numpy as jnp
import numpy as np
import torch

from kmbart_tpu_torch.checkpoint.io import load_state_dict, params_from_jax
from kmbart_tpu_torch.config import MultiModalBartConfig as PortConfig
from kmbart_tpu_torch.models.conditional import init_conditional_model

BF16_ULP_AT_1 = 2.0 ** -7


def port_config(cfg):
    """The port's config built from the same dict as ``cfg`` (either
    package's)."""
    return PortConfig.from_dict(cfg.to_dict())


def port_model(params, cfg):
    """The port's model carrying the JAX package's parameters."""
    cfg = port_config(cfg)
    model = init_conditional_model(cfg, device="cpu")
    load_state_dict(model, params_from_jax(params, cfg))
    return model


def to_torch(a, dtype=torch.float32):
    """numpy/JAX array -> torch tensor, rounded to ``dtype`` from fp32 (the
    same round-to-nearest-even as ``jnp.astype``)."""
    return torch.from_numpy(np.array(np.asarray(a, np.float32))).to(dtype)


def to_jax(a, dtype="float32"):
    return jnp.asarray(np.asarray(a, np.float32)).astype(jnp.dtype(dtype))


def to_np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def bf16_tol(ref, ulps=2):
    """``ulps`` bf16 ulps of the reference's largest magnitude (at least 1)."""
    scale = max(1.0, float(np.abs(ref).max()))
    return ulps * 2.0 ** (np.floor(np.log2(scale)) - 7)
