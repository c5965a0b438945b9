"""Write a checkpoint in the reference's PyTorch format.

Counterpart of kmbart_tpu/checkpoint/torch_export.py: ``pytorch_model.bin``
(the model's HF-named state dict, fp32, [out, in] weights) and
``config.json``, the layout of the reference's ``save_pretrained``. The
state dict is the port's own, so it keeps the
``model.{encoder,decoder}.layer_norm.*`` tensors of a config that has them
(the JAX exporter leaves them out). ``checkpoint/io.py load_pretrained``
reads the directory back, as does the JAX package's.
"""

import json
import os

import torch

from kmbart_tpu_torch.checkpoint.io import CONFIG_NAME, TORCH_WEIGHTS_NAME


def save_torch_pretrained(path, config, model):
    """Write ``path/pytorch_model.bin`` and ``path/config.json``."""
    os.makedirs(path, exist_ok=True)
    # each tensor with a storage of its own: the tied embedding copies are
    # written out in full, as the reference's state dict holds them
    sd = {k: v.detach().to("cpu", torch.float32).clone().contiguous()
          for k, v in model.state_dict().items()}
    torch.save(sd, os.path.join(path, TORCH_WEIGHTS_NAME))
    with open(os.path.join(path, CONFIG_NAME), "w") as f:
        json.dump(config.to_dict(), f, indent=2, sort_keys=True)
