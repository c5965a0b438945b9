"""The device a library entry point runs on.

The port's entry points (the model constructors, the checkpoint loaders and
the CLIs) run on the card unless the caller asks for the CPU.
"""

import torch


def resolve_device(name):
    """The requested device; a CUDA device without a card raises (there is
    no quiet switch to the CPU)."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {str(name)!r} requested but no CUDA device is available "
                           "(pass device='cpu', or --device cpu, to run on the host)")
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device
