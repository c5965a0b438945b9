"""Train state: the model, the optimizer state and the step counter.

Counterpart of kmbart_tpu/training/state.py. ``params`` is the model
itself: the optimizer updates its tensors in place. ``step`` counts train
steps on the host (it seeds each step's dropout generator);
``opt_state.step`` counts the updates taken, on the device.
"""

from typing import Any, NamedTuple

from kmbart_tpu_torch.training.adamw import AdamWState


def model_tensors(model):
    """{name: tensor} the optimizer updates: every parameter of a
    conditional model, and its ``final_logits_bias`` buffer, which is a
    leaf of the JAX parameters that never gets a gradient."""
    tensors = dict(model.named_parameters())
    tensors["final_logits_bias"] = model.final_logits_bias
    return tensors


class TrainState(NamedTuple):
    params: Any            # the model (nn.Module)
    opt_state: AdamWState
    step: int

    @classmethod
    def create(cls, model, optimizer):
        return cls(params=model, opt_state=optimizer.init(model_tensors(model)), step=0)
