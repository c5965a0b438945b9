"""Work of the LM head with its cross-entropy (K7 + K8, or K9 + K10 in
mode "nomat"): operations and bytes from its shapes.

The work is the product the loss needs, whatever a mode recomputes: the
projection h·Wᵀ (2·N·D·V), and when differentiated dh = dlogits·W and
dW = dlogitsᵀ·h (4·N·D·V), at the bf16 rate. Bytes: the bf16 hidden rows,
the fp32 tied embedding, the int64 labels and the fp32 bias read once;
when differentiated, the bf16 dh and the fp32 dW written once. The logits
are the op's own and are not counted.
"""

TARGETS = ["kmbart_tpu_torch.models.conditional:lm_cross_entropy",
           "kmbart_tpu_torch.models.pretraining:lm_cross_entropy"]


def capture(args, kwargs, grad):
    model, hidden = args[0], args[2]
    V, D = model.shared.weight.shape
    return {"rows": hidden.numel() // D, "d": D, "v": V, "grad": grad}


def count(call):
    N, D, V = call["rows"], call["d"], call["v"]
    nbytes = 2 * N * D + 4 * V * D + 8 * N + 4 * V
    flops = 2.0 * N * D * V
    if call["grad"]:
        nbytes += 2 * N * D + 4 * V * D
        flops += 4.0 * N * D * V
    return {"bf16_flops": flops, "nbytes": nbytes}
