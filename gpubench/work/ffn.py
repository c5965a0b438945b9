"""Work of the FFN op (dense, GELU, dense; K2 on the card, K2b for its
backward): operations and bytes from its shapes.

Each input byte is counted read once and each output byte written once:
the activations in bf16, the fp32 weights and biases the op takes, and,
when it is differentiated, the upstream gradient, the input's gradient
(bf16) and the fp32 weight and bias gradients. Operations are the two
products of the forward (4·N·D·F) and the four of the backward
(8·N·D·F), at the bf16 tensor-core rate.
"""

TARGETS = ["kmbart_tpu_torch.models.bart:ffn"]


def capture(args, kwargs, grad):
    x, w1 = args[0], args[1]
    F, D = w1.shape
    return {"rows": x.numel() // D, "d": D, "f": F, "grad": grad}


def count(call):
    N, D, F = call["rows"], call["d"], call["f"]
    weights = 4 * (2 * D * F + F + D)
    nbytes = 2 * N * D * 2 + weights
    flops = 4.0 * N * D * F
    if call["grad"]:
        nbytes += 2 * N * D * 2 + weights
        flops += 8.0 * N * D * F
    return {"bf16_flops": flops, "nbytes": nbytes}
