"""Work of the decode step's self-attention over the beam-stationary cache
(K3): operations and bytes from its shapes and its ancestry.

One call attends each of the B·K beam rows over the n = cache_index + 1
positions of its history. Bytes: the bf16 queries and the int32 ancestry
read, the fp32 output written, and each K and V row (beam slot, position)
that some beam of the sample descends through read once, whatever the
kernel reads again. Operations: the scores and P·V, 4·B·K·n·D at the bf16
rate.
"""

import torch

TARGETS = ["kmbart_tpu_torch.models.bart:beam_gather_attention"]


def capture(args, kwargs, grad):
    q, k_cache, ancestry, cache_index = args[0], args[1], args[3], args[4]
    B, K, _, D = k_cache.shape
    # the decode loop builds a new ancestry each step and never writes an
    # old one again, so holding it keeps this call's history
    return {"b": B, "k": K, "d": D, "n": int(cache_index) + 1, "ancestry": ancestry,
            "ring": kwargs.get("valid_counts") is not None}


def count(call):
    if call["ring"]:
        return None
    B, K, D, n = call["b"], call["k"], call["d"], call["n"]
    a = call["ancestry"][:, :n].long().reshape(B, K, n)
    used = torch.zeros((B, K, n), dtype=torch.bool, device=a.device).scatter_(1, a, True)
    rows = int(used.sum())
    nbytes = 2 * B * K * D + 4 * B * K * n + 4 * B * K * D + 2 * 2 * rows * D
    return {"bf16_flops": 4.0 * B * K * n * D, "nbytes": nbytes}
