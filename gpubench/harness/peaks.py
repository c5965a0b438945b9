"""Published peaks of the card the benchmark runs on.

NVIDIA H100 SXM5 80 GB (NVIDIA's data sheet, dense rates without sparsity,
at its full 700 W): bf16 and fp16 on the tensor cores, TF32, float32 outside
the tensor cores, and HBM3 bandwidth. Rooflines and MFU are shares of
these; a card set below 700 W reaches less, and the run prints its limit.
"""

PEAKS = {
    "NVIDIA H100 80GB HBM3": {"bf16_flops": 989e12, "tf32_flops": 494.7e12,
                              "f32_flops": 67e12, "hbm_bytes": 3.35e12},
}


def peaks_for(kind):
    """The peaks of the card named ``kind``; an unknown card raises, so no
    share is ever read against another card's peak."""
    if kind not in PEAKS:
        raise KeyError(f"no published peaks for {kind!r}")
    return PEAKS[kind]


def bound_s(peaks, bf16_flops=0.0, f32_flops=0.0, nbytes=0.0):
    """The least time the card could take: the larger of the operations at
    their type's peak and the bytes at the memory's."""
    ops = bf16_flops / peaks["bf16_flops"] + f32_flops / peaks["f32_flops"]
    return max(ops, nbytes / peaks["hbm_bytes"])
