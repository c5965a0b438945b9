"""Tensor ops of the port. Four of them wrap hand-written Hopper kernels
(``csrc/``); each wrapper counts its kernel launches in ``.launches``."""


def kernel_wrappers():
    """{name: wrapper} for the four kernels of the generation path."""
    from kmbart_tpu_torch.ops.beam_attention import beam_gather_attention
    from kmbart_tpu_torch.ops.ffn import fused_ffn
    from kmbart_tpu_torch.ops.train_attention import train_attention_flat
    from kmbart_tpu_torch.ops.vocab_stats import chunk_stats
    return {"train_attention": train_attention_flat, "ffn": fused_ffn,
            "beam_attention": beam_gather_attention, "vocab_stats": chunk_stats}


def launch_counts():
    return {name: fn.launches for name, fn in kernel_wrappers().items()}


def reset_launch_counts():
    for fn in kernel_wrappers().values():
        fn.launches = 0
