"""Tensor ops of the port. Eleven of them wrap hand-written Hopper kernels
(``csrc/``); each wrapper counts its kernel launches in ``.launches``,
K1's wrappers those on PR 4's kernels (their plan's "legacy" route) also in
``.legacy_launches``, K3's wrapper its ring-mode launches also in
``.ring_launches`` and K4's wrapper the launches of its second stage, the
merge of the rows' top-k, in ``.merge_launches``."""


def kernel_wrappers():
    """{name: wrapper} for the kernels: K1 and K2 forward and backward, K3
    and K4 (statistics and top-k) of the generation path, K7 and K8 (mode
    "fwdbwd") and K9 and K10 (mode "nomat") of the LM loss, K11 for long
    sequences."""
    from kmbart_tpu_torch.ops.beam_attention import beam_gather_attention
    from kmbart_tpu_torch.ops.ffn import fused_ffn, fused_ffn_bwd
    from kmbart_tpu_torch.ops.flash_attention import flash_attention
    from kmbart_tpu_torch.ops.lm_ce import (lm_ce_bwd, lm_ce_fwd, lm_ce_fwd_stats,
                                            lm_ce_recompute_bwd)
    from kmbart_tpu_torch.ops.train_attention import train_attention_bwd, train_attention_flat
    from kmbart_tpu_torch.ops.vocab_stats import chunk_stats_topk
    return {"train_attention": train_attention_flat, "train_attention_bwd": train_attention_bwd,
            "ffn": fused_ffn, "ffn_bwd": fused_ffn_bwd,
            "beam_attention": beam_gather_attention, "vocab_stats_topk": chunk_stats_topk,
            "lm_ce_fwd": lm_ce_fwd, "lm_ce_bwd": lm_ce_bwd,
            "lm_ce_fwd_stats": lm_ce_fwd_stats, "lm_ce_recompute_bwd": lm_ce_recompute_bwd,
            "flash_attention": flash_attention}


def launch_counts():
    """{name: launches}, with K1's and K1b's launches on PR 4's kernels as
    "train_attention_legacy" and "train_attention_bwd_legacy", K3's ring-mode
    launches as "beam_attention_ring" and K4's merges as "vocab_topk_merge"."""
    wrappers = kernel_wrappers()
    counts = {name: fn.launches for name, fn in wrappers.items()}
    for name in ("train_attention", "train_attention_bwd"):
        counts[name + "_legacy"] = wrappers[name].legacy_launches
    counts["beam_attention_ring"] = wrappers["beam_attention"].ring_launches
    counts["vocab_topk_merge"] = wrappers["vocab_stats_topk"].merge_launches
    return counts


def reset_launch_counts():
    for fn in kernel_wrappers().values():
        fn.launches = 0
    for name in ("train_attention", "train_attention_bwd"):
        kernel_wrappers()[name].legacy_launches = 0
    kernel_wrappers()["beam_attention"].ring_launches = 0
    kernel_wrappers()["vocab_stats_topk"].merge_launches = 0
