"""Tensor ops of the port. Twelve of them wrap hand-written Hopper kernels
(``csrc/``); each wrapper counts its kernel launches in the program's
counters (utils/profiling.py ``count``) as ``launch.<name>``, K1's wrappers
those on their plan's "legacy" route also as ``launch.<name>_legacy``,
K3's wrapper its ring-mode launches also as ``launch.beam_attention_ring``
and K4's wrapper the launches of its second stage, the merge of the rows'
top-k, as ``launch.vocab_topk_merge``."""

from kmbart_tpu_torch.utils import profiling

# K1 and K2 forward and backward, K3 and K4 (statistics and top-k) of the
# generation path, K7 and K8 (mode "fwdbwd") and K9 and K10 (mode "nomat")
# of the LM loss, K11 for long sequences, K12 (AdamW); then the launches
# counted apart
LAUNCHES = ("train_attention", "train_attention_bwd", "ffn", "ffn_bwd", "beam_attention",
            "vocab_stats_topk", "lm_ce_fwd", "lm_ce_bwd", "lm_ce_fwd_stats",
            "lm_ce_recompute_bwd", "flash_attention", "adamw", "train_attention_legacy",
            "train_attention_bwd_legacy", "beam_attention_ring", "vocab_topk_merge")


def launch_counts():
    """{name: launches}, with K1's and K1b's launches on PR 4's kernels as
    "train_attention_legacy" and "train_attention_bwd_legacy", K3's ring-mode
    launches as "beam_attention_ring" and K4's merges as "vocab_topk_merge"."""
    return {name: profiling.counters.get("launch." + name, 0) for name in LAUNCHES}


def reset_launch_counts():
    for name in LAUNCHES:
        profiling.counters.pop("launch." + name, None)
