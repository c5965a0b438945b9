"""Sampling utility.

Counterpart of kmbart_tpu/models/utils.py ``sample_sentence`` (the
reference's src/model/utils.py:6-58): ancestral top-k/top-p sampling that
also returns each sentence's summed log-probability over the filtered
distribution. The decode runs on the beam-stationary cache with one beam,
and the draws come from ``generator`` (``generation/logits.py _gumbel``).
"""

import torch

from kmbart_tpu_torch.generation import logits as lp
from kmbart_tpu_torch.models import bart
from kmbart_tpu_torch.ops.vocab_stats import exact_top_k


@torch.no_grad()
def sample_sentence(model, cfg, input_ids, image_features, attention_mask, tokenizer,
                    top_k=50, top_p=1.0, max_length=20, generator=None):
    """Returns numpy (decoder_input_ids [B, max_length], sum_logprobs [B, 1])."""
    trunk = model.model
    dev = model.final_logits_bias.device
    input_ids = torch.as_tensor(input_ids, device=dev).long()
    attention_mask = torch.as_tensor(attention_mask, device=dev).long()
    if image_features is not None:
        image_features = torch.as_tensor(image_features, device=dev).float()
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    bos, eos, pad = tokenizer.bos_token_id, tokenizer.eos_token_id, tokenizer.pad_token_id
    L = max_length
    enc = bart.encode(trunk, cfg, input_ids, image_features, attention_mask)
    B = input_ids.shape[0]
    tokens = torch.full((B, L), pad, dtype=torch.long, device=dev)
    tokens[:, 0] = bos
    caches = bart.init_decode_cache_layers(trunk, cfg, enc, L, num_beams=1)
    ancestry = torch.zeros((B, L), dtype=torch.int32, device=dev)
    unfinished = torch.ones((B,), dtype=torch.long, device=dev)
    logprobs = torch.zeros((B, L), device=dev)
    sent_len = torch.full((B,), L, dtype=torch.long, device=dev)
    cur_len = 1
    while cur_len < L and bool(unfinished.max() > 0):
        hidden = bart.decode_step_stationary(trunk, cfg, tokens[:, cur_len - 1:cur_len],
                                             caches, cur_len - 1, ancestry, attention_mask,
                                             num_beams=1)
        raw = bart.lm_logits(trunk, cfg, hidden, model.final_logits_bias)[:, 0, :]
        if top_k and top_k > 0:
            # the draw and the token's log-prob over the filtered
            # distribution both come from the [B, k] candidates
            vals, idx = exact_top_k(raw, top_k)
            if top_p < 1.0:
                vals = torch.where(lp._top_p_remove(vals, top_p, 1), lp.NEG_INF, vals)
            slot = lp.categorical(vals, generator)
            next_token = torch.gather(idx, 1, slot[:, None])[:, 0]
            tok_lp = torch.gather(torch.log_softmax(vals, dim=-1), 1, slot[:, None])[:, 0]
        else:
            filtered = lp.top_k_top_p_filtering(raw, top_k, top_p)
            next_token = lp.categorical(filtered, generator)
            tok_lp = torch.gather(torch.log_softmax(filtered, dim=-1), 1,
                                  next_token[:, None])[:, 0]
        logprobs[:, cur_len] = torch.where(unfinished > 0, tok_lp, 0.0)
        to_add = next_token * unfinished + pad * (1 - unfinished)
        eos_now = (to_add == eos) & (unfinished > 0)
        sent_len = torch.where(eos_now, cur_len + 1, sent_len)
        unfinished = unfinished * (to_add != eos).long()
        tokens[:, cur_len] = to_add
        cur_len += 1
    # nothing at or after a sentence's end counts (src/model/utils.py:53-54)
    pos = torch.arange(L, device=dev)[None, :]
    logprobs = torch.where(pos >= sent_len[:, None], 0.0, logprobs)
    return (tokens.to(torch.int32).cpu().numpy(),
            logprobs.sum(dim=1, keepdim=True).cpu().numpy())
