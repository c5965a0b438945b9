"""Greedy and sampling decode loop.

Counterpart of kmbart_tpu/generation/decode.py (HF 3.0.2
``_generate_no_beam_search``): the raw logits are postprocessed in place
(no log_softmax, no forced BOS/EOS), then either the argmax is taken or a
token is drawn (temperature, then top-k/top-p, from ``generator``); rows
pad after their EOS, and the loop stops when every row has finished. It
runs on the beam-stationary cache with one beam: every position lives in
slot 0, so the ancestry stays all zeros.

Over a split model (``tp``, parallel/tp.py ``TensorParallel``) each rank
runs the decode step on its part and the logits are whole on every rank;
the ranks of a model group agree the stop test (``TensorParallel.any``).
``noise_rows`` = (rows of the whole batch, this block's first row) makes a
data rank draw the whole batch's noise and keep its own rows.
"""

import torch

from kmbart_tpu_torch.generation import logits as lp
from kmbart_tpu_torch.models import bart
from kmbart_tpu_torch.utils.profiling import span


def greedy_or_sample_loop(model, cfg, enc_hidden, enc_mask, generator=None, *, max_length,
                          min_length, do_sample=False, temperature=1.0, top_k=0, top_p=1.0,
                          repetition_penalty, no_repeat_ngram_size, bad_words_ids,
                          pad_token_id, eos_token_id, decoder_start_token_id, tp=None,
                          noise_rows=None):
    """Returns (tokens [B, max_length], the step count at loop exit, which
    is the HF output width)."""
    trunk = model.model
    dev = enc_hidden.device
    B, L = enc_hidden.shape[0], max_length
    tokens = torch.full((B, L), pad_token_id, dtype=torch.long, device=dev)
    tokens[:, 0] = decoder_start_token_id
    caches = bart.init_decode_cache_layers(trunk, cfg, enc_hidden, L, num_beams=1, tp=tp)
    ancestry = torch.zeros((B, L), dtype=torch.int32, device=dev)
    unfinished = torch.ones((B,), dtype=torch.long, device=dev)
    cur_len = 1

    def going():
        with span("sync.stop_test"):
            live = unfinished.max() > 0
            return bool(live) if tp is None else tp.any(live)

    while cur_len < L and going():
        prev = tokens[:, cur_len - 1:cur_len]
        hidden = bart.decode_step_stationary(trunk, cfg, prev, caches, cur_len - 1,
                                             ancestry, enc_mask, num_beams=1, tp=tp)
        scores = bart.lm_logits(trunk, cfg, hidden, model.final_logits_bias)[:, 0, :]
        scores = lp.postprocess_scores(
            scores, tokens, cur_len, repetition_penalty=repetition_penalty,
            no_repeat_ngram_size=no_repeat_ngram_size, bad_words_ids=bad_words_ids,
            min_length=min_length, eos_token_id=eos_token_id)
        if do_sample:
            if temperature != 1.0:
                scores = scores / temperature
            if top_k and top_k > 0:
                # the draw covers the k candidates only (lp.sample_from_top_k)
                next_token = lp.sample_from_top_k(scores, top_k, top_p, generator,
                                                  rows=noise_rows)
            else:
                scores = lp.top_k_top_p_filtering(scores, top_k, top_p)
                next_token = lp.categorical(scores, generator, noise_rows)
        else:
            next_token = torch.argmax(scores, dim=-1)   # first maximum wins
        if eos_token_id is not None:
            to_add = next_token * unfinished + pad_token_id * (1 - unfinished)
            unfinished = unfinished * (to_add != eos_token_id).long()
        else:
            to_add = next_token
        tokens[:, cur_len] = to_add
        cur_len += 1
    return tokens, cur_len
