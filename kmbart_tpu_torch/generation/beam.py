"""Beam search over the beam-stationary KV cache.

Counterpart of kmbart_tpu/generation/beam.py (HF 3.0.2
``_generate_beam_search`` semantics: forced BOS/EOS, top-2K candidate
expansion, EOS candidates of rank < K committed into a best-K hypothesis
pool, early stopping, finalisation and the HF output width). The JAX
``while_loop`` becomes a host loop that checks ``done.all()`` once a step.

With every score postprocessor inert (the VCG default) candidates are
chosen on the raw logits: log_softmax is monotonic per row, so each beam's
top-2K survivors are the same, and only they are normalised with the row
logsumexp: one call of the vocab-stats kernel K4 gives both, the
statistics and each row's top-2K (``stats_top_k``). Otherwise the general
path takes log_softmax, the postprocessors, and the top-2K of the flat
[B, K·V] scores (``exact_top_k``). Both route by shape
(``ops/vocab_stats.py``): on the card a k up to 1024 takes K4's
selection, a larger one the stable sort. The small selections (the hypothesis pool, the merge of the beams'
candidates, the Gumbel draw over [B, K·kk]) stay on the stable sort, as
the JAX package leaves them to ``lax.top_k``.

Sampling (HF: beam scores start at zero, no forced BOS/EOS, temperature)
draws the 2K candidates without replacement by a Gumbel top-2K. With a
top-k it draws over each row's top-k survivors ([B, K·kk] noise): on the
fast path the survivors of the raw logits, K4's top-k normalised with
its logsumexp, else the top-k of the postprocessed scores; top-p then
keeps at least 2 tokens a row. Without a top-k it draws over the filtered
[B, K·V] scores. The noise is ``logits._gumbel``'s (``logits.gumbel_rows``:
a data rank decoding a block draws the whole batch's and keeps its rows).

Over a split model (``tp``) each rank runs the decode step on its part;
K4 and the top-2K select run on the logits, whole on every rank (the LM
head is not split), and the ranks of a model group agree the stop test.
"""

import torch

from kmbart_tpu_torch.generation import logits as lp
from kmbart_tpu_torch.models import bart
from kmbart_tpu_torch.ops.topk import top_k as sort_top_k
from kmbart_tpu_torch.ops.vocab_stats import exact_top_k, logsumexp_from_stats, stats_top_k
from kmbart_tpu_torch.utils.profiling import span

NEG_1E9 = -1e9

# A hook for holding one decode to another: when a list, each step of the
# fast selection path appends its candidates and every row's top-2K scores,
# and the finalisation the hypotheses' scores, on the host. None (the
# default) records nothing and adds no host sync.
STEP_TRACE = None


def _merge_pool(hyp, cand_scores, cand_tokens, cand_lens, K):
    """Keep the best K of (pool ∪ candidates); -inf score = no candidate.
    hyp: (tokens [B, K, L], lens [B, K], scores [B, K], count [B], worst [B]).
    Equivalent to BeamHypotheses.add over the candidates in any order."""
    hyp_tokens, hyp_lens, hyp_scores, hyp_count, _ = hyp
    L = hyp_tokens.shape[2]
    all_scores = torch.cat([hyp_scores, cand_scores], dim=1)
    all_tokens = torch.cat([hyp_tokens, cand_tokens], dim=1)
    all_lens = torch.cat([hyp_lens, cand_lens], dim=1)
    top_scores, top_idx = sort_top_k(all_scores, K)
    new_tokens = torch.gather(all_tokens, 1, top_idx[..., None].expand(-1, -1, L))
    new_lens = torch.gather(all_lens, 1, top_idx)
    n_new = (cand_scores > NEG_1E9 / 2).sum(dim=1)
    new_count = torch.clamp(hyp_count + n_new, max=K)
    worst_idx = torch.clamp(new_count - 1, 0, K - 1)
    new_worst = torch.gather(top_scores, 1, worst_idx[:, None])[:, 0]
    new_worst = torch.where(new_count > 0, new_worst, 1e9)
    return new_tokens, new_lens, top_scores, new_count, new_worst


def fast_candidates(logits, beam_scores, K, trace=None):
    """The top-2K candidates of [B, K·V] normalised scores, chosen on the
    raw logits [B·K, V] (inert postprocessors, no sampling): each beam's
    top-2K and K4's logsumexp from one K4 call, the top-2K normalised,
    then merged in flat-index order. Returns (scores [B, 2K], flat indices
    [B, 2K]); ``trace``, a list, gets the step's numbers (STEP_TRACE)."""
    BK, V = logits.shape
    B = BK // K
    cm, es, row_vals, row_idx = stats_top_k(logits.contiguous(), 2 * K)
    lse = logsumexp_from_stats(cm, es)
    norm = (row_vals - lse[:, None]) + beam_scores.reshape(BK, 1)
    beam_base = (torch.arange(K, device=logits.device) * V)[None, :, None]
    flat_idx = (row_idx.reshape(B, K, 2 * K) + beam_base).reshape(B, 2 * K * K)
    cand_scores, pos = sort_top_k(norm.reshape(B, 2 * K * K), 2 * K)
    cand_idx = torch.gather(flat_idx, 1, pos)
    if trace is not None:
        trace.append({"cand_scores": cand_scores.cpu(), "cand_idx": cand_idx.cpu(),
                      "row_scores": norm.reshape(B, 2 * K * K).cpu(),
                      "row_idx": flat_idx.cpu()})
    return cand_scores, cand_idx


def beam_front(cand_scores, cand_tok, cand_beam, is_eos, K):
    """The next beam front: the first K non-EOS candidates of each sample.
    Returns (scores, tokens, parent beams), each [B, K]."""
    B = cand_scores.shape[0]
    dev = cand_scores.device
    non_eos = ~is_eos
    slot = torch.cumsum(non_eos.long(), dim=1) - 1
    take = non_eos & (slot < K)
    wslot = torch.clamp(slot, 0, K - 1)
    # each (b, wslot) pair receives exactly one candidate that is taken
    scores = torch.zeros((B, K), device=dev).scatter_add_(
        1, wslot, torch.where(take, cand_scores, 0.0))
    tokens = torch.zeros((B, K), dtype=torch.long, device=dev).scatter_add_(
        1, wslot, torch.where(take, cand_tok, 0))
    parents = torch.zeros((B, K), dtype=torch.long, device=dev).scatter_add_(
        1, wslot, torch.where(take, cand_beam, 0))
    return scores, tokens, parents


def _sample_candidates(logits, scores, beam_scores, generator, *, K, top_k, top_p, fast,
                       noise_rows=None):
    """2K candidates drawn without replacement (Gumbel top-2K), sorted by
    score descending. ``logits`` [B·K, V] are the raw (temperature-scaled)
    logits, used on the fast path; ``scores`` the postprocessed
    log-probs otherwise. Returns (scores [B, 2K], flat indices [B, 2K])."""
    BK, V = logits.shape
    B = BK // K
    dev = logits.device
    if top_k and top_k > 0:
        # restrict each row to its top-k before the draw: tokens the filter
        # masks carry zero probability either way
        kk = max(top_k, 2)
        if fast:
            # the top-k of the raw logits is the top-k of the normalised
            # scores; normalise the survivors with K4's logsumexp, both from
            # one K4 call (a kk over 1024: K4's statistics, the sort's top-k)
            cm, es, raw_vals, vidx = stats_top_k(logits.contiguous(), kk)
            lse = logsumexp_from_stats(cm, es)
            vals = (raw_vals - lse[:, None]) + beam_scores.reshape(BK, 1)
        else:
            vals, vidx = exact_top_k(scores + beam_scores.reshape(BK, 1), kk)
        if top_p < 1.0:
            vals = torch.where(lp._top_p_remove(vals, top_p, 2), NEG_1E9, vals)
        beam_of_row = (torch.arange(BK, device=dev) % K)[:, None]
        flat = vals.reshape(B, K * kk)
        flat_gidx = (beam_of_row * V + vidx).reshape(B, K * kk)
        noise = lp.gumbel_rows(flat.shape, generator, dev, noise_rows)
        noisy = torch.where(flat > NEG_1E9 / 2, flat + noise, -float("inf"))
        _, pos = sort_top_k(noisy, 2 * K)
        cand_scores = torch.gather(flat, 1, pos)
        cand_idx = torch.gather(flat_gidx, 1, pos)
    else:
        filtered = lp.top_k_top_p_filtering(scores + beam_scores.reshape(BK, 1), top_k,
                                            top_p, min_tokens_to_keep=2)
        flat = filtered.reshape(B, K * V)
        # Gumbel top-k == multinomial sampling without replacement
        noise = lp.gumbel_rows(flat.shape, generator, dev, noise_rows)
        noisy = torch.where(flat > NEG_1E9 / 2, flat + noise, -float("inf"))
        _, cand_idx = exact_top_k(noisy, 2 * K)
        cand_scores = torch.gather(flat, 1, cand_idx)
    order = torch.sort(cand_scores, dim=1, descending=True, stable=True).indices
    return torch.gather(cand_scores, 1, order), torch.gather(cand_idx, 1, order)


def beam_search_loop(model, cfg, enc_hidden, enc_mask, generator=None, *, batch_size,
                     num_beams, max_length, min_length, length_penalty, early_stopping,
                     repetition_penalty, no_repeat_ngram_size, bad_words_ids,
                     pad_token_id, eos_token_id, decoder_start_token_id,
                     num_return_sequences, do_sample=False, temperature=1.0, top_k=0,
                     top_p=1.0, tp=None, noise_rows=None):
    """enc_hidden / enc_mask are per sample (not beam-expanded): a sample's
    K beams share its encoder states and cross K/V. ``tp``: this rank's
    part of a split model; ``noise_rows``: (samples of the whole batch,
    this block's first sample) for sampling on a data rank.
    Returns (tokens [B·num_return_sequences, max_length], HF output width)."""
    trunk = model.model
    dev = enc_hidden.device
    B, K = batch_size, num_beams
    BK, V, L = B * K, cfg.vocab_size, max_length
    inert = (repetition_penalty == 1.0 and no_repeat_ngram_size == 0
             and bad_words_ids is None and min_length == 0)
    fast_select = inert and not do_sample
    fast_sample = inert and do_sample and bool(top_k) and top_k > 0

    tokens = torch.full((BK, L), pad_token_id, dtype=torch.long, device=dev)
    tokens[:, 0] = decoder_start_token_id
    caches = bart.init_decode_cache_layers(trunk, cfg, enc_hidden, L, num_beams=K, tp=tp)
    ancestry = torch.zeros((BK, L), dtype=torch.int32, device=dev)
    own_slot = (torch.arange(BK, device=dev) % K).to(torch.int32)
    if do_sample:
        beam_scores = torch.zeros((B, K), device=dev)   # HF: zeros when sampling
    else:
        beam_scores = torch.full((B, K), NEG_1E9, device=dev)
        beam_scores[:, 0] = 0.0
    done = torch.zeros((B,), dtype=torch.bool, device=dev)
    hyp = (torch.full((B, K, L), pad_token_id, dtype=torch.long, device=dev),
           torch.zeros((B, K), dtype=torch.long, device=dev),
           torch.full((B, K), NEG_1E9, device=dev),
           torch.zeros((B,), dtype=torch.long, device=dev),
           torch.full((B,), 1e9, device=dev))
    b_idx = torch.arange(B, device=dev)
    parent = torch.arange(BK, device=dev)

    def length_norm(cur_len):
        c = torch.tensor(float(cur_len), device=dev)
        return c if length_penalty == 1.0 else c ** length_penalty

    def going():
        with span("sync.stop_test"):
            live = ~done.all()
            return bool(live) if tp is None else tp.any(live)

    cur_len = 1
    while cur_len < L and going():
        with span("beam.step"):
            prev = tokens[:, cur_len - 1:cur_len]
            # resolve each beam's history through its parent's ancestry (the
            # cache never moves), then claim the own slot for this step's row
            ancestry = ancestry[parent]
            ancestry[:, cur_len - 1] = own_slot
            hidden = bart.decode_step_stationary(trunk, cfg, prev, caches, cur_len - 1,
                                                 ancestry, enc_mask, num_beams=K, tp=tp)
            logits = bart.lm_logits(trunk, cfg, hidden, model.final_logits_bias)[:, 0, :]
            if do_sample:
                if temperature != 1.0:
                    logits = logits / temperature
            else:
                # adjust_logits_during_generation: greedy beam search only
                logits = lp.maybe_force_bos_eos(logits, cur_len, L, cfg.bos_token_id,
                                                eos_token_id)
            scores = None
            if not (fast_select or fast_sample):
                scores = torch.log_softmax(logits, dim=-1)
                scores = lp.postprocess_scores(
                    scores, tokens, cur_len, repetition_penalty=repetition_penalty,
                    no_repeat_ngram_size=no_repeat_ngram_size, bad_words_ids=bad_words_ids,
                    min_length=min_length, eos_token_id=eos_token_id)
            if fast_select:
                cand_scores, cand_idx = fast_candidates(logits, beam_scores, K, trace=STEP_TRACE)
            elif do_sample:
                cand_scores, cand_idx = _sample_candidates(
                    logits, scores, beam_scores, generator, K=K, top_k=top_k, top_p=top_p,
                    fast=fast_sample, noise_rows=noise_rows)
            else:
                flat = (scores + beam_scores.reshape(BK, 1)).reshape(B, K * V)
                cand_scores, cand_idx = exact_top_k(flat, 2 * K)

            cand_beam = cand_idx // V
            cand_tok = cand_idx % V
            is_eos = (cand_tok == eos_token_id) if eos_token_id is not None \
                else torch.zeros_like(cand_tok, dtype=torch.bool)
            lp_denorm = length_norm(cur_len)

            # ---- commit finished hypotheses (rank < K EOS candidates) ----
            if eos_token_id is not None:
                eligible = is_eos[:, :K] & ~done[:, None]
                hyp_cand_scores = torch.where(eligible, cand_scores[:, :K] / lp_denorm,
                                              -float("inf"))
                parent_tokens = torch.gather(tokens.reshape(B, K, L), 1,
                                             cand_beam[:, :K, None].expand(-1, -1, L))
                hyp_cand_lens = torch.where(eligible, cur_len, 0)
                hyp = _merge_pool(hyp, hyp_cand_scores, parent_tokens, hyp_cand_lens, K)
            hyp_count, worst = hyp[3], hyp[4]

            # ---- the next beam front: the first K non-EOS candidates ----
            nb_scores, nb_tokens, nb_parents = beam_front(cand_scores, cand_tok, cand_beam,
                                                          is_eos, K)
            # done batches emit (0, pad, 0)
            nb_scores = torch.where(done[:, None], 0.0, nb_scores)
            nb_tokens = torch.where(done[:, None], pad_token_id, nb_tokens)
            nb_parents = torch.where(done[:, None], 0, nb_parents)

            best_sum = cand_scores[:, 0]
            if early_stopping:
                newly_done = hyp_count >= K
            else:
                newly_done = (hyp_count >= K) & (worst >= best_sum / lp_denorm)
            done = done | newly_done

            parent = (b_idx[:, None] * K + nb_parents).reshape(BK)
            tokens = tokens[parent]
            tokens[:, cur_len] = nb_tokens.reshape(BK)
            beam_scores = nb_scores
            cur_len += 1

    # ---- finalise: unfinished batches contribute their live beams ----
    lp_denorm = length_norm(cur_len)
    final_scores = torch.where(~done[:, None], beam_scores / lp_denorm, -float("inf"))
    final_lens = torch.where(~done[:, None], cur_len, 0).expand(B, K)
    hyp = _merge_pool(hyp, final_scores, tokens.reshape(B, K, L), final_lens, K)
    hyp_tokens, hyp_lens = hyp[0], hyp[1]
    if STEP_TRACE is not None:
        STEP_TRACE.append({"final_scores": hyp[2].cpu()})

    R = num_return_sequences
    out = hyp_tokens[:, :R].reshape(B * R, L)
    lens = hyp_lens[:, :R].reshape(B * R)
    if eos_token_id is not None:
        pos = torch.arange(L, device=dev)[None, :]
        append_eos = (pos == lens[:, None]) & (lens[:, None] < L)
        out = torch.where(append_eos, eos_token_id, out)
        out = torch.where(pos > lens[:, None], pad_token_id, out)
    with span("sync.width"):
        eff_len = min(int(lens.max()) + 1, L)
    return out, eff_len
