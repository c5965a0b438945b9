"""Logits processors for decoding.

Counterpart of kmbart_tpu/generation/logits.py: ``force_token`` and
``maybe_force_bos_eos`` (HF 3.0.2 adjust_logits_during_generation),
``postprocess_scores`` with its helpers (repetition penalty,
no-repeat-ngram, bad words, min-length EOS mask), and the sampling filters
``top_k_top_p_filtering`` and ``sample_from_top_k``. ``tokens`` is the
preallocated [B, max_len] buffer and ``cur_len`` a Python int: the port's
decode loops run on the host.

Every random draw of the sampling paths is Gumbel noise from ``_gumbel``,
taken from an explicit ``torch.Generator``: a categorical draw is the
argmax of the logits plus that noise, as ``jax.random.categorical``
computes it. The tests replace ``_gumbel`` to feed the port and the JAX
package the same noise.
"""

import torch

from kmbart_tpu_torch.ops.vocab_stats import exact_top_k

NEG_INF = -float("inf")


def _gumbel(shape, generator, device):
    """Standard Gumbel noise of ``shape`` (fp32), -log(-log(u)) with u
    uniform in [tiny, 1), as ``jax.random.gumbel`` draws it."""
    u = torch.rand(shape, generator=generator, device=device)
    u = u.clamp_(min=torch.finfo(torch.float32).tiny)
    return -torch.log(-torch.log(u))


def gumbel_rows(shape, generator, device, rows=None):
    """``_gumbel`` noise of ``shape`` [n, ...]. With ``rows`` = (total,
    offset): rows [offset, offset + n) of a [total, ...] draw. A data rank
    decoding a block of a batch draws the whole batch's noise and keeps
    its own rows, so that each sample gets the noise one process draws for
    it from the same generator."""
    if rows is None:
        return _gumbel(shape, generator, device)
    total, offset = rows
    return _gumbel((total, *shape[1:]), generator, device)[offset:offset + shape[0]]


def categorical(logits, generator, rows=None):
    """One draw per row from softmax(logits): the first argmax of logits
    plus Gumbel noise (-inf entries are never drawn); ``rows`` as in
    ``gumbel_rows``."""
    noise = gumbel_rows(logits.shape, generator, logits.device, rows)
    return torch.argmax(logits + noise, dim=-1)


def force_token(scores, token_id):
    """Set every column except ``token_id`` to -inf."""
    keep = torch.arange(scores.shape[-1], device=scores.device) == token_id
    return torch.where(keep[None, :], scores, NEG_INF)


def maybe_force_bos_eos(scores, cur_len, max_length, bos_token_id, eos_token_id):
    if cur_len == 1:
        scores = force_token(scores, bos_token_id)
    if eos_token_id is not None and cur_len == max_length - 1:
        scores = force_token(scores, eos_token_id)
    return scores


def _presence(tokens, cur_len, vocab_size):
    """presence[b, v] = True iff v appears in tokens[b, :cur_len]."""
    B = tokens.shape[0]
    presence = torch.zeros((B, vocab_size), dtype=torch.bool, device=tokens.device)
    presence.scatter_(1, tokens[:, :cur_len].long(), True)
    return presence


def apply_repetition_penalty(scores, tokens, cur_len, penalty):
    """Seen tokens get score/p if positive, score*p if negative."""
    if penalty == 1.0:
        return scores
    present = _presence(tokens, cur_len, scores.shape[-1])
    penalised = torch.where(scores < 0, scores * penalty, scores / penalty)
    return torch.where(present, penalised, scores)


def ban_repeated_ngrams(scores, tokens, cur_len, ngram_size):
    """Ban every token that would complete an n-gram already present in
    tokens[:, :cur_len]."""
    n = ngram_size
    if n <= 0 or cur_len < n:
        return scores
    prefix = tokens[:, :cur_len].long()
    windows = prefix.unfold(1, n, 1)                         # [B, cur_len-n+1, n]
    suffix = prefix[:, cur_len - (n - 1):]                   # [B, n-1]
    match = (windows[:, :, :n - 1] == suffix[:, None, :]).all(dim=-1)
    ban = torch.zeros(scores.shape, dtype=torch.float32, device=scores.device)
    ban.scatter_add_(1, windows[:, :, n - 1], match.float())  # any match bans
    return torch.where(ban > 0, NEG_INF, scores)


def apply_bad_words(scores, tokens, cur_len, bad_words_ids):
    """Ban the last token of each bad-words sequence whose prefix matches
    the tail of the generated prefix."""
    if not bad_words_ids:
        return scores
    scores = scores.clone()
    B = tokens.shape[0]
    for word in bad_words_ids:
        k = len(word) - 1
        if k == 0:
            hit = torch.ones((B,), dtype=torch.bool, device=scores.device)
        elif cur_len < k:
            continue
        else:
            tail = tokens[:, cur_len - k:cur_len]
            hit = (tail == torch.as_tensor(word[:-1], device=tokens.device)).all(dim=-1)
        scores[:, word[-1]] = torch.where(hit, NEG_INF, scores[:, word[-1]])
    return scores


def min_length_eos_mask(scores, cur_len, min_length, eos_token_id):
    if eos_token_id is None or min_length <= 0 or cur_len >= min_length:
        return scores
    scores = scores.clone()
    scores[:, eos_token_id] = NEG_INF
    return scores


def postprocess_scores(scores, tokens, cur_len, *, repetition_penalty=1.0,
                       no_repeat_ngram_size=0, bad_words_ids=None, min_length=0,
                       eos_token_id=None):
    """HF 3.0.2 postprocess_next_token_scores order."""
    scores = apply_repetition_penalty(scores, tokens, cur_len, repetition_penalty)
    scores = ban_repeated_ngrams(scores, tokens, cur_len, no_repeat_ngram_size)
    scores = apply_bad_words(scores, tokens, cur_len, bad_words_ids)
    return min_length_eos_mask(scores, cur_len, min_length, eos_token_id)


def _top_p_remove(vals, top_p, min_tokens_to_keep):
    """Nucleus mask over values sorted descending: drop what lies past the
    first entry whose cumulative probability exceeds ``top_p``, keeping the
    first ``min_tokens_to_keep`` entries."""
    cum = torch.cumsum(torch.softmax(vals, dim=-1), dim=-1)
    remove = cum > top_p
    remove = torch.cat([torch.zeros_like(remove[:, :1]), remove[:, :-1]], dim=-1)
    if min_tokens_to_keep > 1:
        remove[:, :min_tokens_to_keep] = False
    return remove


def sample_from_top_k(logits, top_k, top_p, generator, min_tokens_to_keep=1, rows=None):
    """A categorical draw restricted to each row's top-k candidates (and
    the top-p nucleus among them): int64 [B] token ids; ``rows`` as in
    ``gumbel_rows``.

    Distributed as ``top_k_top_p_filtering`` followed by a full-vocabulary
    draw, but the noise covers [B, k]. As in the JAX package, exact ties AT
    the k-th rank keep only the lowest-index tokens, where the filter keeps
    the whole tied group."""
    k = max(top_k, min_tokens_to_keep)
    vals, idx = exact_top_k(logits, k)                 # sorted descending
    if top_p < 1.0:
        vals = torch.where(_top_p_remove(vals, top_p, min_tokens_to_keep), NEG_INF, vals)
    slot = categorical(vals, generator, rows)
    return torch.gather(idx, 1, slot[:, None])[:, 0]


def top_k_top_p_filtering(logits, top_k=0, top_p=1.0, min_tokens_to_keep=1):
    """HF 3.0.2 top_k_top_p_filtering: -inf outside the top-k (ties with
    the k-th value kept) and outside the top-p nucleus."""
    vocab = logits.shape[-1]
    if top_k > 0:
        k = min(max(top_k, min_tokens_to_keep), vocab)
        kth = torch.sort(logits, dim=-1).values[:, -k][:, None]
        logits = torch.where(logits < kth, NEG_INF, logits)
    if top_p < 1.0:
        sorted_logits, order = torch.sort(logits, dim=-1, descending=True, stable=True)
        remove = _top_p_remove(sorted_logits, top_p, min_tokens_to_keep)
        remove_vocab = torch.zeros_like(remove).scatter_(1, order, remove)
        logits = torch.where(remove_vocab, NEG_INF, logits)
    return logits
