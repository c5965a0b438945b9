"""Plain beam search and hypothesis scores over the reference model.

HF transformers 3.0.2 ``_generate_beam_search`` as BART runs it with every
score postprocessor inert (no sampling, no repetition penalty, no n-gram
or bad-word ban, min_length 0): BART's forced BOS at the first step and
forced EOS at the last (``max_length - 1``), the 2K best of each sample's
[K·V] scores, EOS candidates of rank < K committed to a pool of the K best
hypotheses (score: summed log-probabilities over the hypothesis's length
to the power ``length_penalty``), the first K other candidates as the next
beam, early stopping once the pool is full, and the live beams committed
at the end. Each step runs the whole decoder over every beam's prefix: no
cache. The bookkeeping is plain Python on the host.

A served row is ``[start, BOS, tokens..., EOS, pad...]``; its hypothesis
is the row before the EOS, and its length the EOS's position.

Nothing here imports the system under test or JAX.
"""

import torch

from gpubench.reference import bart as ref


def eos_position(row, eos):
    """The position of the EOS that ends a served row (its width when none)."""
    for p in range(1, len(row)):
        if int(row[p]) == eos:
            return p
    return len(row)


def forced(logits, cur_len, cfg, max_length):
    """BART's adjust_logits_during_generation: at step 1 only BOS, at
    ``max_length - 1`` only EOS."""
    tok = cfg["bos_token_id"] if cur_len == 1 else (
        cfg["eos_token_id"] if cur_len == max_length - 1 else None)
    if tok is None:
        return logits
    keep = torch.arange(logits.shape[-1], device=logits.device) == tok
    return torch.where(keep[None, :], logits, -float("inf"))


@torch.no_grad()
def teacher_forced(prec, P, cfg, enc, enc_mask, rows, max_length, length_penalty, k):
    """Each served row's hypothesis score, teacher forced: the log-
    probabilities of its tokens after the start token up to its EOS (0 at
    a forced step), summed, over its length ** ``length_penalty``; and the
    widest gap by which one of those tokens (the forced ones left out) lies
    below the ``k``-th best log-probability of its position (0 where none
    does). ``enc``
    [n, T, D] and ``enc_mask`` belong to the rows. Returns two lists."""
    T = max(len(r) for r in rows)
    dec = torch.full((len(rows), T), cfg["pad_token_id"], dtype=torch.long, device=enc.device)
    for i, r in enumerate(rows):
        dec[i, :len(r)] = torch.as_tensor([int(t) for t in r])
    logp = torch.log_softmax(ref.lm_logits(prec, P, ref.decode(
        prec, P, cfg, dec, enc, enc_mask, None, ref.Dropout(0.0))).float(), dim=-1)[:, :-1]
    picked = logp.gather(-1, dec[:, 1:, None])[..., 0]
    kth = torch.topk(logp, k, dim=-1).values[..., -1]
    picked, below = picked.cpu(), (kth - picked).cpu()
    scores, gaps = [], []
    for i, r in enumerate(rows):
        end = eos_position(r, cfg["eos_token_id"])
        judged = [p for p in range(2, min(end, len(r) - 1) + 1) if p != max_length - 1]
        scores.append(sum(float(picked[i, p - 1]) for p in judged) / end ** length_penalty)
        gaps.append(max([0.0] + [float(below[i, p - 1]) for p in judged]))
    return scores, gaps


def _add(pool, K, tokens, score):
    """BeamHypotheses.add: keep the K best (score, tokens)."""
    pool.append((score, tokens))
    pool.sort(key=lambda h: h[0], reverse=True)
    del pool[K:]


@torch.no_grad()
def beam_search(prec, P, cfg, enc, enc_mask, num_beams, max_length, early_stopping,
                length_penalty=1.0):
    """The best hypothesis of each sample as served rows (with their EOS)
    and their scores. ``enc`` [B, T, D] and ``enc_mask`` are per sample."""
    B, K, V = enc.shape[0], num_beams, cfg["vocab_size"]
    eos, pad = cfg["eos_token_id"], cfg["pad_token_id"]
    enc_k, mask_k = enc.repeat_interleave(K, 0), enc_mask.repeat_interleave(K, 0)
    seqs = [[cfg["decoder_start_token_id"]] for _ in range(B * K)]
    beam_scores = torch.full((B, K), -1e9, device=enc.device)
    beam_scores[:, 0] = 0.0
    pools = [[] for _ in range(B)]
    done = [False] * B
    cur_len = 1
    while cur_len < max_length:
        dec = torch.as_tensor(seqs, device=enc.device)
        h = ref.decode(prec, P, cfg, dec, enc_k, mask_k, None, ref.Dropout(0.0))[:, -1:]
        logits = forced(ref.lm_logits(prec, P, h)[:, 0].float(), cur_len, cfg, max_length)
        scores = torch.log_softmax(logits, dim=-1) + beam_scores.reshape(B * K, 1)
        top_s, top_i = torch.topk(scores.reshape(B, K * V), 2 * K, dim=1)
        top_s, top_i = top_s.cpu().tolist(), top_i.cpu().tolist()
        new_seqs, new_scores = [], []
        for b in range(B):
            if done[b]:
                new_seqs += [seqs[b * K] + [pad]] * K
                new_scores += [0.0] * K
                continue
            front = []
            for rank, (s, idx) in enumerate(zip(top_s[b], top_i[b])):
                beam, tok = divmod(idx, V)
                if tok == eos:
                    if rank < K:
                        _add(pools[b], K, list(seqs[b * K + beam]), s / cur_len ** length_penalty)
                else:
                    front.append((s, seqs[b * K + beam] + [tok]))
                if len(front) == K:
                    break
            if early_stopping:
                done[b] = len(pools[b]) >= K
            else:
                done[b] = len(pools[b]) >= K and \
                    pools[b][-1][0] >= top_s[b][0] / cur_len ** length_penalty
            new_seqs += [f[1] for f in front]
            new_scores += [f[0] for f in front]
        seqs = new_seqs
        beam_scores = torch.as_tensor(new_scores, device=enc.device).reshape(B, K)
        cur_len += 1
        if all(done):
            break
    finals = beam_scores.cpu().tolist()
    for b in range(B):
        if not done[b]:
            for k in range(K):
                _add(pools[b], K, list(seqs[b * K + k]), finals[b][k] / cur_len ** length_penalty)
    rows = [pool[0][1] + [eos] if len(pool[0][1]) < max_length else pool[0][1]
            for pool in pools]
    return rows, [pool[0][0] for pool in pools]
