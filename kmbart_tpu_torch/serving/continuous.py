"""Slot-pool continuous batching for beam-search serving.

Counterpart of kmbart_tpu/serving/continuous.py. The static engine
(serving/engine.py) coalesces requests into a bucket and runs the whole
beam decode before it answers; this module keeps ONE pool of
``pool_size`` in-flight samples and advances it ``chunk_steps`` ticks at a
time. Between chunks the host harvests finished slots and admits queued
requests into them, so a request waits at most a chunk to be admitted, not
a whole decode.

  * Per-slot depth. Each slot carries its own ``cur_len``: the decoder's
    position embedding gathers per-row positions, and forced BOS/EOS,
    the length penalty, early stopping and the hypothesis pool run per
    sample (generation/beam.py's step with ``cur_len`` a [B] vector).
  * Ring KV cache. Every slot writes its step's K/V at column
    ``tick % max_length``, each tick, so the write is one column for all
    slots. K3 in ring mode (ops/beam_attention.py) reads each sample's
    window of its last ``cur_len`` columns, oldest first, so a slot's
    sums run in the order of the offline decode. A slot decodes at most
    max_length - 1 steps, so its window never wraps onto itself; finished
    and empty slots take the tick's write harmlessly (results live in the
    token and hypothesis buffers, not the cache).
  * Host loop. The pool state lives on the device and is updated in
    place where the JAX package donates it; a tick reads nothing back to
    the host, so a chunk is queued without a sync. After each chunk the
    harvest (a few KB) is copied into pinned memory without blocking, and
    it is read one chunk later, after an event on the stream says the copy
    is done, so the fetch overlaps the next chunk.

Supported options: beam search (num_beams > 1) without sampling and with
inert score postprocessors, the serving default; the static engine serves
the rest. Unlike the JAX engine, a failed admit fails only the requests it
was admitting (the state was not consumed); a failed chunk fails every
request in flight and starts a fresh pool.

Parity: every slot's output equals the offline ``generate()`` for its
sample alone, whatever tick it was admitted at (tests/test_torch_serving.py).
"""

import queue
import threading
import time
from collections import deque
from concurrent.futures import Future

import numpy as np
import torch

from kmbart_tpu_torch.generation.beam import NEG_1E9, _merge_pool, beam_front, fast_candidates
from kmbart_tpu_torch.models import bart
from kmbart_tpu_torch.ops.layers import dense

_HYP = ("hyp_tokens", "hyp_lens", "hyp_scores", "hyp_count", "hyp_worst")


def init_pool_state(model, cfg, *, pool_size, num_beams, max_length, encoder_seq_len):
    """An all-inactive pool on the model's device: the ring cache, the
    per-slot bookkeeping, and the host-side tick."""
    B, K, L, E = pool_size, num_beams, max_length, encoder_seq_len
    dev = model.final_logits_bias.device
    dtype = bart.compute_dtype(cfg)
    D = cfg.d_model
    pad = cfg.pad_token_id

    def zeros(*shape, dt=dtype):
        return torch.zeros(shape, dtype=dt, device=dev)

    def full(shape, value, dt):
        return torch.full(shape, value, dtype=dt, device=dev)

    return {
        "caches": [{"self_k": zeros(B, K, L, D), "self_v": zeros(B, K, L, D),
                    "cross_k": zeros(B, E, D), "cross_v": zeros(B, E, D)}
                   for _ in range(cfg.decoder_layers)],
        "enc_mask": zeros(B, E, dt=torch.long),
        "tokens": full((B * K, L), pad, torch.long),
        "ancestry": zeros(B * K, L, dt=torch.int32),
        "parent": torch.arange(B * K, device=dev),
        "beam_scores": zeros(B, K, dt=torch.float32),
        "hyp_tokens": full((B, K, L), pad, torch.long),
        "hyp_lens": zeros(B, K, dt=torch.long),
        "hyp_scores": full((B, K), NEG_1E9, torch.float32),
        "hyp_count": zeros(B, dt=torch.long),
        "hyp_worst": full((B,), 1e9, torch.float32),
        "cur_len": zeros(B, dt=torch.long),
        "done": torch.ones((B,), dtype=torch.bool, device=dev),
        "active": torch.zeros((B,), dtype=torch.bool, device=dev),
        "tick": 0,
    }


def _select(mask, new, old):
    """Per sample: ``new`` where ``mask`` [B], else ``old``."""
    return torch.where(mask.reshape((-1,) + (1,) * (new.dim() - 1)), new, old)


def _length_norm(n, length_penalty):
    n = n.float()
    return n if length_penalty == 1.0 else n ** length_penalty


def pool_step(model, cfg, state, *, num_beams, max_length, length_penalty, early_stopping,
              eos_token_id, pad_token_id):
    """One tick of the pool: generation/beam.py's loop body with the scalar
    cur_len promoted to per-slot vectors and the ring cache. Updates
    ``state`` and returns it."""
    trunk = model.model
    K, L, V = num_beams, max_length, cfg.vocab_size
    BK = state["tokens"].shape[0]
    B = BK // K
    dev = state["tokens"].device
    b_idx = torch.arange(B, device=dev)
    pos = torch.arange(L, device=dev)[None, :]

    cur_len = state["cur_len"]                          # [B]
    running = state["active"] & ~state["done"]          # [B]
    running_bk = running.repeat_interleave(K)
    cur_bk = cur_len.repeat_interleave(K)               # [BK]
    col = state["tick"] % L

    # the previous token of each row, at its slot's own depth
    prev = torch.gather(state["tokens"], 1, (cur_bk - 1).clamp(0, L - 1)[:, None])
    # ancestry through the parent permutation, then claim the ring column
    ancestry = state["ancestry"][state["parent"]]
    ancestry[:, col] = (torch.arange(BK, device=dev) % K).to(torch.int32)
    hidden = bart.decode_step_stationary(
        trunk, cfg, prev, state["caches"], col, ancestry, state["enc_mask"], num_beams=K,
        seq_positions=(cur_bk - 1).clamp(0, L - 1),
        valid_counts=cur_len.clamp(1, L).to(torch.int32))
    logits = bart.lm_logits(trunk, cfg, hidden, model.final_logits_bias)[:, 0, :]
    # forced BOS at depth 1 and EOS at max_length - 1, per row
    vocab = torch.arange(V, device=dev)[None, :]
    logits = torch.where((cur_bk[:, None] == 1) & (vocab != cfg.bos_token_id), -float("inf"),
                         logits)
    logits = torch.where((cur_bk[:, None] == L - 1) & (vocab != eos_token_id), -float("inf"),
                         logits)

    cand_scores, cand_idx = fast_candidates(logits, state["beam_scores"], K)
    cand_beam = cand_idx // V
    cand_tok = cand_idx % V
    is_eos = cand_tok == eos_token_id
    lp_denorm = _length_norm(cur_len, length_penalty).clamp(min=1.0)

    # ---- commit finished hypotheses (rank < K EOS candidates) ----
    old_hyp = tuple(state[k] for k in _HYP)
    eligible = is_eos[:, :K] & running[:, None]
    hyp_cand_scores = torch.where(eligible, cand_scores[:, :K] / lp_denorm[:, None],
                                  -float("inf"))
    parent_tokens = torch.gather(state["tokens"].reshape(B, K, L), 1,
                                 cand_beam[:, :K, None].expand(-1, -1, L))
    hyp_cand_lens = torch.where(eligible, cur_len[:, None], 0)
    hyp = _merge_pool(old_hyp, hyp_cand_scores, parent_tokens, hyp_cand_lens, K)
    # frozen (finished or empty) slots keep their pool untouched
    hyp = tuple(_select(running, new, old) for new, old in zip(hyp, old_hyp))
    hyp_count, worst = hyp[3], hyp[4]

    # ---- the next beam front: the first K non-EOS candidates ----
    nb_scores, nb_tokens, nb_parents = beam_front(cand_scores, cand_tok, cand_beam, is_eos, K)
    frozen = ~running[:, None]
    nb_scores = torch.where(frozen, state["beam_scores"], nb_scores)
    nb_tokens = torch.where(frozen, pad_token_id, nb_tokens)
    nb_parents = torch.where(frozen, 0, nb_parents)

    # ---- done checks, per sample ----
    best_sum = cand_scores[:, 0]
    if early_stopping:
        newly_done = hyp_count >= K
    else:
        newly_done = (hyp_count >= K) & (worst >= best_sum / lp_denorm)
    newly_done = newly_done & running

    # ---- reorder, and append each row's token at its depth ----
    parent = (b_idx[:, None] * K + nb_parents).reshape(BK)
    parent = torch.where(running_bk, parent, torch.arange(BK, device=dev))
    tokens = state["tokens"][parent]
    write = (pos == cur_bk.clamp(0, L - 1)[:, None]) & running_bk[:, None]
    tokens = torch.where(write, nb_tokens.reshape(BK)[:, None], tokens)
    new_len = torch.where(running, cur_len + 1, cur_len)

    # ---- the final merge of slots that just reached max_length ----
    at_end = running & ~newly_done & (new_len >= L)
    end_denorm = _length_norm(torch.tensor(L, device=dev), length_penalty)
    final_scores = torch.where(at_end[:, None], nb_scores / end_denorm, -float("inf"))
    final_lens = torch.where(at_end[:, None], L, 0).expand(B, K)
    hyp_end = _merge_pool(hyp, final_scores, tokens.reshape(B, K, L), final_lens, K)
    hyp = tuple(_select(at_end, new, old) for new, old in zip(hyp_end, hyp))

    state.update(zip(_HYP, hyp))
    state.update(tokens=tokens, ancestry=ancestry, parent=parent, beam_scores=nb_scores,
                 cur_len=new_len, done=state["done"] | newly_done | at_end,
                 tick=state["tick"] + 1)
    return state


def build_pool_fns(model, cfg, *, pool_size, num_beams, max_length, encoder_seq_len,
                   chunk_steps=4, length_penalty=1.0, early_stopping=True,
                   num_return_sequences=1):
    """(step_chunk, admit, harvest) over the options, each taking the pool
    state (and updating it in place)."""
    eos = cfg.eos_token_id
    pad = cfg.pad_token_id if cfg.pad_token_id is not None else eos
    start = (cfg.decoder_start_token_id if cfg.decoder_start_token_id is not None
             else cfg.bos_token_id)
    K, L, nrs = num_beams, max_length, num_return_sequences
    dtype = bart.compute_dtype(cfg)

    @torch.no_grad()
    def step_chunk(state):
        for _ in range(chunk_steps):
            pool_step(model, cfg, state, num_beams=K, max_length=L,
                      length_penalty=length_penalty, early_stopping=early_stopping,
                      eos_token_id=eos, pad_token_id=pad)
        return state

    @torch.no_grad()
    def admit(state, slots, input_ids, attention_mask, image_features):
        """Admit len(slots) requests: the encoder over their rows, then
        their cross K/V and bookkeeping written into their slots. Inputs
        are [A, E] (features [A, N, F] or None) on the state's device; only
        the first len(slots) rows are admitted (the rest pad the batch)."""
        n = len(slots)
        dev = state["tokens"].device
        enc = bart.encode(model.model, cfg, input_ids, image_features, attention_mask)[:n]
        s = torch.as_tensor(slots, dtype=torch.long, device=dev)
        for layer, cache in zip(model.model.decoder.layers, state["caches"]):
            ea = layer.encoder_attn
            cache["cross_k"][s] = dense(enc, ea.k_proj.weight, ea.k_proj.bias, dtype)
            cache["cross_v"][s] = dense(enc, ea.v_proj.weight, ea.v_proj.bias, dtype)
        state["enc_mask"][s] = attention_mask[:n].long()
        # beam k of slot s lives at row s·K + k
        bk = (s[:, None] * K + torch.arange(K, device=dev)[None, :]).reshape(-1)
        state["tokens"][bk] = pad
        state["tokens"][bk, 0] = start
        state["parent"][bk] = bk
        state["beam_scores"][s] = NEG_1E9
        state["beam_scores"][s, 0] = 0.0
        state["hyp_tokens"][s] = pad
        state["hyp_lens"][s] = 0
        state["hyp_scores"][s] = NEG_1E9
        state["hyp_count"][s] = 0
        state["hyp_worst"][s] = 1e9
        state["cur_len"][s] = 1
        state["done"][s] = False
        state["active"][s] = True
        return state

    @torch.no_grad()
    def harvest(state):
        """(ready [B], tokens [B, nrs, L], lens [B, nrs]): the finalised
        outputs of finished slots (beam.py's finalisation: the pool is
        sorted, EOS appended, pad past the length)."""
        sel_tokens = state["hyp_tokens"][:, :nrs]
        lens = state["hyp_lens"][:, :nrs]
        pos = torch.arange(L, device=sel_tokens.device)[None, None, :]
        lens3 = lens[:, :, None]
        out = torch.where((pos == lens3) & (lens3 < L), eos, sel_tokens)
        out = torch.where(pos > lens3, pad, out)
        return state["active"] & state["done"], out, lens

    return step_chunk, admit, harvest


class ContinuousGenerationEngine:
    """Alternative to serving/engine.py's GenerationEngine with slot-pool
    continuous batching: the same ``submit() -> Future`` surface; a
    multi-row submit is split into rows that re-join in one future.
    Responses keep the max_length width (the static engine's trim=False).
    It runs on the model's device."""

    def __init__(self, model, cfg, tokenizer=None, *, pool_size=112, encoder_seq_len=72,
                 chunk_steps=4, num_beams=5, max_length=32, early_stopping=True,
                 length_penalty=1.0, num_return_sequences=1, admit_width=32):
        self.model = model
        self.cfg = cfg
        self.tokenizer = tokenizer
        self.pool_size = pool_size
        self.encoder_seq_len = encoder_seq_len
        self.num_return_sequences = num_return_sequences
        self.max_length = max_length
        self._admit_width = admit_width
        self.device = model.final_logits_bias.device
        pool = dict(pool_size=pool_size, num_beams=num_beams, max_length=max_length,
                    encoder_seq_len=encoder_seq_len)
        self._step_chunk, self._admit, self._harvest = build_pool_fns(
            model, cfg, chunk_steps=chunk_steps, length_penalty=length_penalty,
            early_stopping=early_stopping, num_return_sequences=num_return_sequences, **pool)
        self._pool_kwargs = pool
        self._state = init_pool_state(model, cfg, **pool)
        self._free = list(range(pool_size))
        self._slot_req = {}          # slot -> (_PoolRequest, row)
        self._slot_seq = {}          # slot -> sequence number of its first chunk
        self._queue = queue.Queue()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    # -- public ----------------------------------------------------------

    def submit(self, input_ids, attention_mask=None, image_features=None):
        input_ids = np.atleast_2d(np.asarray(input_ids, np.int32))
        n = input_ids.shape[0]
        if attention_mask is None:
            attention_mask = (input_ids != self.cfg.pad_token_id).astype(np.int32)
        req = _PoolRequest(n, self.num_return_sequences, self.max_length,
                           self.cfg.pad_token_id)
        for i in range(n):
            feats = (None if image_features is None
                     else np.asarray(image_features[i:i + 1], np.float32))
            self._queue.put((req, i, input_ids[i:i + 1],
                             np.asarray(attention_mask[i:i + 1], np.int32), feats))
        return req.future

    def generate_text(self, text, **kw):
        enc = self.tokenizer.encode(text)
        out = self.submit(np.asarray([enc], np.int32), **kw).result()
        return [self.tokenizer.decode(row, skip_special_tokens=True) for row in out]

    def shutdown(self):
        self._stop.set()
        self._thread.join(timeout=10)

    # -- internals -------------------------------------------------------

    def _admit_group(self, admits, seq):
        """Pad the group's rows to [admit_width, encoder_seq_len] and admit
        them into free slots. On failure the group's slots return to the
        free list and its requests fail; nothing else is touched."""
        cfg, A, E = self.cfg, self._admit_width, self.encoder_seq_len
        F = (cfg.max_img_num, cfg.image_feature_size)
        slots = [self._free.pop() for _ in admits]
        try:
            ids = np.full((A, E), cfg.pad_token_id, np.int64)
            mask = np.zeros((A, E), np.int64)
            # rows that only pad the batch still attend to one token
            ids[len(admits):, 0] = cfg.eos_token_id
            mask[len(admits):, 0] = 1
            feats = None
            for a, (_, _, r_ids, r_mask, r_feats) in enumerate(admits):
                w = min(r_ids.shape[1], E)
                ids[a, :w] = r_ids[0, :w]
                mask[a, :w] = r_mask[0, :w]
                if r_feats is not None:
                    if feats is None:
                        feats = np.zeros((A,) + F, np.float32)
                    feats[a, :r_feats.shape[1]] = r_feats[0, :F[0]]
            dev = self.device
            self._admit(self._state, slots, torch.as_tensor(ids, device=dev),
                        torch.as_tensor(mask, device=dev),
                        None if feats is None else torch.as_tensor(feats, device=dev))
        except Exception as e:  # fail this group only
            try:
                self._state["active"][torch.as_tensor(slots, device=self.device)] = False
            finally:
                self._free.extend(slots)
                for req, _, _, _, _ in admits:
                    req.fail(e)
            return
        for s, (req, row, _, _, _) in zip(slots, admits):
            self._slot_req[s] = (req, row)
            self._slot_seq[s] = seq

    def _fetch(self, handles):
        """Start copying the harvest to the host: pinned buffers and an
        event on the card, a plain copy on the CPU."""
        if self.device.type != "cuda":
            return [h.clone() for h in handles], None
        host = [torch.empty(h.shape, dtype=h.dtype, pin_memory=True) for h in handles]
        for dst, src in zip(host, handles):
            dst.copy_(src, non_blocking=True)
        event = torch.cuda.Event()
        event.record()
        return host, event

    def _resolve(self, hseq, fetched):
        """Deliver the slots a harvest found finished. A harvest taken at
        chunk hseq only speaks for slots admitted at or before that chunk:
        a slot freed since may hold a newer request."""
        (ready, out, _), event = fetched
        if event is not None:
            event.synchronize()
        ready, out = ready.numpy(), out.numpy().astype(np.int32)
        for s in list(self._slot_req):
            if ready[s] and self._slot_seq.get(s, 1 << 62) <= hseq:
                req, row = self._slot_req.pop(s)
                self._slot_seq.pop(s, None)
                self._free.append(s)
                req.deliver(row, out[s])

    def _fail_all(self, e):
        for s in list(self._slot_req):
            req, _ = self._slot_req.pop(s)
            req.fail(e)
        self._slot_seq.clear()
        self._state = init_pool_state(self.model, self.cfg, **self._pool_kwargs)
        self._free = list(range(self.pool_size))

    def _loop(self):
        """Drain-admit: admit groups of up to admit_width until the queue
        or the free slots run out; then queue a chunk, start its harvest's
        copy, and deliver the previous chunk's harvest while this one runs
        (at once when the pool is nearly idle, for latency)."""
        if self.device.type == "cuda":
            torch.cuda.set_device(self.device)
        A = self._admit_width
        pending = deque()   # (sequence number, fetched harvest)
        seq = 0             # sequence number of the next chunk
        while not self._stop.is_set():
            while self._free:
                admits = []
                while len(admits) < min(A, len(self._free)):
                    try:
                        admits.append(self._queue.get_nowait())
                    except queue.Empty:
                        break
                if not admits:
                    break
                self._admit_group(admits, seq)
            if not self._slot_req:
                pending.clear()
                time.sleep(0.001)
                continue
            try:
                self._step_chunk(self._state)
                pending.append((seq, self._fetch(self._harvest(self._state))))
                seq += 1
                if len(pending) >= 2 or (self._queue.empty() and len(self._slot_req) <= A):
                    self._resolve(*pending.popleft())
            except Exception as e:  # surface errors through the futures
                pending.clear()
                self._fail_all(e)


class _PoolRequest:
    """Re-joins the per-row results of one submit into a single future
    resolving to [n · num_return_sequences, max_length]."""

    def __init__(self, n_rows, nrs, max_length, pad_token_id):
        self.future = Future()
        self._lock = threading.Lock()
        self._remaining = n_rows
        self._out = np.full((n_rows * nrs, max_length), pad_token_id, np.int32)
        self._nrs = nrs

    def deliver(self, row, tokens_nrs_L):
        with self._lock:
            self._out[row * self._nrs:(row + 1) * self._nrs] = tokens_nrs_L
            self._remaining -= 1
            finished = self._remaining == 0
        if finished and not self.future.done():
            self.future.set_result(self._out)

    def fail(self, e):
        if not self.future.done():
            self.future.set_exception(e)
