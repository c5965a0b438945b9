"""COMET-ATOMIC knowledge generator, in PyTorch.

Counterpart of kmbart_tpu/knowledge/atomic.py (the reference's
``AtomicGenerator``, scripts/atomic_generator.py:16-99): encode the event,
append one of the ATOMIC category tokens (xIntent/xWant/xNeed/xReact/
xEffect), generate the continuation (greedy, ``topk-N`` or ``beam-K``), map
categories onto KM-BART task types (xIntent, xWant -> intent; xNeed ->
before; xReact, xEffect -> after) and drop "none" generations.

All five categories decode as one batch over a preallocated GPT cache. The
loops run on the host: the greedy loop reads one flag a step to stop once
every row has ended (the JAX ``while_loop`` tests the same on the device);
the beam loop runs a fixed number of steps with no host read. Draws come
from an explicit ``torch.Generator``.
"""

import numpy as np
import torch

from kmbart_tpu_torch.generation.logits import (categorical, sample_from_top_k,
                                                top_k_top_p_filtering)
from kmbart_tpu_torch.knowledge import gpt
from kmbart_tpu_torch.ops.topk import top_k

CATEGORIES = ("xIntent", "xWant", "xNeed", "xReact", "xEffect")
RESULT_MAP = {"xIntent": "intent", "xWant": "intent", "xNeed": "before",
              "xReact": "after", "xEffect": "after"}


class AtomicGenerator:
    def __init__(self, model, text_encoder, *, max_event=17, max_effect=34,
                 sampling_algorithm="greedy", end_token="<END>", category_tokens=None,
                 generator=None, dtype=torch.bfloat16):
        """``model``: a ``GPTModel`` (knowledge/gpt.py); ``text_encoder``:
        GPT1BPE (or anything with encode/decode); ``category_tokens``:
        {category: token_id} for the ATOMIC delimiter tokens (appended after
        the base vocab in COMET checkpoints); ``generator`` feeds the
        ``topk`` draws (default: seed 0 on the model's device)."""
        self.model = model
        self.enc = text_encoder
        self.max_event = max_event
        self.max_effect = max_effect
        self.sampling = sampling_algorithm
        self.dtype = dtype
        self.device = model.embed.weight.device
        self.generator = generator if generator is not None else \
            torch.Generator(device=self.device).manual_seed(0)
        vocab = getattr(text_encoder, "encoder", {})
        self.end_id = vocab.get(end_token + "</w>", vocab.get(end_token, 0))
        if category_tokens is None:
            base = len(vocab)
            category_tokens = {cat: vocab.get("<%s>" % cat, base - len(CATEGORIES) + i)
                               for i, cat in enumerate(CATEGORIES)}
        self.category_tokens = category_tokens

    def _prime(self, tokens, max_prompt, max_len):
        cache = gpt.init_gpt_cache(self.model, tokens.shape[0], max_len, self.dtype)
        for i in range(max_prompt):
            gpt.gpt_step(self.model, tokens[:, i:i + 1], cache, i, self.dtype)
        return cache

    def _step_logits(self, tokens, cache, i):
        hidden, _ = gpt.gpt_step(self.model, tokens[:, i - 1:i], cache, i - 1, self.dtype)
        return gpt.gpt_logits(self.model, hidden, self.dtype)[:, 0, :]

    @torch.no_grad()
    def sample(self, prompt):
        """prompt [B, max_event + 1] -> tokens [B, max_event + 1 + max_effect]."""
        if self.sampling.startswith("beam"):
            return self._beam(prompt)
        max_prompt = self.max_event + 1
        max_len = max_prompt + self.max_effect
        do_sample = self.sampling.startswith("topk")
        topk = 10 if do_sample else 0
        if do_sample and "-" in self.sampling:
            topk = int(self.sampling.split("-")[1])
        B = prompt.shape[0]
        tokens = torch.zeros((B, max_len), dtype=torch.long, device=self.device)
        tokens[:, :max_prompt] = prompt
        cache = self._prime(tokens, max_prompt, max_len)
        unfinished = torch.ones((B,), dtype=torch.long, device=self.device)
        cur = max_prompt
        while cur < max_len and bool(unfinished.max() > 0):
            logits = self._step_logits(tokens, cache, cur)
            if do_sample and topk > 0:
                nxt = sample_from_top_k(logits, topk, 1.0, self.generator)
            elif do_sample:
                nxt = categorical(top_k_top_p_filtering(logits, topk, 1.0), self.generator)
            else:
                nxt = torch.argmax(logits, dim=-1)
            nxt = nxt * unfinished
            unfinished = unfinished * (nxt != self.end_id).long()
            tokens[:, cur] = nxt
            cur += 1
        return tokens

    def _beam(self, prompt):
        """'beam-K' (comet's BeamSampler): K beams per row, sum-logprob
        scores, beams frozen on <END> continue with <END> at zero cost; the
        best beam of each row is returned."""
        K = int(self.sampling.split("-")[1]) if "-" in self.sampling else 5
        max_prompt = self.max_event + 1
        max_len = max_prompt + self.max_effect
        n_vocab = self.model.n_vocab
        B = prompt.shape[0]
        BK = B * K
        dev = self.device
        tokens = torch.zeros((BK, max_len), dtype=torch.long, device=dev)
        tokens[:, :max_prompt] = prompt.repeat_interleave(K, dim=0)
        cache = self._prime(tokens, max_prompt, max_len)
        beam_scores = torch.full((B, K), -1e9, device=dev)
        beam_scores[:, 0] = 0.0
        finished = torch.zeros((BK,), dtype=torch.bool, device=dev)
        end_row = torch.full((n_vocab,), -float("inf"), device=dev)
        end_row[self.end_id] = 0.0
        rows = torch.arange(B, device=dev)
        for i in range(max_prompt, max_len):
            logp = torch.log_softmax(self._step_logits(tokens, cache, i), dim=-1)
            logp = torch.where(finished[:, None], end_row[None, :], logp)
            flat = (logp + beam_scores.reshape(BK, 1)).reshape(B, K * n_vocab)
            beam_scores, idx = top_k(flat, K)
            parent = (rows[:, None] * K + idx // n_vocab).reshape(BK)
            tok = (idx % n_vocab).reshape(BK)
            tokens = tokens[parent]
            tokens[:, i] = tok
            cache = {"k": cache["k"][:, parent], "v": cache["v"][:, parent]}
            finished = finished[parent] | (tok == self.end_id)
        best = torch.argmax(beam_scores, dim=1)
        return tokens.reshape(B, K, max_len)[rows, best]

    def prompt(self, input_event):
        """The five category prompts of an event [5, max_event + 1]: the
        event zero-padded to ``max_event``, the category token at column
        ``max_event`` (COMET's fixed layout)."""
        event_ids = self.enc.encode(input_event)[: self.max_event]
        prompt = np.zeros((len(CATEGORIES), self.max_event + 1), np.int64)
        for i, cat in enumerate(CATEGORIES):
            prompt[i, : len(event_ids)] = event_ids
            prompt[i, self.max_event] = self.category_tokens[cat]
        return torch.as_tensor(prompt, device=self.device)

    def get_reason(self, input_event):
        """{'after': [...], 'before': [...], 'intent': [...]}: the best
        generation per category, 'none' dropped
        (scripts/atomic_generator.py:81-99)."""
        tokens = self.sample(self.prompt(input_event)).cpu().numpy()
        result = {"after": [], "before": [], "intent": []}
        for i, cat in enumerate(CATEGORIES):
            gen = tokens[i, self.max_event + 1:]
            text = self.enc.decode(gen.tolist(), stop_ids=(self.end_id, 0))
            if text and text != "none":
                result[RESULT_MAP[cat]].append(text)
        return result
