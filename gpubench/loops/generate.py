"""Closed-loop batch generation: one client calling
``kmbart_tpu_torch.generation.api.generate`` back to back.

Set-up builds the conditional model with the benchmark's weights, draws a
pool of host batches from the seed and warms up with one call on the
mix's shapes. Each timed call takes the next pool batch as numpy arrays,
as ``vcg_generate`` hands a collated batch over, and returns its tokens.
Beside the tokens the loop keeps each call's final hypothesis pool as
the system scored it: the result of the last ``generation/beam.py
_merge_pool`` of the call, a tensor left on the card (no copy, no sync in
the window); its first column scores the served row.

The check (``numbers``): after the window, a sample drawn from the seed
of the rows whose call completed, the longest among them, is judged
against the plain reference in float32 (``reference/beam.py``), on each
row's prompt:

- ``score_gap``: the widest gap between the system's score of a served
  row and the reference's score of the same tokens, teacher forced (the
  hypothesis score: summed log-probabilities over the length). It holds
  the encoder, the decode step, the LM head, K4's statistics and the beam
  bookkeeping that carries each score with its tokens;
- ``served_token_gap``: the widest gap by which a served token's
  reference log-probability lies below the reference's 2K-th best at its
  position (a beam of width K serves a token only from its row's 2K best).
  It bounds what the beam picks (K4's top-2K, the merge of the beams'
  candidates); the forced tokens (BOS after the start token, EOS at the
  last position) are not judged. The cell prints it and does not compare
  it: a beam run in float8 serves tokens inside float32's 2K best on some
  seeds, so no control reading sets a limit for it.
"""

import numpy as np
import torch

from gpubench.harness import feed
from gpubench.reference import bart as ref
from gpubench.reference import beam as ref_beam


class Loop:
    kind = "generate"

    def __init__(self, ctx):
        from kmbart_tpu_torch.generation import beam
        from kmbart_tpu_torch.generation.api import generate
        from kmbart_tpu_torch.models.conditional import MultiModalBartForConditionalGeneration

        self.ctx, self.cfg, self.mix = ctx, ctx.cfg, ctx.mix
        self.opts = dict(self.mix["generate"])
        if self.opts["num_beams"] < 2 or self.opts.get("do_sample"):
            raise ValueError("the generation check judges greedy beam search (num_beams > 1)")
        self._generate = generate
        self._beam, self._merge_pool = beam, beam._merge_pool
        self._pool_scores = None

        def merge_pool(*args, **kwargs):
            out = self._merge_pool(*args, **kwargs)
            self._pool_scores = out[2]
            return out
        beam._merge_pool = merge_pool
        with torch.device(ctx.device):
            self.model = MultiModalBartForConditionalGeneration(ctx.cfg_obj)
        ctx.load_weights(self.model, heads=False)
        self.model.eval()
        self.pool = [feed.make_batch(self.mix, self.cfg, ctx.seed, i)
                     for i in range(self.mix["pool"])]
        self.outputs, self.scores = [], []
        self._call(self.pool[0])    # warm-up: every shape the window uses
        self.outputs.clear()
        self.scores.clear()

    def _call(self, batch):
        self._pool_scores = None
        out = self._generate(self.model, self.ctx.cfg_obj, batch, **self.opts)
        if self._pool_scores is None:
            raise RuntimeError("generate() committed no hypothesis pool")
        self.outputs.append(out)
        self.scores.append(self._pool_scores)
        return out.shape[0]

    def call(self):
        i = len(self.outputs)
        return self._call(self.pool[i % len(self.pool)])

    def describe(self):
        """The served widths of the calls (a call decodes one step fewer
        than its widest row), for the run's standard error."""
        widths = [o.shape[1] for o in self.outputs]
        return f"served widths: {sorted(set(widths))}, mean {sum(widths) / max(1, len(widths)):.2f}"

    def sync(self):
        if self.ctx.device.type == "cuda":
            torch.cuda.synchronize()

    def free(self):
        self._beam._merge_pool = self._merge_pool
        del self.model

    # ------------------------------------------------------------ the check

    def sample(self):
        """[(call, row)] drawn from the seed among the completed rows, with
        the row of the longest served sequence."""
        rows = [(c, r) for c, out in enumerate(self.outputs) for r in range(out.shape[0])]
        n = min(self.mix["check_rows"], len(rows))
        rng = feed.rng_for(self.ctx.seed, 10 ** 6)
        picked = [rows[i] for i in rng.choice(len(rows), n, replace=False)]
        eos = self.cfg["eos_token_id"]
        longest = max(rows, key=lambda cr: ref_beam.eos_position(self.outputs[cr[0]][cr[1]], eos))
        return picked if longest in picked else picked[:-1] + [longest]

    def served(self):
        """(prompts, served rows, the system's scores of them) over the sample."""
        picked = self.sample()
        prompts = {k: np.stack([self.pool[c % len(self.pool)][k][r] for c, r in picked])
                   for k in ("input_ids", "attention_mask", "image_features")}
        rows = [self.outputs[c][r] for c, r in picked]
        scores = [float(self.scores[c][r, 0]) for c, r in picked]
        return prompts, rows, scores

    def numbers(self):
        reference = Reference(self.ctx, self.opts)
        return reference.numbers(*self.served())


class Reference:
    """The reference's side of the check, on the card the run used."""

    def __init__(self, ctx, opts):
        self.cfg, self.dev = ctx.cfg, ctx.device
        _, self.P = ref.make_params(self.cfg, ctx.seed, self.dev, heads=False)
        self.K, self.L = opts["num_beams"], opts["max_length"]
        self.early = opts["early_stopping"]
        self.lp = opts.get("length_penalty", self.cfg["length_penalty"])

    def _encode(self, prec, prompts):
        t = lambda a: torch.as_tensor(a, device=self.dev)
        mask = t(prompts["attention_mask"]).long()
        enc = ref.encode(prec, self.P, self.cfg, t(prompts["input_ids"]).long(),
                         t(prompts["image_features"]).float(), mask, ref.Dropout(0.0))
        return enc, mask

    def beam(self, precision, prompts):
        """The reference's own served rows and scores at ``precision``."""
        prec = ref.Precision(precision)
        enc, mask = self._encode(prec, prompts)
        return ref_beam.beam_search(prec, self.P, self.cfg, enc, mask, self.K, self.L,
                                    self.early, self.lp)

    @torch.no_grad()
    def numbers(self, prompts, rows, scores):
        """``score_gap`` and ``served_token_gap`` (module docstring) of
        served ``rows`` that their server scored ``scores``."""
        enc, mask = self._encode(ref.Precision("fp32"), prompts)
        want, gaps = ref_beam.teacher_forced(ref.Precision("fp32"), self.P, self.cfg, enc, mask,
                                             list(rows), self.L, self.lp, 2 * self.K)
        return {"score_gap": max(abs(a - b) for a, b in zip(scores, want)),
                "served_token_gap": max(gaps)}
