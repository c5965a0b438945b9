"""Public ``generate`` front end.

Counterpart of kmbart_tpu/generation/api.py (HF 3.0.2
``GenerationMixin.generate``): option defaulting from the model config,
the reference's validation asserts, attention-mask construction, one
encoder pass, the return-sequence expansion of the encoder outputs when
sampling (batch-major, as the reference's ``index_select``), and dispatch
to the beam or greedy/sampling loop, then the trim to the HF output width.
Everything runs on the model's device; sampling draws from ``generator``
(a ``torch.Generator`` on that device; a freshly seeded one when None).

Over a process grid (``grid``, parallel/mesh.py), the counterpart of the
JAX package's ``generate`` on sharded inputs and parameters
(tests/test_parallel_generate.py): data coordinate d decodes the d-th
contiguous block of ⌈B/dp⌉ rows (the last smaller, maybe empty), the ranks
of a model axis each on their part of the model (parallel/tp.py
``shard_model_``); every rank returns the whole batch's tokens, the blocks
gathered over the data axis, equal to one process's. Sampling draws the
whole batch's noise on every rank (``logits.gumbel_rows``) from one seed,
so the sampled tokens are one process's at the same seed too.
"""

import dataclasses
import itertools
from typing import Optional, Tuple

import torch

from kmbart_tpu_torch.config import MultiModalBartConfig
from kmbart_tpu_torch.generation.beam import beam_search_loop
from kmbart_tpu_torch.generation.decode import greedy_or_sample_loop
from kmbart_tpu_torch.models import bart
from kmbart_tpu_torch.parallel import distributed
from kmbart_tpu_torch.utils.profiling import span

_CALLS = itertools.count()   # the ids of generate()'s spans


@dataclasses.dataclass(frozen=True)
class GenerationOptions:
    max_length: int = 20
    min_length: int = 0
    do_sample: bool = False
    early_stopping: bool = False
    num_beams: int = 1
    temperature: float = 1.0
    top_k: int = 50
    top_p: float = 1.0
    repetition_penalty: float = 1.0
    bad_words_ids: Optional[Tuple[Tuple[int, ...], ...]] = None
    length_penalty: float = 1.0
    no_repeat_ngram_size: int = 0
    num_return_sequences: int = 1
    use_cache: bool = True

    def validate(self):
        # the reference's asserts (mixins.py:180-235)
        assert isinstance(self.max_length, int) and self.max_length > 0
        assert isinstance(self.min_length, int) and self.min_length >= 0
        assert isinstance(self.num_beams, int) and self.num_beams > 0
        assert self.temperature > 0
        assert isinstance(self.top_k, int) and self.top_k >= 0
        assert 0 <= self.top_p <= 1
        assert self.repetition_penalty >= 1.0
        assert self.length_penalty > 0
        assert self.no_repeat_ngram_size >= 0
        assert self.num_return_sequences > 0
        if not self.do_sample:
            if self.num_beams == 1:
                assert self.num_return_sequences == 1, (
                    "Greedy decoding will always produce the same output for "
                    "num_beams == 1 and num_return_sequences > 1")
            else:
                assert self.num_beams >= self.num_return_sequences, (
                    "Greedy beam search decoding cannot return more sequences "
                    "than it has beams")


def options_from_config(cfg: MultiModalBartConfig, **overrides) -> GenerationOptions:
    fields = {f.name for f in dataclasses.fields(GenerationOptions)}
    base = {k: getattr(cfg, k) for k in fields if hasattr(cfg, k)}
    base.update({k: v for k, v in overrides.items() if v is not None})
    if base.get("bad_words_ids"):
        base["bad_words_ids"] = tuple(tuple(w) for w in base["bad_words_ids"])
    return GenerationOptions(**base)


@torch.no_grad()
def generate_tokens(model, cfg, input_ids, attention_mask, image_features,
                    opts: GenerationOptions, generator=None, grid=None):
    """Device-side generate: (tokens [B·R, max_length], HF output width).
    ``grid``: generation over a split model (module docstring); a grid with
    pipeline stages raises, as the JAX package gathers the model to decode
    (kmbart_tpu/vcg_train.py ``host_replicated``)."""
    opts.validate()
    if grid is not None and grid.stage.size > 1:
        raise ValueError("generate() does not run inside a pipeline: gather the model "
                         "first (cli_common.whole_model)")
    if opts.do_sample and generator is None:
        generator = torch.Generator(device=input_ids.device)
        generator.seed()
        if grid is not None and grid.world.size > 1:
            # every rank draws from rank 0's seed
            box = torch.tensor([generator.initial_seed() % 2 ** 63], device=input_ids.device)
            generator.manual_seed(int(distributed.broadcast(box, 0, grid.world)[0]))
    tp = None if grid is None else grid.tp
    data = None if grid is None else grid.data
    if data is None or data.size == 1:
        return _decode(model, cfg, input_ids, attention_mask, image_features, opts,
                       generator, tp)
    B = input_ids.shape[0]
    per = -(-B // data.size)
    lo = min(data.index * per, B)
    hi = min(lo + per, B)
    mult = opts.num_return_sequences if opts.do_sample else 1
    if hi > lo:
        out, eff_len = _decode(
            model, cfg, input_ids[lo:hi], attention_mask[lo:hi],
            None if image_features is None else image_features[lo:hi], opts, generator, tp,
            noise_rows=(B * mult, lo * mult))
    else:
        # an empty block decodes nothing but joins the gather
        out = torch.empty((0, opts.max_length), dtype=torch.long, device=input_ids.device)
        eff_len = 0
    R = opts.num_return_sequences
    pad = cfg.pad_token_id if cfg.pad_token_id is not None else cfg.eos_token_id
    tokens, widths = distributed.all_gather_blocks(out, per * R, pad, data, tag=eff_len)
    # one process stops at the latest sample's finish: the widest block's
    return tokens.long(), max(widths)


def _decode(model, cfg, input_ids, attention_mask, image_features, opts, generator, tp,
            noise_rows=None):
    """Encode and decode the rows given on this rank's part of the model."""
    with span("encode"):
        enc = bart.encode(model.model, cfg, input_ids, image_features, attention_mask, tp=tp)
    K = opts.num_beams
    mult = opts.num_return_sequences if opts.do_sample else 1
    # the beam axis is not materialised (a sample's beams share its encoder
    # states), so only sampled return sequences expand the encoder outputs
    if mult > 1:
        enc = enc.repeat_interleave(mult, dim=0)
        attention_mask = attention_mask.repeat_interleave(mult, dim=0)
    common = dict(
        max_length=opts.max_length, min_length=opts.min_length,
        do_sample=opts.do_sample, temperature=opts.temperature, top_k=opts.top_k,
        top_p=opts.top_p, repetition_penalty=opts.repetition_penalty,
        no_repeat_ngram_size=opts.no_repeat_ngram_size,
        bad_words_ids=opts.bad_words_ids,
        pad_token_id=cfg.pad_token_id if cfg.pad_token_id is not None
        else cfg.eos_token_id,
        eos_token_id=cfg.eos_token_id,
        decoder_start_token_id=cfg.decoder_start_token_id
        if cfg.decoder_start_token_id is not None else cfg.bos_token_id,
        tp=tp, noise_rows=noise_rows)
    if K > 1:
        return beam_search_loop(
            model, cfg, enc, attention_mask, generator,
            batch_size=input_ids.shape[0] * mult, num_beams=K,
            length_penalty=opts.length_penalty, early_stopping=opts.early_stopping,
            num_return_sequences=1 if opts.do_sample else opts.num_return_sequences,
            **common)
    return greedy_or_sample_loop(model, cfg, enc, attention_mask, generator, **common)


def generate(model, cfg: MultiModalBartConfig, batch, *, trim=True, generator=None,
             grid=None, **kwargs):
    """Generate for a collated batch {"input_ids", optional "attention_mask",
    "image_features"} (numpy or tensors). Returns an int32 numpy array
    [B·num_return_sequences, width], batch-major like the reference.
    ``generator``: the ``torch.Generator`` sampling draws from (under a
    grid, seeded alike on every rank). ``grid``: a ``parallel/mesh.py
    Grid`` and ``model`` this rank's part of the model; every rank of the
    grid calls this with the whole batch and gets the whole output."""
    with span("generate", id=next(_CALLS)):
        opts = options_from_config(cfg, **kwargs)
        dev = model.final_logits_bias.device
        with span("generate.inputs"):
            input_ids = torch.as_tensor(batch["input_ids"], device=dev).long()
            attention_mask = batch.get("attention_mask")
            if attention_mask is None:
                attention_mask = ((input_ids != cfg.pad_token_id).long()
                                  if cfg.pad_token_id is not None else torch.ones_like(input_ids))
            else:
                attention_mask = torch.as_tensor(attention_mask, device=dev).long()
            image_features = batch.get("image_features")
            if image_features is not None:
                image_features = torch.as_tensor(image_features, device=dev).float()
        out, eff_len = generate_tokens(model, cfg, input_ids, attention_mask,
                                       image_features, opts, generator, grid)
        with span("sync.outputs"):
            out = out.to(torch.int32).cpu().numpy()
        return out[:, :eff_len] if trim else out
