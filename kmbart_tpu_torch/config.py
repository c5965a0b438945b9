"""Model configuration.

Parity target: ``MultiModalBartConfig`` in the reference (src/model/config.py:4-92),
which extends transformers' BartConfig with the multimodal fields
(``image_feature_size=2052``, ``img_feat_id``, ``cls_token_id``), the
pretraining head sizes (``num_labels``/``num_attributes``/``num_relations``),
four per-loss scale factors, and the ``partial_load`` parameter list used for
shape-adaptive checkpoint loading.

This is a plain dataclass (no HuggingFace dependency); JSON round-trips with
the reference's ``config.json`` files (config/pretrain_base.json,
config/vcg_base.json) so checkpoints stay interoperable.
"""

import dataclasses
import json
from typing import List, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class MultiModalBartConfig:
    # --- core transformer dims (BartConfig subset used by the reference) ---
    vocab_size: int = 50320
    d_model: int = 1024
    encoder_layers: int = 12
    decoder_layers: int = 12
    encoder_attention_heads: int = 16
    decoder_attention_heads: int = 16
    encoder_ffn_dim: int = 4096
    decoder_ffn_dim: int = 4096
    max_position_embeddings: int = 1024
    activation_function: str = "gelu"

    # --- regularisation ---
    dropout: float = 0.1
    attention_dropout: float = 0.0
    activation_dropout: float = 0.0
    classif_dropout: float = 0.0
    encoder_layerdrop: float = 0.0
    decoder_layerdrop: float = 0.0
    init_std: float = 0.02

    # --- architecture switches (BART-base/large use the defaults) ---
    extra_pos_embeddings: int = 2  # learned-position offset (HF BART "+2")
    normalize_before: bool = False
    add_final_layer_norm: bool = False
    normalize_embedding: bool = True
    scale_embedding: bool = False
    static_position_embeddings: bool = False
    add_bias_logits: bool = False
    is_encoder_decoder: bool = True

    # --- special tokens ---
    pad_token_id: int = 1
    bos_token_id: int = 0
    eos_token_id: int = 2
    decoder_start_token_id: int = 0
    img_feat_id: int = 50273
    cls_token_id: int = 50276

    # --- multimodal / pretraining heads ---
    image_feature_size: int = 2048 + 4
    num_labels: int = 1         # MRM soft-label classes (1601 for the detector)
    num_attributes: int = 1     # VG attribute classes (129 = top-128 + unk)
    num_relations: int = 1      # VG relation classes  (129 = top-128 + unk)
    lm_loss_factor: float = 1.0
    mrm_loss_factor: float = 1.0
    attribute_loss_factor: float = 1.0
    relation_loss_factor: float = 1.0

    # --- checkpoint import ---
    partial_load: Tuple[str, ...] = ()

    # --- generation defaults (BartConfig defaults in transformers 3.0.2) ---
    max_length: int = 20
    min_length: int = 0
    do_sample: bool = False
    early_stopping: bool = False
    num_beams: int = 1
    temperature: float = 1.0
    top_k: int = 50
    top_p: float = 1.0
    repetition_penalty: float = 1.0
    length_penalty: float = 1.0
    no_repeat_ngram_size: int = 0
    num_return_sequences: int = 1
    bad_words_ids: Optional[List[List[int]]] = None
    use_cache: bool = True

    # --- TPU-specific knobs (new in this framework) ---
    dtype: str = "bfloat16"       # compute dtype; params/optimizer stay fp32
    remat: bool = False           # jax.checkpoint each layer (memory vs flops)
    max_img_num: int = 30         # fixed image-slot count for static shapes
    decode_unroll_layers: bool = False  # unroll the decode-step layer loop.
    # Measured WORSE on v5e (187 vs 261 sent/s, beam-5 bench): with static
    # slices XLA hoists f32 upcasts of the cross-K/V out of the decode loop,
    # doubling per-step HBM reads, and loses the scan's async slice
    # prefetch. Kept as a knob for other backends/shapes.
    train_unroll_layers: bool = True  # teacher-forced encoder/decoder: python
    # loop over per-layer param slices instead of lax.scan over stacked
    # params. Scan's backward stacks every layer's residuals into [L, ...]
    # buffers (~15 ms/step at BART-base batch 128 on v5e); the unrolled
    # graph lets XLA place per-layer activations individually (measured
    # round-2: -7 ms/step). Costs a one-time longer compile, amortised by
    # the persistent compile cache. False restores the scan path (fast
    # cold-compile, e.g. for tests).
    beam_stationary_cache: bool = True  # beam decode: never permute the KV
    # cache; track beam ancestry in a [B*K, T] int32 matrix and gather the
    # right rows inside the fused self-attention
    # (ops/pallas_beam_attention.py). False falls back to the fused
    # permute-in-scan path (bart.decode_step reorder_idx).
    sample_radix_bits: int = 0  # beam-sampling top-k extraction: 0 (the
    # default) = greedy chunk-max walk; N>0 = radix select with N bits per
    # counting round (ops/topk.py radix_top_k). The radix path was built to
    # test round-3's bisected-kth-value sketch and REFUTED on v5e: its
    # 32/N counting rounds re-read the full [B*K, V] row each time, while
    # the greedy walk reads it once and then touches only [B*K, C] /
    # [B*K, chunk] tiles - measured 337 vs 257/189 sent/s (bits 1/2) on
    # beam-5 sampling at batch 96 (BASELINE.md round-4).

    def __post_init__(self):
        # frozen dataclass: normalise unhashable field values in place
        if isinstance(self.partial_load, list):
            object.__setattr__(self, "partial_load", tuple(self.partial_load))
        if isinstance(self.bad_words_ids, list):
            object.__setattr__(self, "bad_words_ids",
                               tuple(tuple(w) for w in self.bad_words_ids))
        if self.activation_function not in ("gelu", "relu", "gelu_new"):
            raise ValueError(f"unsupported activation: {self.activation_function}")

    # -- JSON round-trip, compatible with the reference's config.json files --

    @classmethod
    def from_dict(cls, d):
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in known})

    @classmethod
    def from_json(cls, path):
        with open(path) as f:
            return cls.from_dict(json.load(f))

    # alias mirroring the reference call-sites (pretrain.py:72-74)
    from_pretrained_dict = from_dict

    def to_dict(self):
        d = dataclasses.asdict(self)
        d["partial_load"] = list(self.partial_load)
        d["model_type"] = "multimodal_bart"
        return d

    def save_json(self, path):
        with open(path, "w") as f:
            json.dump(self.to_dict(), f, indent=2, sort_keys=True)

    def replace(self, **kwargs):
        return dataclasses.replace(self, **kwargs)

    @property
    def head_dim(self):
        assert self.d_model % self.encoder_attention_heads == 0
        return self.d_model // self.encoder_attention_heads


def bart_base_config(**overrides) -> MultiModalBartConfig:
    """BART-base sized config matching config/pretrain_base.json in the reference."""
    base = dict(
        d_model=768,
        encoder_layers=6,
        decoder_layers=6,
        encoder_attention_heads=12,
        decoder_attention_heads=12,
        encoder_ffn_dim=3072,
        decoder_ffn_dim=3072,
        num_labels=1601,
        num_attributes=129,
        num_relations=129,
        lm_loss_factor=5.0,
    )
    base.update(overrides)
    return MultiModalBartConfig(**base)


def bart_large_config(**overrides) -> MultiModalBartConfig:
    """BART-large dims (facebook/bart-large): the reference's partial-load
    path (src/model/mixins.py:511-530) accepts large checkpoints the same
    way as base; everything here (scan-stacked layers, beam-stationary
    decode, TP shardings) is dimension-agnostic."""
    base = dict(
        d_model=1024,
        encoder_layers=12,
        decoder_layers=12,
        encoder_attention_heads=16,
        decoder_attention_heads=16,
        encoder_ffn_dim=4096,
        decoder_ffn_dim=4096,
        num_labels=1601,
        num_attributes=129,
        num_relations=129,
        lm_loss_factor=5.0,
    )
    base.update(overrides)
    return MultiModalBartConfig(**base)


def tiny_config(**overrides) -> MultiModalBartConfig:
    """A tiny config for tests: 2 layers, small dims, toy vocab."""
    base = dict(
        vocab_size=128,
        d_model=32,
        encoder_layers=2,
        decoder_layers=2,
        encoder_attention_heads=4,
        decoder_attention_heads=4,
        encoder_ffn_dim=64,
        decoder_ffn_dim=64,
        max_position_embeddings=128,
        img_feat_id=90,
        cls_token_id=93,
        image_feature_size=20,
        num_labels=7,
        num_attributes=5,
        num_relations=5,
        dropout=0.0,
        max_img_num=4,
    )
    base.update(overrides)
    return MultiModalBartConfig(**base)
