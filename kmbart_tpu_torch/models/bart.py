"""BART trunk with the multimodal encoder, in PyTorch.

Counterpart of kmbart_tpu/models/bart.py. The parameters live in
``nn.Module`` containers whose state-dict names are the HF names that
``kmbart_tpu.checkpoint.torch_import.pytree_to_state_dict`` emits (``[out,
in]`` Linear weights, the shared embedding tied into both stacks); the
computation is plain functions over those modules, with the JAX package's
mixed-precision policy (ops/layers.py).

Training threads ``train`` and a ``torch.Generator`` through ``encode``,
``decode`` and ``forward``: dropout runs at every site the JAX package has
(embeddings, attention probs, both residual branches, the activation,
LayerDrop), drawing from the one generator in a fixed order.

Under tensor parallelism (``tp``, parallel/tp.py) each rank holds its
columns of q, k, v and fc1 and its rows of out_proj and fc2 and the layers
call the model axis's collectives; under sequence parallelism the stream
between them holds this rank's rows (parallel/sp.py). Pipeline
parallelism (parallel/pp.py) runs these same layer functions stage by
stage. Generation's decode step runs the tensor-parallel split too
(``decode_step_stationary``), each rank's cache holding its heads' columns.

Generation runs on the beam-stationary cache: self K/V rows are written
once into the writer beam's slot, in place, and never moved; the int32
ancestry says which slot holds each past position for each live beam, and
the self-attention kernel K3 gathers through it (ops/beam_attention.py).
"""

import math
import os

import numpy as np
import torch
from torch import nn

from kmbart_tpu_torch.config import MultiModalBartConfig
from kmbart_tpu_torch.ops.attention import multi_head_attention, padding_bias
from kmbart_tpu_torch.ops.beam_attention import beam_gather_attention
from kmbart_tpu_torch.ops.ffn import ffn
from kmbart_tpu_torch.ops.ffn import supported as ffn_supported
from kmbart_tpu_torch.ops.layers import (ACTIVATIONS, dense, dropout, layer_norm,
                                         matmul_f32, scale_as)
from kmbart_tpu_torch.parallel.tp import copy_to


def compute_dtype(cfg):
    return getattr(torch, cfg.dtype)


# --------------------------------------------------------------------------
# Parameter containers
# --------------------------------------------------------------------------

class Attention(nn.Module):
    def __init__(self, d):
        super().__init__()
        self.q_proj = nn.Linear(d, d)
        self.k_proj = nn.Linear(d, d)
        self.v_proj = nn.Linear(d, d)
        self.out_proj = nn.Linear(d, d)


class Layer(nn.Module):
    """An encoder layer, or a decoder layer when ``cross_attn``."""

    def __init__(self, d, ffn_dim, cross_attn):
        super().__init__()
        self.self_attn = Attention(d)
        self.self_attn_layer_norm = nn.LayerNorm(d)
        if cross_attn:
            self.encoder_attn = Attention(d)
            self.encoder_attn_layer_norm = nn.LayerNorm(d)
        self.fc1 = nn.Linear(d, ffn_dim)
        self.fc2 = nn.Linear(ffn_dim, d)
        self.final_layer_norm = nn.LayerNorm(d)


class ImageEmbedding(nn.Module):
    def __init__(self, feat, d):
        super().__init__()
        self.linear = nn.Linear(feat, d)


class Stack(nn.Module):
    """Encoder or decoder stack."""

    def __init__(self, cfg, shared, encoder):
        super().__init__()
        d = cfg.d_model
        n_pos = cfg.max_position_embeddings + (
            0 if cfg.static_position_embeddings else cfg.extra_pos_embeddings)
        self.embed_tokens = shared
        self.embed_positions = nn.Embedding(n_pos, d)
        if encoder:
            self.embed_images = ImageEmbedding(cfg.image_feature_size, d)
        if cfg.normalize_embedding:
            self.layernorm_embedding = nn.LayerNorm(d)
        n_layers = cfg.encoder_layers if encoder else cfg.decoder_layers
        ffn_dim = cfg.encoder_ffn_dim if encoder else cfg.decoder_ffn_dim
        self.layers = nn.ModuleList(Layer(d, ffn_dim, not encoder)
                                    for _ in range(n_layers))
        if (cfg.normalize_before if encoder else cfg.add_final_layer_norm):
            self.layer_norm = nn.LayerNorm(d)


class MultiModalBartModel(nn.Module):
    def __init__(self, cfg: MultiModalBartConfig):
        super().__init__()
        self.shared = nn.Embedding(cfg.vocab_size, cfg.d_model)
        self.encoder = Stack(cfg, self.shared, encoder=True)
        self.decoder = Stack(cfg, self.shared, encoder=False)


def _sinusoidal_table(n_pos, dim):
    """SinusoidalPositionalEmbedding weights (HF 3.0.2 layout: sin | cos)."""
    position = np.arange(n_pos)[:, None]
    div = np.exp(np.arange(0, dim, 2) * -(math.log(10000.0) / dim))
    out = np.zeros((n_pos, dim), dtype=np.float32)
    sentinel = dim // 2 if dim % 2 == 0 else (dim // 2) + 1
    out[:, :sentinel] = np.sin(position * div)
    out[:, sentinel:] = np.cos(position * div)
    return torch.from_numpy(out)


@torch.no_grad()
def init_bart_params_(model: MultiModalBartModel, cfg, generator):
    """Initialise in place like ``init_bart_params`` (bart.py:88):
    normal(0, init_std) weights and embeddings, zero biases, identity layer
    norms, a zero pad row; sinusoidal positions when static. The numbers
    differ from the JAX package's (another generator), the distribution
    does not."""
    std = cfg.init_std
    for mod in model.modules():
        if isinstance(mod, (nn.Linear, nn.Embedding)):
            mod.weight.normal_(0.0, std, generator=generator)
            if getattr(mod, "bias", None) is not None:
                mod.bias.zero_()
        elif isinstance(mod, nn.LayerNorm):
            mod.weight.fill_(1.0)
            mod.bias.zero_()
    if cfg.pad_token_id is not None:
        model.shared.weight[cfg.pad_token_id] = 0.0
    if cfg.static_position_embeddings:
        table = _sinusoidal_table(cfg.max_position_embeddings, cfg.d_model)
        model.encoder.embed_positions.weight.copy_(table)
        model.decoder.embed_positions.weight.copy_(table)


# --------------------------------------------------------------------------
# Embeddings
# --------------------------------------------------------------------------

def _ln(x, ln):
    return layer_norm(x, ln.weight, ln.bias, ln.eps)


# Inference on the card projects the ROI features in blocks of this many rows
# (the last block padded with zeros). cuBLAS picks its GEMM by the row count,
# and the one it picks at 960 rows (a 32-request admit of the serving pool)
# rounds otherwise than the one at 3360 (a batch of 112); a fixed count gives
# a row the same bits in whatever batch it comes (chip_smoke.py's
# serve_row_invariance line; the encoder's other GEMMs kept their bits
# between those batches there).
IMAGE_ROWS_BLOCK = 4096


def image_projection(model, image_features, dtype):
    """The ROI features projected to d_model: [B, N, F] -> [B, N, D]."""
    lin = model.encoder.embed_images.linear
    if not image_features.is_cuda or torch.is_grad_enabled():
        return dense(image_features, lin.weight, lin.bias, dtype)
    rows = image_features.reshape(-1, image_features.shape[-1])
    n = rows.shape[0]
    rows = torch.nn.functional.pad(rows, (0, 0, 0, -n % IMAGE_ROWS_BLOCK))
    out = torch.cat([dense(block, lin.weight, lin.bias, dtype)
                     for block in rows.split(IMAGE_ROWS_BLOCK)])
    return out[:n].reshape(*image_features.shape[:-1], -1)


def embed_multimodal(model, cfg, input_ids, image_features, dtype):
    """Token embeddings with projected ROI features spliced into the rows
    whose id is ``img_feat_id`` or ``cls_token_id``: the i-th such position
    of row b takes ``image_features[b, i]`` (cumsum slot, clipped).

    The lookup is a plain index, not ``nn.Embedding(padding_idx=...)``: the
    pad row gets a gradient, as ``jnp.take`` gives it one in JAX."""
    tok = model.shared.weight[input_ids]
    if image_features is None:
        return tok
    mask = (input_ids == cfg.img_feat_id) | (input_ids == cfg.cls_token_id)
    img = image_projection(model, image_features, dtype)             # [B, N, D]
    slot = torch.cumsum(mask.long(), dim=1) - 1
    slot = slot.clamp(0, image_features.shape[1] - 1)
    gathered = torch.take_along_dim(img, slot[..., None], dim=1)
    return torch.where(mask[..., None], gathered, tok)


def _positions(table, length, offset, start=0):
    if start + length + offset > table.shape[0]:
        raise ValueError(
            f"sequence length {start + length} exceeds max_position_embeddings "
            f"{table.shape[0] - offset}")
    return table[start + offset:start + offset + length]


def _pos_offset(cfg):
    return 0 if cfg.static_position_embeddings else cfg.extra_pos_embeddings


def _embed_scale(cfg):
    return math.sqrt(cfg.d_model) if cfg.scale_embedding else 1.0


def _encoder_embed(model, cfg, input_ids, image_features, train=False, generator=None):
    dtype = compute_dtype(cfg)
    T = input_ids.shape[1]
    x = embed_multimodal(model, cfg, input_ids, image_features, dtype) * _embed_scale(cfg)
    x = x + _positions(model.encoder.embed_positions.weight, T, _pos_offset(cfg))[None]
    if cfg.normalize_embedding:
        x = _ln(x, model.encoder.layernorm_embedding)
    return dropout(x, cfg.dropout, generator, train).to(dtype)


def _decoder_embed(model, cfg, token_ids, pos_start, train=False, generator=None):
    """``pos_start``: the first position (an int), or a tensor [rows] of
    per-row positions for a one-token step (the continuous pool, whose
    slots sit at their own depths; bart.py:364-368)."""
    dtype = compute_dtype(cfg)
    table = model.decoder.embed_positions.weight
    x = model.shared.weight[token_ids] * _embed_scale(cfg)
    if isinstance(pos_start, torch.Tensor):
        x = x + table[pos_start + _pos_offset(cfg)][:, None, :]
    else:
        x = x + _positions(table, token_ids.shape[1], _pos_offset(cfg), start=pos_start)[None]
    if cfg.normalize_embedding:
        x = _ln(x, model.decoder.layernorm_embedding)
    return dropout(x, cfg.dropout, generator, train).to(dtype)


# --------------------------------------------------------------------------
# Layers
# --------------------------------------------------------------------------

def _res_ln(residual, h, ln, tp=None):
    """LN(residual + h): every residual site, and so under sequence
    parallelism every place the stream holds this rank's rows alone
    (kmbart_tpu/models/bart.py:184 ``_res_ln``), where the norm's
    gradient is a part of the whole one."""
    if tp is not None:
        tp.mark(ln.weight, ln.bias)
    return _ln(residual + h, ln)


def _residual_ffn(x, layer, cfg, dtype, train=False, generator=None, tp=None):
    residual = x
    d = x.shape[-1]
    f = layer.fc1.weight.shape[0]
    if tp is not None:
        # column-parallel fc1, row-parallel fc2 with b2 added once after the
        # sum; K2 adds b2 in its body, so tensor parallelism takes the
        # composite path (the JAX CLIs turn K2 off there,
        # kmbart_tpu/cli_common.py:301-307)
        h = dense(tp.enter(x), layer.fc1.weight, layer.fc1.bias, dtype)
        h = ACTIVATIONS[cfg.activation_function](h)
        h = dropout(h, cfg.activation_dropout, tp.generator, train)
        h = tp.row(h, layer.fc2.weight, layer.fc2.bias, dtype)
        h = dropout(h, cfg.dropout, tp.stream_generator(generator), train)
        return _res_ln(residual, h, layer.final_layer_norm, tp)
    if (cfg.activation_function == "gelu" and dtype == torch.bfloat16
            and ffn_supported(d, f)
            and not (train and cfg.activation_dropout > 0.0)
            and os.environ.get("KMBART_NO_FUSED_FFN") != "1"):
        # fused kernel K2 (forward and backward): the [rows, ffn_dim]
        # activations stay on chip (pallas_ffn.py:320-339 gates the same,
        # KMBART_NO_FUSED_FFN=1 included)
        h = ffn(x.to(dtype).contiguous(), layer.fc1.weight, layer.fc1.bias,
                layer.fc2.weight, layer.fc2.bias)
    else:
        h = dense(x, layer.fc1.weight, layer.fc1.bias, dtype)
        h = ACTIVATIONS[cfg.activation_function](h)
        h = dropout(h, cfg.activation_dropout, generator, train)
        h = dense(h, layer.fc2.weight, layer.fc2.bias, dtype)
    h = dropout(h, cfg.dropout, generator, train)
    return _ln(residual + h, layer.final_layer_norm)


def _encoder_layer(x, layer, key_mask, cfg, dtype, train=False, generator=None, tp=None):
    """One encoder layer; ``tp``: tensor parallelism inside the stack
    (parallel/tp.py ``Stack``), under which ``x`` is this rank's rows when
    the stack is sequence parallel."""
    drop = dict(dropout_rate=cfg.attention_dropout, generator=generator, train=train, tp=tp)
    stream = generator if tp is None else tp.stream_generator(generator)
    h = multi_head_attention(layer.self_attn, x, key_mask=key_mask,
                             num_heads=cfg.encoder_attention_heads, dtype=dtype, **drop)
    h = dropout(h, cfg.dropout, stream, train)
    x = _res_ln(x, h, layer.self_attn_layer_norm, tp)
    return _residual_ffn(x, layer, cfg, dtype, train, generator, tp)


def _decoder_layer(x, layer, enc_hidden, cfg, dtype, self_key_mask, cross_key_mask,
                   train=False, generator=None, tp=None):
    """One teacher-forced decoder layer; ``tp`` as in ``_encoder_layer``, with
    ``enc_hidden`` already entered (``decode``)."""
    H = cfg.decoder_attention_heads
    drop = dict(dropout_rate=cfg.attention_dropout, generator=generator, train=train, tp=tp)
    stream = generator if tp is None else tp.stream_generator(generator)
    h = multi_head_attention(layer.self_attn, x, key_mask=self_key_mask,
                             num_heads=H, dtype=dtype, causal=True, **drop)
    h = dropout(h, cfg.dropout, stream, train)
    x = _res_ln(x, h, layer.self_attn_layer_norm, tp)
    h = multi_head_attention(layer.encoder_attn, x, kv_hidden=enc_hidden,
                             key_mask=cross_key_mask, num_heads=H, dtype=dtype, **drop)
    h = dropout(h, cfg.dropout, stream, train)
    x = _res_ln(x, h, layer.encoder_attn_layer_norm, tp)
    return _residual_ffn(x, layer, cfg, dtype, train, generator, tp)


def _layer_dropped(p, generator, train):
    """HF LayerDrop (bart.py:285-290): skip a layer with probability p when
    training. The draw is read on the host, so it costs a sync, and only
    when p > 0 (VCG's configs have 0)."""
    if not train or p == 0.0 or generator is None:
        return False
    return bool(torch.rand((), generator=generator, device=generator.device) < p)


# --------------------------------------------------------------------------
# Encoder / decoder
# --------------------------------------------------------------------------

def encode(model, cfg, input_ids, image_features=None, attention_mask=None, *,
           train=False, generator=None, tp=None):
    """Multimodal encoder forward: [B, T, D] in the compute dtype. ``tp``:
    tensor parallelism (parallel/tp.py ``TensorParallel``) on this rank's
    part of the model; the output is whole on every rank."""
    dtype = compute_dtype(cfg)
    x = _encoder_embed(model, cfg, input_ids, image_features, train, generator)
    stack = None if tp is None else tp.stack(x.shape[1], generator, salt=1)
    if stack is not None:
        x = stack.begin(x)
    for layer in model.encoder.layers:
        if not _layer_dropped(cfg.encoder_layerdrop, generator, train):
            x = _encoder_layer(x, layer, attention_mask, cfg, dtype, train, generator, stack)
    if stack is not None:
        x = stack.end(x)
    if cfg.normalize_before:
        x = _ln(x, model.encoder.layer_norm)
    return x


def decode(model, cfg, decoder_input_ids, enc_hidden, enc_attention_mask=None,
           decoder_attention_mask=None, *, train=False, generator=None, tp=None):
    """Teacher-forced decoder forward: [B, T, D] in the compute dtype; ``tp``
    as in ``encode``."""
    dtype = compute_dtype(cfg)
    x = _decoder_embed(model, cfg, decoder_input_ids, 0, train, generator)
    stack = None if tp is None else tp.stack(x.shape[1], generator, salt=2)
    if stack is not None:
        # every layer's k/v projections read the encoder output: its
        # gradient parts are summed once, here
        enc_hidden = copy_to(enc_hidden, tp.axis)
        x = stack.begin(x)
    for layer in model.decoder.layers:
        if not _layer_dropped(cfg.decoder_layerdrop, generator, train):
            x = _decoder_layer(x, layer, enc_hidden, cfg, dtype, decoder_attention_mask,
                               enc_attention_mask, train, generator, stack)
    if stack is not None:
        x = stack.end(x)
    if cfg.add_final_layer_norm:
        x = _ln(x, model.decoder.layer_norm)
    return x


def forward(model, cfg, input_ids, image_features=None, attention_mask=None,
            decoder_input_ids=None, decoder_attention_mask=None, *, train=False,
            generator=None, tp=None):
    """Trunk forward: (decoder_hidden, encoder_hidden), whole on every rank
    under tensor parallelism (``tp``)."""
    enc = encode(model, cfg, input_ids, image_features, attention_mask, train=train,
                 generator=generator, tp=tp)
    dec = decode(model, cfg, decoder_input_ids, enc, enc_attention_mask=attention_mask,
                 decoder_attention_mask=decoder_attention_mask, train=train,
                 generator=generator, tp=tp)
    return dec, enc


def lm_logits(model, cfg, hidden, final_logits_bias=None, logits_dtype=torch.float32):
    """Tied LM head: hidden @ shared.T (+ final_logits_bias, which gets no
    gradient: a buffer, as in transformers 3.0.2), rounded to
    ``logits_dtype`` (fp32 for decoding, the compute dtype for the loss)."""
    logits = matmul_f32(hidden, model.shared.weight, compute_dtype(cfg))
    if final_logits_bias is not None:
        logits = logits + final_logits_bias.detach().reshape(-1).float()
    return logits.to(logits_dtype)


def shift_tokens_right(input_ids, pad_token_id):
    """HF 3.0.2 BART shift: wrap the last non-pad token to position 0."""
    T = input_ids.shape[1]
    idx = torch.argmax((input_ids != pad_token_id).flip(1).int(), dim=1)
    last = T - 1 - idx
    out = torch.roll(input_ids, 1, dims=1)
    out[:, 0] = torch.gather(input_ids, 1, last[:, None])[:, 0]
    return out


# --------------------------------------------------------------------------
# Incremental decode over the beam-stationary cache
# --------------------------------------------------------------------------

def init_decode_cache_layers(model, cfg, enc_hidden, max_len, num_beams, tp=None):
    """Per-layer decode cache: a list of L dicts {self_k, self_v
    [B, num_beams, max_len, D] zeros; cross_k, cross_v [B, Tenc, D]
    projected once from the encoder output}, in the compute dtype.

    Under tensor parallelism (``tp``, parallel/tp.py ``TensorParallel``, on
    this rank's part of the model) D is the rank's D/tp columns: the self
    K/V of its heads, and the cross K/V from its rows of k_proj and v_proj
    (kmbart_tpu/parallel/tp.py:21-34 ``_LAYER_RULES``)."""
    dtype = compute_dtype(cfg)
    B = enc_hidden.shape[0]
    D = cfg.d_model if tp is None else cfg.d_model // tp.size
    caches = []
    for layer in model.decoder.layers:
        ea = layer.encoder_attn
        caches.append({
            "self_k": torch.zeros((B, num_beams, max_len, D), dtype=dtype,
                                  device=enc_hidden.device),
            "self_v": torch.zeros((B, num_beams, max_len, D), dtype=dtype,
                                  device=enc_hidden.device),
            "cross_k": dense(enc_hidden, ea.k_proj.weight, ea.k_proj.bias, dtype),
            "cross_v": dense(enc_hidden, ea.v_proj.weight, ea.v_proj.bias, dtype),
        })
    return caches


def decode_step_stationary(model, cfg, token_ids, caches, cache_index, ancestry,
                           enc_attention_mask=None, num_beams=1, seq_positions=None,
                           valid_counts=None, tp=None):
    """One incremental decoder step over the beam-stationary cache.

    token_ids [B·K, 1]; caches from ``init_decode_cache_layers`` (updated
    in place); cache_index: this step's position, the column its K/V are
    written at; ancestry int32 [B·K, T] with this step's own slot already
    written at cache_index.

    The continuous pool's ring cache passes ``seq_positions`` (int [B·K],
    each row's own position, for the position embedding) and
    ``valid_counts`` (int32 [B], each sample's window length including this
    step); cache_index is then the ring column every slot writes this tick
    (continuous.py:20-29), and K3 reads each window in ring mode.

    ``tp``: tensor parallelism, the caches made with the same ``tp``. Each
    rank runs K3 and the cross-attention at its H/tp heads, both
    out_proj and fc2 are row-parallel (the parts summed over the model axis
    in fp32, then the bias once), and the FFN takes the composite path (K2
    adds b2 inside its body).
    Returns hidden [B·K, 1, D] in the compute dtype, whole on every rank.
    """
    dtype = compute_dtype(cfg)
    # sequence parallelism never splits a one-token step: tp.stack keeps the
    # stream whole where the length does not split over the model axis
    stack = None if tp is None else tp.stack(1)
    H = cfg.decoder_attention_heads if stack is None else stack.heads(
        cfg.decoder_attention_heads)
    B, K, _, D = caches[0]["self_k"].shape
    head_dim = cfg.d_model // cfg.decoder_attention_heads
    if D != H * head_dim:
        raise ValueError(f"decode cache of {D} columns for {H} heads of {head_dim}: the "
                         "cache and the head count must both be this rank's")
    out_proj = dense if stack is None else stack.row
    x = _decoder_embed(model, cfg, token_ids,
                       cache_index if seq_positions is None else seq_positions)
    cross_bias = (None if enc_attention_mask is None
                  else padding_bias(enc_attention_mask))
    for layer, cache in zip(model.decoder.layers, caches):
        sa = layer.self_attn
        w = torch.cat([sa.q_proj.weight, sa.k_proj.weight, sa.v_proj.weight])
        b = torch.cat([sa.q_proj.bias, sa.k_proj.bias, sa.v_proj.bias])
        q, k_new, v_new = dense(x, w, b, dtype).chunk(3, dim=-1)    # [BK, 1, D]
        q_flat = scale_as(q[:, 0, :], head_dim ** -0.5).contiguous()
        # In place, where the JAX package returns a new buffer from
        # dynamic_update_slice (bart.py:612-617): each step writes only its
        # own row per beam slot, so the cache is never copied.
        cache["self_k"][:, :, cache_index] = k_new.reshape(B, K, D)
        cache["self_v"][:, :, cache_index] = v_new.reshape(B, K, D)
        attn = beam_gather_attention(q_flat, cache["self_k"], cache["self_v"],
                                     ancestry, cache_index, num_beams=num_beams,
                                     num_heads=H, valid_counts=valid_counts)
        h = out_proj(attn[:, None, :], sa.out_proj.weight, sa.out_proj.bias, dtype)
        x = _ln(x + h, layer.self_attn_layer_norm)
        h = multi_head_attention(layer.encoder_attn, x, bias=cross_bias,
                                 num_heads=cfg.decoder_attention_heads, dtype=dtype,
                                 cross_cache={"k": cache["cross_k"], "v": cache["cross_v"]},
                                 tp=stack)
        x = _ln(x + h, layer.encoder_attn_layer_norm)
        x = _residual_ffn(x, layer, cfg, dtype, tp=stack)
    if cfg.add_final_layer_norm:
        x = _ln(x, model.decoder.layer_norm)
    return x
