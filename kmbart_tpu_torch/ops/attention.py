"""Multi-head attention for the BART encoder and decoder.

Counterpart of kmbart_tpu/ops/attention.py: queries scaled by
head_dim**-0.5 before the QK product, additive -1e9 masking, softmax in
fp32, then the output projection; matmul operands in the compute dtype with
fp32 accumulation; attention-prob dropout when training.

Self-attention and cross-attention without a cache, under a key-padding or
causal mask and with no attention-prob dropout active, go where the JAX
package sends them on the TPU (ops/attention.py:110-130 and 186-197): to
the fused kernel K1 (ops/train_attention.py, forward and backward) when the
whole score row fits on chip (Tq, Tk <= 256) and there are at most
``KMBART_FUSED_ATTN_HEADS_MAX`` heads (default 12), unless
``KMBART_NO_FUSED_ATTN=1`` (pallas_train_attention.py:409-433; both read
at call time); otherwise to the flash kernel K11 (ops/flash_attention.py)
when Tq·Tk >= 128² and the lengths and head_dim are multiples of 8;
otherwise to the composite. Decode-time
cross-attention over precomputed K/V folds a sample's beam group into the
query axis, so each sample's encoder K/V is read once rather than once per
beam.
"""

import os

import torch

from kmbart_tpu_torch.ops.flash_attention import flash_self_attention
from kmbart_tpu_torch.ops.flash_attention import supported as flash_supported
from kmbart_tpu_torch.ops.layers import dense, dropout, scale_as
from kmbart_tpu_torch.ops.train_attention import supported, train_attention

NEG_INF = -1e9


def k1_enabled(num_heads):
    """The switches of the JAX gate (pallas_train_attention.py:412,426):
    ``KMBART_NO_FUSED_ATTN=1`` turns K1 off, and more heads than
    ``KMBART_FUSED_ATTN_HEADS_MAX`` (default 12) take the other paths."""
    if os.environ.get("KMBART_NO_FUSED_ATTN") == "1":
        return False
    return num_heads <= int(os.environ.get("KMBART_FUSED_ATTN_HEADS_MAX", "12"))


def split_heads(x, num_heads):
    b, t, d = x.shape
    return x.reshape(b, t, num_heads, d // num_heads)


def merge_heads(x):
    b, t, h, hd = x.shape
    return x.reshape(b, t, h * hd)


def attention_core(q, k, v, bias=None, *, dropout_rate=0.0, generator=None,
                   train=False, dtype=torch.bfloat16):
    """Scaled dot-product attention. q [B, Tq, H, hd]; k, v [B, Tk, H, hd];
    bias additive fp32 broadcastable to [B, H, Tq, Tk]. Scores and softmax
    in fp32 from operands rounded to ``dtype``, dropout on the fp32 probs;
    returns [B, Tq, H, hd] in ``dtype``."""
    hd = q.shape[-1]
    q = scale_as(q, hd ** -0.5).to(dtype).float()
    s = torch.einsum("bqhd,bkhd->bhqk", q, k.to(dtype).float())
    if bias is not None:
        s = s + bias
    probs = dropout(torch.softmax(s, dim=-1), dropout_rate, generator, train)
    out = torch.einsum("bhqk,bkhd->bqhd", probs.to(dtype).float(),
                       v.to(dtype).float())
    return out.to(dtype)


def padding_bias(attention_mask):
    """[B, Tk] 1/0 mask -> additive fp32 [B, 1, 1, Tk] bias."""
    return torch.where(attention_mask[:, None, None, :].bool(), 0.0, NEG_INF).float()


def causal_bias(q_len, k_len, device):
    """Additive [1, 1, Tq, Tk] bias; query i attends keys <= i."""
    q_pos = torch.arange(q_len, device=device)[:, None]
    k_pos = torch.arange(k_len, device=device)[None, :]
    return torch.where(k_pos <= q_pos, 0.0, NEG_INF).float()[None, None]


def multi_head_attention(attn, hidden, kv_hidden=None, bias=None, *, num_heads,
                         dtype=torch.bfloat16, cross_cache=None, key_mask=None,
                         causal=False, dropout_rate=0.0, generator=None, train=False,
                         self_cache=None, cache_index=None):
    """Attention block: projections, core, output projection.

    attn: a module with ``q_proj``, ``k_proj``, ``v_proj``, ``out_proj``
    (``nn.Linear``, [out, in] weights). kv_hidden: source of K/V for
    cross-attention (default: ``hidden``). cross_cache: precomputed flat
    cross K/V {"k", "v": [B, Tk, D]} for a decode step, whose batch may
    divide the query batch (beam search). ``dropout_rate`` applies to the
    attention probs when ``train``, drawing from ``generator``. Returns
    [B, Tq, D] in ``dtype``.

    self_cache: a flat incremental self-attention cache {"k", "v": [B, T,
    D]} (kmbart_tpu/ops/attention.py:173-179, GPT's decode step): the new
    K/V rows are written in place at ``cache_index`` and attention runs over
    the whole static buffer under the caller's ``bias``, which must mask the
    positions past the last one written. The BART paths never pass it.
    """
    core = dict(dropout_rate=dropout_rate, generator=generator, train=train, dtype=dtype)
    if kv_hidden is None and cross_cache is None:
        # self-attention: one fused QKV matmul instead of three
        w = torch.cat([attn.q_proj.weight, attn.k_proj.weight, attn.v_proj.weight])
        b = torch.cat([attn.q_proj.bias, attn.k_proj.bias, attn.v_proj.bias])
        q_flat, k_flat, v_flat = dense(hidden, w, b, dtype).chunk(3, dim=-1)
    else:
        q_flat = dense(hidden, attn.q_proj.weight, attn.q_proj.bias, dtype)
        k_flat = v_flat = None

    def project_kv():
        src = kv_hidden
        return (dense(src, attn.k_proj.weight, attn.k_proj.bias, dtype),
                dense(src, attn.v_proj.weight, attn.v_proj.bias, dtype))

    if (bias is None and cross_cache is None and self_cache is None
            and (key_mask is not None or causal)
            and not (train and dropout_rate > 0.0)):
        Tq = hidden.shape[1]
        Tk = Tq if kv_hidden is None else kv_hidden.shape[1]
        hd = hidden.shape[-1] // num_heads
        fused = None
        if supported(Tq, Tk, hd) and k1_enabled(num_heads) and (Tq == Tk or not causal):
            fused = train_attention
        elif flash_supported(Tq, Tk, hd, causal):
            fused = flash_self_attention   # fp32 out; dense rounds it to dtype
        if fused is not None:
            if k_flat is None:
                k_flat, v_flat = project_kv()
            # K1 and K11 read the fused QKV chunks by row stride, without a copy
            out = fused(q_flat, k_flat, v_flat, key_mask, num_heads=num_heads, causal=causal)
            return dense(out, attn.out_proj.weight, attn.out_proj.bias, dtype)

    q = split_heads(q_flat, num_heads)
    if cross_cache is not None:
        k = split_heads(cross_cache["k"], num_heads)
        v = split_heads(cross_cache["v"], num_heads)
        group = q.shape[0] // k.shape[0]
        if group > 1:
            bq, tq, nh, hd = q.shape
            assert tq == 1, "grouped cross-attention requires Tq == 1"
            q = q.reshape(bq // group, group, nh, hd)
            out = attention_core(q, k, v, bias, **core).reshape(bq, 1, nh, hd)
            return dense(merge_heads(out), attn.out_proj.weight,
                         attn.out_proj.bias, dtype)
    else:
        if k_flat is None:
            k_flat, v_flat = project_kv()
        if self_cache is not None:
            end = cache_index + k_flat.shape[1]
            self_cache["k"][:, cache_index:end] = k_flat
            self_cache["v"][:, cache_index:end] = v_flat
            k_flat, v_flat = self_cache["k"], self_cache["v"]
        k = split_heads(k_flat, num_heads)
        v = split_heads(v_flat, num_heads)

    if bias is None and (key_mask is not None or causal):
        bias = 0.0 if key_mask is None else padding_bias(key_mask)
        if causal:
            bias = bias + causal_bias(q.shape[1], k.shape[1], q.device)
    out = attention_core(q, k, v, bias, **core)
    return dense(merge_heads(out), attn.out_proj.weight, attn.out_proj.bias, dtype)
