"""GPT-1 style decoder-only LM in PyTorch (the COMET trunk).

Counterpart of kmbart_tpu/knowledge/gpt.py: OpenAI GPT (post-LN blocks)
whose position ids are extra rows of the embedding table (rows n_vocab ..
n_vocab + n_ctx - 1), summed with the token rows. The parameters live in
``nn.Module`` containers, as the BART trunk's do ([out, in] Linear
weights); the computation is plain functions with the JAX package's mixed
precision (ops/layers.py). The embedding sum and the residual stream stay
fp32, as the JAX program's do.

The full forward passes an explicit causal bias, so its attention takes the
composite path (never a fused kernel), as in JAX. The decode step keeps a
flat [L, B, T, D] K/V cache, written in place at ``cache_index``, and
attends over the whole static buffer under a bias that masks the positions
not yet written (ops/attention.py ``self_cache``).
"""

import numpy as np
import torch
from torch import nn

from kmbart_tpu_torch.device import resolve_device
from kmbart_tpu_torch.models.bart import Attention
from kmbart_tpu_torch.ops.attention import NEG_INF, causal_bias, multi_head_attention
from kmbart_tpu_torch.ops.layers import dense, gelu, layer_norm, matmul_f32


class Block(nn.Module):
    def __init__(self, d):
        super().__init__()
        self.attn = Attention(d)
        self.ln_1 = nn.LayerNorm(d)
        self.c_fc = nn.Linear(d, 4 * d)
        self.c_proj = nn.Linear(4 * d, d)
        self.ln_2 = nn.LayerNorm(d)


class GPTModel(nn.Module):
    def __init__(self, n_vocab, n_ctx, d_model=768, n_layers=12, n_heads=12):
        super().__init__()
        self.n_vocab, self.n_ctx, self.n_heads = n_vocab, n_ctx, n_heads
        self.embed = nn.Embedding(n_vocab + n_ctx, d_model)
        self.h = nn.ModuleList(Block(d_model) for _ in range(n_layers))


@torch.no_grad()
def init_gpt_model(n_vocab, n_ctx, d_model=768, n_layers=12, n_heads=12, init_std=0.02,
                   seed=0, device="cuda"):
    """normal(0, init_std) weights and embeddings, zero biases, identity
    layer norms, drawn from a ``torch.Generator`` seeded with ``seed``; on
    ``device`` (the card unless the caller asks for the CPU), in eval mode
    and without gradients (the port only generates with it)."""
    device = resolve_device(device)
    model = GPTModel(n_vocab, n_ctx, d_model, n_layers, n_heads)
    gen = torch.Generator().manual_seed(seed)
    for mod in model.modules():
        if isinstance(mod, (nn.Linear, nn.Embedding)):
            mod.weight.normal_(0.0, init_std, generator=gen)
            if getattr(mod, "bias", None) is not None:
                mod.bias.zero_()
    return model.requires_grad_(False).to(device).eval()


def _block(x, block, bias, n_heads, dtype, cache=None, cache_index=None):
    """Post-LN block: x = ln1(x + attn(x)); x = ln2(x + mlp(x))."""
    a = multi_head_attention(block.attn, x, bias=bias, num_heads=n_heads, dtype=dtype,
                             self_cache=cache, cache_index=cache_index)
    x = layer_norm(x + a, block.ln_1.weight, block.ln_1.bias)
    m = dense(gelu(dense(x, block.c_fc.weight, block.c_fc.bias, dtype)),
              block.c_proj.weight, block.c_proj.bias, dtype)
    return layer_norm(x + m, block.ln_2.weight, block.ln_2.bias)


def gpt_forward(model, token_ids, dtype=torch.bfloat16):
    """Full forward: token_ids [B, T] -> hidden [B, T, D] (fp32)."""
    T = token_ids.shape[1]
    table = model.embed.weight
    pos = torch.arange(T, device=table.device) + model.n_vocab
    x = table[token_ids.long()] + table[pos][None]
    bias = causal_bias(T, T, table.device)
    for block in model.h:
        x = _block(x, block, bias, model.n_heads, dtype)
    return x


def gpt_logits(model, hidden, dtype=torch.bfloat16):
    """Tied LM head over the token rows only: fp32 [..., n_vocab]."""
    return matmul_f32(hidden, model.embed.weight[: model.n_vocab], dtype)


def init_gpt_cache(model, batch, max_len, dtype=torch.bfloat16):
    """Flat (pre-head-split) K/V storage {"k", "v": [L, B, max_len, D]}."""
    L, D = len(model.h), model.embed.weight.shape[1]
    zeros = lambda: torch.zeros((L, batch, max_len, D), dtype=dtype,
                                device=model.embed.weight.device)
    return {"k": zeros(), "v": zeros()}


def gpt_step(model, token_ids, cache, cache_index, dtype=torch.bfloat16):
    """Incremental step: token_ids [B, 1] at position ``cache_index`` (an
    int). Writes that position's K/V into ``cache`` in place; returns
    (hidden [B, 1, D], cache)."""
    table = model.embed.weight
    x = table[token_ids.long()] + table[model.n_vocab + cache_index][None, None]
    key_pos = torch.arange(cache["k"].shape[2], device=table.device)
    bias = torch.where(key_pos <= cache_index, 0.0, NEG_INF).float()[None, None, None]
    for layer, block in enumerate(model.h):
        x = _block(x, block, bias, model.n_heads, dtype,
                   cache={"k": cache["k"][layer], "v": cache["v"][layer]},
                   cache_index=cache_index)
    return x, cache


@torch.no_grad()
def import_openai_gpt_state_dict(sd, model):
    """Copy a COMET/openai-gpt state dict into ``model`` (in place).

    openai-gpt's Conv1D stores weights [in, out] (transposed here to the
    Linear layout) and ``c_attn`` packs q|k|v along the output dim; the
    embedding's first rows are overwritten up to the smaller table. Returns
    (model, ok): ok is False, and the blocks untouched, when the state dict
    has no ``c_attn`` for a layer."""
    def get(*names):
        for n in names:
            if n in sd:
                return torch.tensor(np.asarray(sd[n], np.float32))
        return None

    embed = get("transformer.tokens_embed.weight", "tokens_embed.weight",
                "transformer.embed.weight", "embed.weight")
    table = model.embed.weight
    if embed is not None:
        n = min(embed.shape[0], table.shape[0])
        table[:n] = embed[:n].to(table.device)
    D = table.shape[1]
    loaded = []
    for i in range(len(model.h)):
        g = lambda name: get(f"transformer.h.{i}.{name}", f"h.{i}.{name}")
        if g("attn.c_attn.weight") is None:
            return model, False
        w, b = g("attn.c_attn.weight"), g("attn.c_attn.bias")
        loaded.append({
            "attn.q_proj.weight": w[:, :D].T, "attn.q_proj.bias": b[:D],
            "attn.k_proj.weight": w[:, D:2 * D].T, "attn.k_proj.bias": b[D:2 * D],
            "attn.v_proj.weight": w[:, 2 * D:].T, "attn.v_proj.bias": b[2 * D:],
            "attn.out_proj.weight": g("attn.c_proj.weight").T,
            "attn.out_proj.bias": g("attn.c_proj.bias"),
            "c_fc.weight": g("mlp.c_fc.weight").T, "c_fc.bias": g("mlp.c_fc.bias"),
            "c_proj.weight": g("mlp.c_proj.weight").T, "c_proj.bias": g("mlp.c_proj.bias"),
            "ln_1.weight": g("ln_1.weight"), "ln_1.bias": g("ln_1.bias"),
            "ln_2.weight": g("ln_2.weight"), "ln_2.bias": g("ln_2.bias"),
        })
    for block, tensors in zip(model.h, loaded):
        block.load_state_dict({k: v.contiguous() for k, v in tensors.items()})
    return model, True


def gpt_params_from_jax(params, n_heads=12, device="cuda"):
    """The JAX package's GPT pytree (``init_gpt_params``: [in, out] kernels
    stacked over layers) -> a ``GPTModel`` carrying the same weights, in
    eval mode on ``device`` (the card unless the caller asks for the CPU)."""
    a = lambda x: torch.tensor(np.asarray(x, np.float32))
    lp = params["layers"]
    L, D = np.shape(lp["attn"]["q_kernel"])[:2]
    model = GPTModel(int(params["n_vocab"]), int(params["n_ctx"]), D, L, n_heads)
    sd = {"embed.weight": a(params["embed"])}
    for i in range(L):
        pre = f"h.{i}."
        for ours, theirs in (("q_proj", "q"), ("k_proj", "k"), ("v_proj", "v"),
                             ("out_proj", "o")):
            sd[pre + f"attn.{ours}.weight"] = a(lp["attn"][f"{theirs}_kernel"][i]).T
            sd[pre + f"attn.{ours}.bias"] = a(lp["attn"][f"{theirs}_bias"][i])
        for ours, theirs in (("c_fc", "fc"), ("c_proj", "proj")):
            sd[pre + f"{ours}.weight"] = a(lp[f"{theirs}_kernel"][i]).T
            sd[pre + f"{ours}.bias"] = a(lp[f"{theirs}_bias"][i])
        for ln in ("ln1", "ln2"):
            sd[pre + f"ln_{ln[-1]}.weight"] = a(lp[ln]["scale"][i])
            sd[pre + f"ln_{ln[-1]}.bias"] = a(lp[ln]["bias"][i])
    model.load_state_dict({k: v.contiguous() for k, v in sd.items()})
    return model.requires_grad_(False).to(resolve_device(device)).eval()
