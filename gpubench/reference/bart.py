"""Plain PyTorch KM-BART: the benchmark's reference.

The multimodal BART of KM-BART (arXiv:2101.00419) in float32 with no
kernels, no cache and no batching tricks, written from the published
description: HF transformers 3.0.2 BART (post-norm layers, learned positions
offset by 2, a layer norm on the embeddings, exact-erf GELU, the LM head
tied to the shared embedding plus ``final_logits_bias``) with KM-BART's
image splice (the i-th position whose id is ``img_feat_id`` or
``cls_token_id`` takes the i-th projected ROI feature) and its four
pretraining heads (masked-region KL, attribute and relation
classification, each a dense-tanh-dense head).

Two departures from HF, both as the KM-BART system states them: the token
lookup is a plain index, so the pad row gets a gradient, and masking adds
-1e9 rather than -inf.

``Precision`` rounds every matrix product's operands and the activations
between layers where a bf16 system holds them in its compute dtype (the
embeddings, each normed residual stream, each attention output): "fp32"
leaves them alone (TF32 is turned off by the caller), "fp8" rounds each to
float8 e4m3 with one scale per tensor (the control: the step below the
bf16 that the configurations state). Gradients pass through the rounding
unchanged.

Dropout is inverted dropout whose keep masks are drawn by ``Dropout`` from
a ``torch.Generator``, one ``torch.rand`` over the whole batch per site in
the order of the forward pass (embeddings, then each layer's attention and
feed-forward outputs, encoder first), so that a run of the system and this
reference drop the same units when both draw from one seeded generator.

Nothing here imports the system under test or JAX.
"""

import math

import torch

NEG = -1e9


class Precision:
    def __init__(self, name="fp32"):
        if name not in ("fp32", "fp8"):
            raise ValueError(f"unknown precision {name!r}")
        self.name = name

    def q(self, t):
        if self.name == "fp32":
            return t
        scale = t.detach().abs().amax().clamp(min=1e-30) / 448.0
        r = (t.detach() / scale).to(torch.float8_e4m3fn).float() * scale
        return t + (r - t.detach())

    act = q

    def mm(self, a, b):
        return self.q(a) @ self.q(b)

    def linear(self, x, w, b=None):
        y = self.q(x) @ self.q(w).t()
        return y if b is None else y + b


class Dropout:
    """Masks drawn in forward order: ``draw`` draws one keep mask per site
    shape from a generator; ``apply(x)`` takes the next one. ``rows``
    restricts the masks to a block of the batch."""

    def __init__(self, rate, masks=None, rows=None):
        self.rate = rate
        self._masks, self._i, self.rows = masks, 0, rows

    @staticmethod
    def draw(rate, generator, shapes, device):
        return [torch.rand(s, generator=generator, device=device) >= rate for s in shapes]

    def apply(self, x):
        if self._masks is None or self.rate == 0.0:
            return x
        m = self._masks[self._i]
        self._i += 1
        if self.rows is not None:
            m = m[self.rows]
        return torch.where(m, x / (1.0 - self.rate), 0.0)


def dropout_sites(cfg, B, T_enc, T_dec):
    """The shapes of the dropout sites in forward order."""
    D = cfg["d_model"]
    enc = [(B, T_enc, D)] * (1 + 2 * cfg["encoder_layers"])
    dec = [(B, T_dec, D)] * (1 + 3 * cfg["decoder_layers"])
    return enc + dec


def param_specs(cfg, heads=False):
    """[(name, shape, init)] with init "normal" (N(0, init_std)), "zeros"
    or "ones", in the HF state-dict names of the KM-BART models."""
    D, V = cfg["d_model"], cfg["vocab_size"]
    n_pos = cfg["max_position_embeddings"] + cfg["extra_pos_embeddings"]
    specs = [("model.shared.weight", (V, D), "normal")]

    def lin(name, o, i):
        specs.extend([(name + ".weight", (o, i), "normal"), (name + ".bias", (o,), "zeros")])

    def ln(name):
        specs.extend([(name + ".weight", (D,), "ones"), (name + ".bias", (D,), "zeros")])

    for stack in ("encoder", "decoder"):
        p = f"model.{stack}"
        specs.append((p + ".embed_positions.weight", (n_pos, D), "normal"))
        if stack == "encoder":
            lin(p + ".embed_images.linear", D, cfg["image_feature_size"])
        ln(p + ".layernorm_embedding")
        F = cfg[f"{stack}_ffn_dim"]
        for i in range(cfg[f"{stack}_layers"]):
            lp = f"{p}.layers.{i}"
            attns = ("self_attn", "encoder_attn") if stack == "decoder" else ("self_attn",)
            for a in attns:
                for proj in ("q_proj", "k_proj", "v_proj", "out_proj"):
                    lin(f"{lp}.{a}.{proj}", D, D)
                ln(f"{lp}.{a}_layer_norm")
            lin(lp + ".fc1", F, D)
            lin(lp + ".fc2", D, F)
            ln(lp + ".final_layer_norm")
    if heads:
        for name, i, n in (("mrm_head", D, cfg["num_labels"]),
                           ("attribute_head", D, cfg["num_attributes"]),
                           ("relation_head", 2 * D, cfg["num_relations"])):
            lin(name + ".dense", D, i)
            lin(name + ".out_proj", n, D)
    return specs


def make_params(cfg, seed, device, heads=False):
    """The weights as the benchmark makes them from ``seed``: one normal
    draw on ``device`` for every "normal" tensor (in spec order), zeros and
    ones for biases and norms, the pad row of the embedding zero. Returns
    (flat fp32 buffer, {name: view})."""
    specs = param_specs(cfg, heads)
    total = sum(math.prod(s) for _, s, _ in specs)
    flat = torch.empty(total, dtype=torch.float32, device=device)
    normal = sum(math.prod(s) for _, s, k in specs if k == "normal")
    g = torch.Generator(device=device).manual_seed(seed)
    draws = torch.randn(normal, generator=g, device=device).mul_(cfg["init_std"])
    out, off, noff = {}, 0, 0
    for name, shape, kind in specs:
        n = math.prod(shape)
        view = flat[off:off + n].view(shape)
        if kind == "normal":
            view.copy_(draws[noff:noff + n].view(shape))
            noff += n
        else:
            view.fill_(1.0 if kind == "ones" else 0.0)
        out[name] = view
        off += n
    del draws
    out["model.shared.weight"][cfg["pad_token_id"]] = 0.0
    return flat, out


def gelu(x):
    return 0.5 * x * (1.0 + torch.erf(x / math.sqrt(2.0)))


def layer_norm(x, P, name, eps=1e-5):
    return torch.nn.functional.layer_norm(x, x.shape[-1:], P[name + ".weight"],
                                          P[name + ".bias"], eps)


def attention(prec, P, name, x, kv, H, bias):
    """Multi-head attention; ``bias`` additive, broadcastable to [B, H, Tq, Tk]."""
    B, Tq, D = x.shape
    Tk = kv.shape[1]
    hd = D // H
    q = prec.linear(x, P[name + ".q_proj.weight"], P[name + ".q_proj.bias"]) * hd ** -0.5
    k = prec.linear(kv, P[name + ".k_proj.weight"], P[name + ".k_proj.bias"])
    v = prec.linear(kv, P[name + ".v_proj.weight"], P[name + ".v_proj.bias"])
    q = q.view(B, Tq, H, hd).transpose(1, 2)
    k = k.view(B, Tk, H, hd).transpose(1, 2)
    v = v.view(B, Tk, H, hd).transpose(1, 2)
    s = prec.mm(q, k.transpose(-1, -2)) + bias
    o = prec.mm(torch.softmax(s, dim=-1), v)
    o = prec.act(o.transpose(1, 2).reshape(B, Tq, D))
    return prec.linear(o, P[name + ".out_proj.weight"], P[name + ".out_proj.bias"])


def key_bias(mask):
    """[B, Tk] 1/0 -> [B, 1, 1, Tk] additive."""
    return torch.where(mask[:, None, None, :].bool(), 0.0, NEG)


def ffn(prec, P, lp, x):
    h = gelu(prec.linear(x, P[lp + ".fc1.weight"], P[lp + ".fc1.bias"]))
    return prec.linear(h, P[lp + ".fc2.weight"], P[lp + ".fc2.bias"])


def encode(prec, P, cfg, ids, feats, mask, drop):
    B, T = ids.shape
    off = cfg["extra_pos_embeddings"]
    x = P["model.shared.weight"][ids]
    if feats is not None:
        img_mask = (ids == cfg["img_feat_id"]) | (ids == cfg["cls_token_id"])
        img = prec.linear(feats, P["model.encoder.embed_images.linear.weight"],
                        P["model.encoder.embed_images.linear.bias"])
        slot = (torch.cumsum(img_mask.long(), dim=1) - 1).clamp(0, feats.shape[1] - 1)
        spliced = torch.gather(img, 1, slot[..., None].expand(-1, -1, img.shape[-1]))
        x = torch.where(img_mask[..., None], spliced, x)
    x = x + P["model.encoder.embed_positions.weight"][off:off + T][None]
    x = prec.act(drop.apply(layer_norm(x, P, "model.encoder.layernorm_embedding")))
    bias = key_bias(mask)
    H = cfg["encoder_attention_heads"]
    for i in range(cfg["encoder_layers"]):
        lp = f"model.encoder.layers.{i}"
        h = drop.apply(attention(prec, P, lp + ".self_attn", x, x, H, bias))
        x = prec.act(layer_norm(x + h, P, lp + ".self_attn_layer_norm"))
        h = drop.apply(ffn(prec, P, lp, x))
        x = prec.act(layer_norm(x + h, P, lp + ".final_layer_norm"))
    return x


def decode(prec, P, cfg, dec_ids, enc, enc_mask, dec_mask, drop):
    B, T = dec_ids.shape
    off = cfg["extra_pos_embeddings"]
    x = P["model.shared.weight"][dec_ids]
    x = x + P["model.decoder.embed_positions.weight"][off:off + T][None]
    x = prec.act(drop.apply(layer_norm(x, P, "model.decoder.layernorm_embedding")))
    pos = torch.arange(T, device=x.device)
    self_bias = torch.where(pos[None, :] <= pos[:, None], 0.0, NEG)[None, None]
    if dec_mask is not None:
        self_bias = self_bias + key_bias(dec_mask)
    cross_bias = key_bias(enc_mask)
    H = cfg["decoder_attention_heads"]
    for i in range(cfg["decoder_layers"]):
        lp = f"model.decoder.layers.{i}"
        h = drop.apply(attention(prec, P, lp + ".self_attn", x, x, H, self_bias))
        x = prec.act(layer_norm(x + h, P, lp + ".self_attn_layer_norm"))
        h = drop.apply(attention(prec, P, lp + ".encoder_attn", x, enc, H, cross_bias))
        x = prec.act(layer_norm(x + h, P, lp + ".encoder_attn_layer_norm"))
        h = drop.apply(ffn(prec, P, lp, x))
        x = prec.act(layer_norm(x + h, P, lp + ".final_layer_norm"))
    return x


def lm_logits(prec, P, h, final_logits_bias=None):
    logits = prec.linear(h, P["model.shared.weight"])
    return logits if final_logits_bias is None else logits + final_logits_bias


def head(prec, P, name, x):
    x = torch.tanh(prec.linear(x, P[name + ".dense.weight"], P[name + ".dense.bias"]))
    return prec.linear(x, P[name + ".out_proj.weight"], P[name + ".out_proj.bias"])


def nll_sum(logits, labels):
    """Sum of -log softmax(logits)[label] over labels != -100, and their count."""
    valid = labels != -100
    logp = torch.log_softmax(logits, dim=-1)
    nll = -logp.gather(-1, torch.where(valid, labels, 0)[..., None])[..., 0]
    return torch.where(valid, nll, 0.0).sum(), valid.sum()


def conditional_terms(prec, P, cfg, batch, drop):
    """{term: (sum over this block, count)} of the VCG fine-tuning loss."""
    enc = encode(prec, P, cfg, batch["input_ids"], batch["image_features"],
                 batch["attention_mask"], drop)
    h = decode(prec, P, cfg, batch["decoder_input_ids"], enc, batch["attention_mask"],
               batch.get("decoder_attention_mask"), drop)
    return {"lm": nll_sum(lm_logits(prec, P, h), batch["labels"])}


def pretraining_terms(prec, P, cfg, batch, drop):
    """{term: (sum over this block, count)} of KM-BART's four pretraining
    losses (before their factors)."""
    enc = encode(prec, P, cfg, batch["input_ids"], batch["image_features"],
                 batch["attention_mask"], drop)
    h = decode(prec, P, cfg, batch["decoder_input_ids"], enc, batch["attention_mask"],
               batch.get("decoder_attention_mask"), drop)
    terms = {}
    m = batch["mrm_mask"].bool()
    logp = torch.log_softmax(head(prec, P, "mrm_head", h), dim=-1)
    t = batch["mrm_soft_labels"].float()
    kl = torch.where(t > 0, t * (torch.log(torch.where(t > 0, t, 1.0)) - logp), 0.0).sum(-1)
    terms["mrm"] = (torch.where(m, kl, 0.0).sum(), m.sum())
    am = batch["attribute_mask"].bool()
    labels = torch.where(am, batch["attribute_labels"], -100)
    terms["attribute"] = nll_sum(head(prec, P, "attribute_head", h), labels)
    pairs = batch["relation_pairs"].long()
    D = h.shape[-1]
    obj = torch.gather(h, 1, pairs[..., 0:1].expand(-1, -1, D))
    sub = torch.gather(h, 1, pairs[..., 1:2].expand(-1, -1, D))
    rm = batch["relation_mask"].bool()
    labels = torch.where(rm, batch["relation_labels"], -100)
    terms["relation"] = nll_sum(head(prec, P, "relation_head", torch.cat([obj, sub], -1)), labels)
    labels = torch.where(batch["labels"] == cfg["cls_token_id"], -100, batch["labels"])
    terms["lm"] = nll_sum(lm_logits(prec, P, h), labels)
    return terms


FACTORS = {"lm": "lm_loss_factor", "mrm": "mrm_loss_factor",
           "attribute": "attribute_loss_factor", "relation": "relation_loss_factor"}


def loss_and_grads(prec, P, cfg, batch, terms_fn, masks, rate, block):
    """The mean loss of ``batch`` and its gradients {name: tensor}, in
    blocks of ``block`` rows (each term's mean divides by its count over
    the whole batch, as one pass would). ``terms_fn`` is
    ``conditional_terms`` or ``pretraining_terms``; the VCG loss has no
    factor, the pretraining terms take the configuration's."""
    for p in P.values():
        p.grad = None
    B = batch["input_ids"].shape[0]
    with torch.no_grad():
        counts = count_terms(cfg, batch, terms_fn)
    total = 0.0
    for lo in range(0, B, block):
        rows = slice(lo, min(B, lo + block))
        part = {k: v[rows] for k, v in batch.items()}
        drop = Dropout(rate, masks=masks, rows=rows)
        terms = terms_fn(prec, P, cfg, part, drop)
        loss = 0.0
        for k, (s, _) in terms.items():
            factor = cfg[FACTORS[k]] if terms_fn is pretraining_terms else 1.0
            if counts[k] > 0:
                loss = loss + factor * s / counts[k]
        loss.backward()
        total += float(loss.detach())
    return total, {n: torch.zeros_like(p) if p.grad is None else p.grad for n, p in P.items()}


def count_terms(cfg, batch, terms_fn):
    """Each term's count over the whole batch."""
    counts = {"lm": int((batch["labels"] != -100).sum())}
    if terms_fn is pretraining_terms:
        lm = torch.where(batch["labels"] == cfg["cls_token_id"], -100, batch["labels"])
        counts = {"lm": int((lm != -100).sum()), "mrm": int(batch["mrm_mask"].bool().sum()),
                  "attribute": int(batch["attribute_mask"].bool().sum()),
                  "relation": int(batch["relation_mask"].bool().sum())}
    return counts


class AdamW:
    """HF transformers' AdamW as KM-BART trains with it: eps added to
    sqrt(v), bias correction on the step size, no weight decay."""

    def __init__(self, lr, b1=0.9, b2=0.999, eps=1e-6):
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps
        self.m, self.v, self.t = {}, {}, 0

    @torch.no_grad()
    def step(self, P, grads):
        self.t += 1
        size = self.lr * math.sqrt(1.0 - self.b2 ** self.t) / (1.0 - self.b1 ** self.t)
        for n, p in P.items():
            g = grads[n]
            if g is None:
                continue
            m = self.m.setdefault(n, torch.zeros_like(p))
            v = self.v.setdefault(n, torch.zeros_like(p))
            m.mul_(self.b1).add_(g, alpha=1.0 - self.b1)
            v.mul_(self.b2).addcmul_(g, g, value=1.0 - self.b2)
            p.addcdiv_(m, v.sqrt().add_(self.eps), value=-size)


def step_seed(seed, step, micro=0, rank=0):
    """The seed of a training step's dropout generator: a splitmix64
    finaliser over (seed, step, micro-batch, rank), as KM-BART's torch
    training step seeds its generator each step."""
    mask = (1 << 63) - 1
    z = (seed * 0x9E3779B97F4A7C15 + step * 0xBF58476D1CE4E5B9 + micro + 1
         + rank * 0xD1B54A32D192ED03) & ((1 << 64) - 1)
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & ((1 << 64) - 1)
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & ((1 << 64) - 1)
    return (z ^ (z >> 31)) & mask
