"""PyTorch port, knowledge: the GPT-1 BPE copy, the GPT trunk (full
forward, the cached decode step, the openai-gpt importer), the ATOMIC
generator (greedy, beam and top-k sampling) and the reasoning classifier
with its collator, each against the JAX package on the CPU."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kmbart_tpu.knowledge import gpt as jgpt
from kmbart_tpu.knowledge.atomic import AtomicGenerator as JaxAtomicGenerator
from kmbart_tpu.knowledge.bpe_gpt1 import GPT1BPE as JaxGPT1BPE
from kmbart_tpu.models import reasoning as jreason
from kmbart_tpu_torch.knowledge import gpt
from kmbart_tpu_torch.knowledge.atomic import RESULT_MAP, AtomicGenerator
from kmbart_tpu_torch.knowledge.bpe_gpt1 import GPT1BPE
from kmbart_tpu_torch.models import reasoning

EVENTS = ("person sits at a table", "2 waves at 1 's dog")


@pytest.fixture(scope="module")
def gpt1_assets(tmp_path_factory):
    """tests/test_knowledge.py's character vocabulary."""
    d = tmp_path_factory.mktemp("gpt1")
    vocab = {}
    for ch in "abcdefghijklmnopqrstuvwxyz0123456789 '":
        vocab[ch] = len(vocab)
        vocab[ch + "</w>"] = len(vocab)
    for sp in ("none</w>", "<END>", "<xIntent>", "<xWant>", "<xNeed>", "<xReact>",
               "<xEffect>"):
        vocab[sp] = len(vocab)
    (d / "vocab.json").write_text(json.dumps(vocab))
    (d / "merges.txt").write_text("#version: toy\n")
    return str(d), vocab


def _np_params(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def test_bpe_copy(tmp_path, gpt1_assets):
    d, _ = gpt1_assets
    vocab = {"t": 0, "h": 1, "e</w>": 2, "th": 3, "the</w>": 4, "d": 5, "o": 6, "g</w>": 7,
             "do": 8, "dog</w>": 9, "!</w>": 10, "s</w>": 11, "r": 12, "u": 13, "n": 14}
    (tmp_path / "vocab.json").write_text(json.dumps(vocab))
    (tmp_path / "merges.txt").write_text("#version\nt h\nth e</w>\nd o\ndo g</w>\n")
    for v, m in ((d + "/vocab.json", d + "/merges.txt"),
                 (str(tmp_path / "vocab.json"), str(tmp_path / "merges.txt"))):
        ours, ref = GPT1BPE(v, m), JaxGPT1BPE(v, m)
        for text in ("The dog!", "the dogs run -- fast...", "person’s “quote”", ""):
            ids = ours.encode(text)
            assert ids == ref.encode(text)
            assert ours.decode(ids, stop_ids=(10,)) == ref.decode(ids, stop_ids=(10,))


@pytest.fixture(scope="module")
def small_gpt():
    params = jgpt.init_gpt_params(jax.random.PRNGKey(0), n_vocab=50, n_ctx=16, d_model=32,
                                  n_layers=2, n_heads=4)
    return params, gpt.gpt_params_from_jax(_np_params(params), n_heads=4, device="cpu")


@pytest.mark.parametrize("dtype,atol", [("float32", 2e-5), ("bfloat16", 2e-3)])
def test_gpt_forward_and_logits_match_jax(small_gpt, dtype, atol):
    """fp32: summation order only. bf16: the residual stream is fp32 in both,
    the sublayer outputs round to bf16 (a few bf16 ulps of the O(1)
    post-LN activations)."""
    params, model = small_gpt
    ids = np.random.default_rng(0).integers(0, 50, (2, 8)).astype(np.int32)
    want = np.array(jgpt.gpt_forward(params, ids, n_heads=4, dtype=getattr(jnp, dtype)),
                    np.float32)
    got = gpt.gpt_forward(model, torch.from_numpy(ids), dtype=getattr(torch, dtype)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=atol)
    want_l = np.asarray(jgpt.gpt_logits(params, jnp.asarray(want), dtype=getattr(jnp, dtype)))
    got_l = gpt.gpt_logits(model, torch.from_numpy(want), dtype=getattr(torch, dtype)).numpy()
    np.testing.assert_allclose(got_l, want_l, rtol=0, atol=1e-6)


def test_gpt_step_matches_jax_and_full_forward(small_gpt):
    params, model = small_gpt
    ids = np.random.default_rng(1).integers(0, 50, (3, 8)).astype(np.int32)
    jcache = jgpt.init_gpt_cache(params, 3, 8, n_heads=4, dtype=jnp.float32)
    cache = gpt.init_gpt_cache(model, 3, 8, dtype=torch.float32)
    steps = []
    for t in range(8):
        want, jcache = jgpt.gpt_step(params, ids[:, t:t + 1], jcache, jnp.int32(t), n_heads=4,
                                     dtype=jnp.float32)
        got, cache = gpt.gpt_step(model, torch.from_numpy(ids[:, t:t + 1]), cache, t,
                                  dtype=torch.float32)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=2e-5)
        steps.append(got[:, 0])
    np.testing.assert_allclose(cache["k"].numpy(), np.asarray(jcache["k"]), rtol=0, atol=2e-5)
    full = gpt.gpt_forward(model, torch.from_numpy(ids), dtype=torch.float32)
    np.testing.assert_allclose(torch.stack(steps, 1).numpy(), full.numpy(), rtol=0, atol=2e-5)


def openai_gpt_state_dict(seed, n_embed, d, n_layers):
    """A COMET/openai-gpt state dict (Conv1D [in, out] weights, c_attn
    packing q|k|v)."""
    rng = np.random.default_rng(seed)
    n = lambda *s: (rng.normal(size=s) * 0.05).astype(np.float32)
    sd = {"transformer.tokens_embed.weight": n(n_embed, d)}
    for i in range(n_layers):
        b = f"transformer.h.{i}."
        sd.update({b + "attn.c_attn.weight": n(d, 3 * d), b + "attn.c_attn.bias": n(3 * d),
                   b + "attn.c_proj.weight": n(d, d), b + "attn.c_proj.bias": n(d),
                   b + "mlp.c_fc.weight": n(d, 4 * d), b + "mlp.c_fc.bias": n(4 * d),
                   b + "mlp.c_proj.weight": n(4 * d, d), b + "mlp.c_proj.bias": n(d),
                   b + "ln_1.weight": 1 + n(d), b + "ln_1.bias": n(d),
                   b + "ln_2.weight": 1 + n(d), b + "ln_2.bias": n(d)})
    return sd


def test_import_openai_gpt_state_dict_matches_jax():
    params = jgpt.init_gpt_params(jax.random.PRNGKey(2), n_vocab=40, n_ctx=12, d_model=16,
                                  n_layers=2, n_heads=4)
    sd = openai_gpt_state_dict(0, 45, 16, 2)        # more rows than the table: clipped
    want, ok_want = jgpt.import_openai_gpt_state_dict(sd, params)
    # the rows past the state dict's 45 keep the initialisation: start from the same one
    model = gpt.gpt_params_from_jax(_np_params(params), n_heads=4, device="cpu")
    model, ok = gpt.import_openai_gpt_state_dict(
        {k: torch.from_numpy(v) for k, v in sd.items()}, model)
    assert ok and ok_want
    ref = gpt.gpt_params_from_jax(_np_params(want), n_heads=4, device="cpu").state_dict()
    for name, t in model.state_dict().items():
        np.testing.assert_array_equal(t.numpy(), ref[name].numpy(), err_msg=name)
    # a state dict without the blocks loads the embedding only, and says so
    model2 = gpt.init_gpt_model(40, 12, d_model=16, n_layers=2, n_heads=4, device="cpu")
    _, ok = gpt.import_openai_gpt_state_dict(
        {"transformer.tokens_embed.weight": torch.from_numpy(sd["transformer.tokens_embed.weight"])},
        model2)
    assert not ok and torch.equal(model2.embed.weight[:40], model.embed.weight[:40])
    assert torch.equal(model2.h[0].c_fc.weight, gpt.init_gpt_model(
        40, 12, d_model=16, n_layers=2, n_heads=4, device="cpu").h[0].c_fc.weight)


@pytest.fixture(scope="module")
def generators(gpt1_assets):
    """The same COMET-shaped GPT (n_ctx 52, d_model 32, 2 layers) in both
    packages, over the character vocabulary."""
    d, vocab = gpt1_assets
    params = jgpt.init_gpt_params(jax.random.PRNGKey(1), len(vocab), n_ctx=17 + 34 + 1,
                                  d_model=32, n_layers=2, n_heads=4)
    model = gpt.gpt_params_from_jax(_np_params(params), n_heads=4, device="cpu")
    cats = {c: vocab["<%s>" % c] for c in RESULT_MAP}
    enc = lambda cls: cls(d + "/vocab.json", d + "/merges.txt")

    def make(sampling):
        return (JaxAtomicGenerator(params, enc(JaxGPT1BPE), sampling_algorithm=sampling,
                                   category_tokens=cats, n_heads=4),
                AtomicGenerator(model, enc(GPT1BPE), sampling_algorithm=sampling,
                                category_tokens=cats))
    return make


@pytest.mark.parametrize("sampling", ["greedy", "beam-3"])
def test_atomic_generator_matches_jax(generators, sampling):
    """The same tokens (bf16, as both packages run the generator) and the
    same get_reason, for the prompt layout and the category mapping."""
    jax_gen, gen = generators(sampling)
    jax_gen._fn = jax_gen._build_sampler()
    for event in EVENTS:
        prompt = gen.prompt(event)
        assert prompt.shape == (5, 18) and (prompt[:, 17] == torch.tensor(
            [gen.category_tokens[c] for c in RESULT_MAP])).all()
        want = np.asarray(jax_gen._fn(jnp.asarray(prompt.numpy().astype(np.int32)), None,
                                      jax.random.PRNGKey(0)))
        np.testing.assert_array_equal(gen.sample(prompt).numpy(), want)
        assert gen.get_reason(event) == jax_gen.get_reason(event)


def test_topk_sampling_reproducible_and_within_top_k(generators):
    _, gen = generators("topk-3")
    gen.dtype = torch.float32
    prompt = gen.prompt(EVENTS[0])
    draws = []
    for _ in range(2):
        gen.generator = torch.Generator().manual_seed(7)
        draws.append(gen.sample(prompt))
    assert torch.equal(draws[0], draws[1])
    gen.generator = torch.Generator().manual_seed(8)
    assert not torch.equal(gen.sample(prompt), draws[0])
    tokens = draws[0]
    logits = gpt.gpt_logits(gen.model, gpt.gpt_forward(gen.model, tokens, dtype=torch.float32),
                            dtype=torch.float32)
    top3 = torch.topk(logits, 3, dim=-1).indices
    n = 0
    for b in range(tokens.shape[0]):
        for t in range(18, tokens.shape[1]):
            if tokens[b, t - 1] == gen.end_id and t > 18:
                break
            assert tokens[b, t] in top3[b, t - 1], (b, t)
            n += 1
    assert n >= 5


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_reasoning_loss_matches_jax(dtype):
    rng = np.random.default_rng(0)
    jp = jreason.init_reasoning_params(jax.random.PRNGKey(0), 16, 40, 24)
    jp = {k: np.asarray(v) + rng.normal(size=np.shape(v)).astype(np.float32) * 0.1
          for k, v in jp.items()}
    tp = {k: torch.from_numpy(np.ascontiguousarray(v.T if v.ndim == 2 else v))
          for k, v in jp.items()}
    txt = rng.normal(size=(6, 16)).astype(np.float32)
    img = rng.normal(size=(6, 40)).astype(np.float32)
    label = np.asarray([0, 1, 0, 1, 1, 0], np.int32)
    want_loss, want_logits = jreason.reasoning_loss(jp, txt, img, label,
                                                    dtype=getattr(jnp, dtype))
    loss, logits = reasoning.reasoning_loss(tp, torch.from_numpy(txt), torch.from_numpy(img),
                                            torch.from_numpy(label).long(),
                                            dtype=getattr(torch, dtype))
    tol = 1e-6 if dtype == "float32" else 1e-2
    np.testing.assert_allclose(logits.float().numpy(),
                               np.asarray(want_logits.astype(jnp.float32)), rtol=0, atol=tol)
    assert abs(float(loss) - float(want_loss)) <= tol


def test_atomic_collator_matches_jax():
    feats = np.random.default_rng(1)
    batch = [{"event": f"e{i}", "image_features": feats.normal(size=(i % 5, 10))}
             for i in range(8)]
    encode = lambda texts: np.array([[float(t[1:]), len(t)] for t in texts], np.float32)
    want = jreason.AtomicCollator(encode, 4, 10, 0.5, rng=np.random.default_rng(3))(batch)
    got = reasoning.AtomicCollator(encode, 4, 10, 0.5, rng=np.random.default_rng(3))(batch)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    assert (got["label"] == 0).any() and (got["label"] == 1).any()
