"""PyTorch port, sampling: token-identical to kmbart_tpu under identical
noise, on the CPU at fp32.

Both packages draw every sample from Gumbel noise: JAX through
``jax.random.gumbel`` and ``jax.random.categorical`` (the argmax of the
logits plus Gumbel noise), the port through
``kmbart_tpu_torch.generation.logits._gumbel``. Here all three are
replaced, inside the test only, by one function that returns a constant
numpy-made noise table of the asked shape, so both sides draw on the same
noise. The tokens must then be equal: the scores the noise is added to
agree within fp32 rounding, and a rounding-size difference cannot reorder
two noisy candidates unless they tie to the last bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kmbart_tpu.generation import api as jax_api
from kmbart_tpu.generation import logits as jax_lp
from kmbart_tpu.models.conditional import init_conditional_params
from kmbart_tpu.models.utils import sample_sentence as jax_sample_sentence
from kmbart_tpu_torch.generation import logits as lp
from kmbart_tpu_torch.generation.api import generate
from kmbart_tpu_torch.models.generation_api import generate as model_generate
from kmbart_tpu_torch.models.utils import sample_sentence
from tests._torch_port import port_config, port_model

_TABLES = {}


def noise(shape):
    """The one Gumbel table of ``shape`` (fp32), made with numpy."""
    shape = tuple(int(s) for s in shape)
    if shape not in _TABLES:
        rng = np.random.default_rng(1000 + 31 * sum(shape) + len(shape))
        _TABLES[shape] = rng.gumbel(size=shape).astype(np.float32)
    return _TABLES[shape]


@pytest.fixture()
def same_noise(monkeypatch):
    """JAX and the port draw on the same constant noise tables."""
    monkeypatch.setattr(jax.random, "gumbel",
                        lambda key, shape=(), dtype=jnp.float32, **kw:
                        jnp.asarray(noise(shape), dtype))
    monkeypatch.setattr(jax.random, "categorical",
                        lambda key, logits, axis=-1, **kw:
                        jnp.argmax(logits + jnp.asarray(noise(logits.shape)), axis=axis))
    monkeypatch.setattr(lp, "_gumbel",
                        lambda shape, generator, device: torch.from_numpy(noise(shape)))
    jax_api._compiled_generate.cache_clear()   # no trace made with the real noise
    yield
    jax_api._compiled_generate.cache_clear()


@pytest.fixture(scope="module")
def setup(tiny_cfg):
    cfg = tiny_cfg.replace(dtype="float32")
    params = init_conditional_params(jax.random.PRNGKey(11), cfg)
    rng = np.random.default_rng(4)
    B, S = 3, 10
    ids = rng.integers(4, 80, (B, S)).astype(np.int32)
    feats = rng.normal(size=(B, cfg.max_img_num, cfg.image_feature_size)).astype(np.float32)
    ids[:, 1:3] = cfg.img_feat_id
    batch = {"input_ids": ids, "attention_mask": np.ones((B, S), np.int32),
             "image_features": feats}
    return cfg, port_config(cfg), params, port_model(params, cfg), batch


def _logits(rng, B, V, ties=False):
    x = rng.normal(size=(B, V)).astype(np.float32) * 3
    if ties:
        x[0, [3, 9, 20, 21]] = x[0].max() + 1.0     # a tie across the k-th rank
        x[1, :] = 0.5                                # a row of ties
    return x


@pytest.mark.parametrize("top_k,top_p,min_keep", [
    (5, 1.0, 1), (0, 0.8, 1), (6, 0.7, 2), (3, 0.5, 1), (50, 0.95, 2), (1, 1.0, 1)])
def test_top_k_top_p_filtering_matches_jax(top_k, top_p, min_keep):
    x = _logits(np.random.default_rng(top_k), 4, 64, ties=True)
    want = np.asarray(jax_lp.top_k_top_p_filtering(jnp.asarray(x), top_k, top_p,
                                                    min_tokens_to_keep=min_keep))
    got = lp.top_k_top_p_filtering(torch.from_numpy(x), top_k, top_p,
                                   min_tokens_to_keep=min_keep).numpy()
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    np.testing.assert_allclose(got, want, rtol=0, atol=0)


@pytest.mark.parametrize("top_k,top_p,min_keep", [(5, 1.0, 1), (8, 0.6, 1), (4, 0.3, 2)])
def test_sample_from_top_k_matches_jax(same_noise, top_k, top_p, min_keep):
    """Same noise, same tokens; the tie across the k-th rank keeps the
    lowest-index tokens on both sides."""
    x = _logits(np.random.default_rng(7), 4, 64, ties=True)
    want = np.asarray(jax_lp.sample_from_top_k(jnp.asarray(x), top_k, top_p,
                                               jax.random.PRNGKey(0), min_keep))
    got = lp.sample_from_top_k(torch.from_numpy(x), top_k, top_p, None, min_keep)
    np.testing.assert_array_equal(got.numpy(), want)
    assert got[1].item() < max(top_k, min_keep)    # the row of ties: lowest indices only


CASES = {
    # greedy sampling: the top-k draw, the filter + full draw, temperature
    "greedy-topk": dict(do_sample=True, top_k=5),
    "greedy-topp": dict(do_sample=True, top_k=0, top_p=0.9),
    "greedy-topk-topp-temp": dict(do_sample=True, top_k=8, top_p=0.8, temperature=0.7),
    "greedy-nrs2": dict(do_sample=True, top_k=5, num_return_sequences=2),
    # beam sampling: the fast path (K4's logsumexp), the general path
    # (postprocessors on), and the full [B, K·V] draw without a top-k
    "beam-fast": dict(num_beams=3, do_sample=True, top_k=6, early_stopping=True),
    "beam-fast-topp-temp": dict(num_beams=3, do_sample=True, top_k=6, top_p=0.9,
                                temperature=0.8, early_stopping=True),
    "beam-general": dict(num_beams=3, do_sample=True, top_k=6, no_repeat_ngram_size=2),
    "beam-general-minlen": dict(num_beams=2, do_sample=True, top_k=4, min_length=3,
                                early_stopping=True),
    "beam-no-topk": dict(num_beams=3, do_sample=True, top_k=0, top_p=0.9,
                         early_stopping=True),
    "beam-nrs3": dict(num_beams=2, do_sample=True, top_k=5, num_return_sequences=3,
                      early_stopping=True),
}


@pytest.mark.parametrize("kwargs", list(CASES.values()), ids=list(CASES))
def test_sampling_token_identical_to_jax(setup, same_noise, kwargs):
    cfg, pcfg, params, model, batch = setup
    want = np.asarray(jax_api.generate(params, cfg, batch, rng=jax.random.PRNGKey(0),
                                       max_length=12, **kwargs))
    got = generate(model, pcfg, batch, max_length=12, **kwargs)
    nrs = kwargs.get("num_return_sequences", 1)
    assert got.shape[0] == batch["input_ids"].shape[0] * nrs
    np.testing.assert_array_equal(got, want)    # tokens and HF width


def test_sample_sentence_matches_jax(setup, same_noise, tokenizer):
    cfg, pcfg, params, model, batch = setup
    args = (batch["input_ids"], batch["image_features"], batch["attention_mask"], tokenizer)
    for kw in (dict(top_k=6, top_p=0.9), dict(top_k=0, top_p=0.8)):
        want_tok, want_lp = jax_sample_sentence(params, cfg, *args, max_length=10, **kw)
        got_tok, got_lp = sample_sentence(model, pcfg, *args, max_length=10, **kw)
        np.testing.assert_array_equal(got_tok, want_tok)
        # fp32 log-softmax sums of <= 9 terms: a few ulps of their size
        np.testing.assert_allclose(got_lp, want_lp, rtol=1e-5, atol=1e-5)


def test_generator_seed_reproduces(setup):
    """A fixed torch.Generator seed gives the same tokens twice, through the
    model-level re-export too."""
    _, pcfg, _, model, batch = setup
    for kw in (dict(num_beams=3, top_k=6, top_p=0.9), dict(top_k=0, top_p=0.9)):
        runs = [model_generate(model, pcfg, batch, do_sample=True, max_length=12,
                               generator=torch.Generator().manual_seed(123), **kw)
                for _ in range(2)]
        np.testing.assert_array_equal(runs[0], runs[1])
