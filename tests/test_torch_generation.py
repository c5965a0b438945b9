"""PyTorch port, generation: token-identical to kmbart_tpu's ``generate``
at fp32 on the CPU, output width included, for greedy decoding, the beam
configurations of tests/test_generation.py, and a vocabulary wider than one
1024-column stats chunk."""

import jax
import numpy as np
import pytest

from kmbart_tpu.config import tiny_config
from kmbart_tpu.generation.api import generate as jax_generate
from kmbart_tpu.models.conditional import init_conditional_params
from kmbart_tpu_torch.config import tiny_config as port_tiny_config
from kmbart_tpu_torch.generation.api import GenerationOptions, generate
from tests._torch_port import port_config, port_model


@pytest.fixture(scope="module")
def setup(tiny_cfg):
    cfg = tiny_cfg.replace(dtype="float32")
    params = init_conditional_params(jax.random.PRNGKey(5), cfg)
    rng = np.random.default_rng(3)
    B, S = 3, 11
    ids = rng.integers(4, 80, (B, S)).astype(np.int32)
    batch = {"input_ids": ids, "attention_mask": np.ones((B, S), np.int32)}
    return cfg, port_config(cfg), params, port_model(params, cfg), batch


@pytest.mark.parametrize("kwargs", [
    dict(),
    dict(num_beams=5, early_stopping=True),
    dict(num_beams=5, early_stopping=False),
    dict(num_beams=5, early_stopping=False, length_penalty=0.7),
    dict(num_beams=5, early_stopping=True, length_penalty=2.0),
    dict(num_beams=4, early_stopping=True, no_repeat_ngram_size=2),
    dict(num_beams=5, early_stopping=True, num_return_sequences=3),
], ids=["greedy", "es", "no-es", "lp0.7", "lp2-es", "ngram2", "nrs3-es"])
def test_generate_token_identical_to_jax(setup, kwargs):
    cfg, pcfg, params, model, batch = setup
    want = np.asarray(jax_generate(params, cfg, batch, max_length=14, **kwargs))
    got = generate(model, pcfg, batch, max_length=14, **kwargs)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)   # tokens and HF width


def test_generate_without_attention_mask(setup):
    cfg, pcfg, params, model, batch = setup
    ids = batch["input_ids"].copy()
    ids[1, -4:] = cfg.pad_token_id
    want = np.asarray(jax_generate(params, cfg, {"input_ids": ids}, max_length=9,
                                   num_beams=3, early_stopping=True))
    got = generate(model, pcfg, {"input_ids": ids}, max_length=9, num_beams=3,
                   early_stopping=True)
    np.testing.assert_array_equal(got, want)


def test_generate_multichunk_vocab(np_rng):
    """Vocab 5120 = 5 stats chunks: the forced BOS/EOS steps drive entirely
    -inf chunks through the fast-select path."""
    fields = dict(dtype="float32", vocab_size=5120, d_model=128,
                  encoder_layers=4, decoder_layers=4,
                  encoder_attention_heads=4, decoder_attention_heads=4,
                  encoder_ffn_dim=256, decoder_ffn_dim=256,
                  img_feat_id=5000, cls_token_id=5003, max_position_embeddings=64)
    cfg, pcfg = tiny_config(**fields), port_tiny_config(**fields)
    params = init_conditional_params(jax.random.PRNGKey(7), cfg)
    ids = np_rng.integers(4, 4990, (4, 12)).astype(np.int32)
    batch = {"input_ids": ids, "attention_mask": np.ones((4, 12), np.int32)}
    kw = dict(max_length=14, num_beams=5, early_stopping=True)
    want = np.asarray(jax_generate(params, cfg, batch, **kw))
    got = generate(port_model(params, pcfg), pcfg, batch, **kw)
    np.testing.assert_array_equal(got, want)


def test_options_validate_and_sampling_raises(setup):
    _, pcfg, _, model, batch = setup
    with pytest.raises(AssertionError):
        GenerationOptions(num_beams=2, num_return_sequences=3).validate()
    with pytest.raises(AssertionError):
        GenerationOptions(num_return_sequences=2).validate()
    # sampling is ported: it raises only on the options the reference refuses
    with pytest.raises(AssertionError):
        generate(model, pcfg, batch, do_sample=True, temperature=0.0)
    with pytest.raises(AssertionError):
        generate(model, pcfg, batch, do_sample=True, top_p=1.5)
