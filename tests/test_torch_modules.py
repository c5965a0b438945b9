"""PyTorch port, modules: weights carried across from the JAX layout, the
elementary layers, the trunk (encode, decode, forward, lm_logits), the
beam-stationary decode step, and the checkpoint loader, each against the
JAX package on the CPU from the same parameters and inputs."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kmbart_tpu.checkpoint.io import _flatten, save_pretrained
from kmbart_tpu.checkpoint.torch_import import pytree_to_state_dict
from kmbart_tpu.config import tiny_config
from kmbart_tpu.models import bart as jbart
from kmbart_tpu.models.conditional import init_conditional_params
from kmbart_tpu.ops import layers as jl
from kmbart_tpu.ops.pallas_beam_attention import build_selection_mask
from kmbart_tpu_torch.checkpoint.io import load_pretrained, params_from_jax
from kmbart_tpu_torch.config import tiny_config as port_tiny_config
from kmbart_tpu_torch.models import bart
from kmbart_tpu_torch.models.conditional import (MultiModalBartForConditionalGeneration,
                                                 init_conditional_model)
from kmbart_tpu_torch.ops import layers
from tests._torch_port import bf16_tol, port_model, to_jax, to_np, to_torch

FP32 = dict(rtol=1e-5, atol=1e-5)  # fp32 end to end: summation order only


@pytest.fixture(scope="module")
def setup():
    fields = dict(dtype="float32", vocab_size=136, normalize_before=True,
                  add_final_layer_norm=True)
    cfg, pcfg = tiny_config(**fields), port_tiny_config(**fields)
    params = init_conditional_params(jax.random.PRNGKey(11), cfg)
    # non-trivial layer norms and biases so every parameter shows up
    leaves, tree = jax.tree_util.tree_flatten(params)
    rng = np.random.default_rng(0)
    leaves = [a + rng.normal(size=a.shape).astype(np.float32) * 0.05 for a in leaves]
    params = jax.tree_util.tree_unflatten(tree, [jnp.asarray(a) for a in leaves])
    return cfg, pcfg, params, port_model(params, pcfg)


def _batch(cfg, B=3, T=10, seed=1):
    rng = np.random.default_rng(seed)
    ids = rng.integers(4, 80, (B, T)).astype(np.int32)
    ids[:, 1:4] = cfg.img_feat_id
    ids[0, 4] = cfg.cls_token_id
    mask = np.ones((B, T), np.int32)
    mask[1, -3:] = 0
    feats = rng.normal(size=(B, cfg.max_img_num, cfg.image_feature_size)).astype(np.float32)
    return ids, mask, feats


def test_params_from_jax_matches_pytree_to_state_dict(setup):
    cfg, pcfg, params, model = setup
    ref = pytree_to_state_dict(params, cfg)
    # the JAX exporter leaves out the optional final stack norms
    # (normalize_before / add_final_layer_norm); HF names them so
    extra = {f"model.{side}.layer_norm.{w}": params["model"][side]["layer_norm"][n]
             for side in ("encoder", "decoder") for w, n in (("weight", "scale"),
                                                            ("bias", "bias"))}
    for source in (params, _flatten(params)):      # pytree and params.npz keys
        sd = params_from_jax(source, pcfg)
        assert sorted(sd) == sorted(list(ref) + list(extra))
        for k, v in {**ref, **extra}.items():
            np.testing.assert_array_equal(sd[k].numpy(), np.asarray(v), err_msg=k)
    # the port's own parameter names are the HF names
    assert sorted(model.state_dict()) == sorted(sd)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layers_match_jax(dtype):
    rng = np.random.default_rng(2)
    x, w, b = rng.normal(size=(4, 7, 24)), rng.normal(size=(24, 40)), rng.normal(size=(40,))
    s, c = 1 + rng.normal(size=(24,)) * 0.1, rng.normal(size=(24,)) * 0.1
    td, jd = getattr(torch, dtype), jnp.dtype(dtype)
    pairs = [
        (layers.dense(to_torch(x), to_torch(w.T), to_torch(b), td),
         jl.dense(to_jax(x), to_jax(w), to_jax(b), jd)),
        (layers.layer_norm(to_torch(x, td), to_torch(s), to_torch(c)),
         jl.layer_norm(to_jax(x, dtype), to_jax(s), to_jax(c))),
        (layers.gelu(to_torch(x, td)), jl.gelu(to_jax(x, dtype))),
        (layers.gelu_new(to_torch(x, td)), jl.gelu_new(to_jax(x, dtype))),
    ]
    for got, want in pairs:
        assert got.dtype == td
        want = to_np(want)
        if dtype == "float32":
            np.testing.assert_allclose(to_np(got), want, **FP32)
        else:
            # bf16 outputs of fp32 math: at most a rounding apart
            np.testing.assert_allclose(to_np(got), want, rtol=0, atol=bf16_tol(want))


def test_encode_decode_forward_logits_match_jax(setup):
    cfg, pcfg, params, model = setup
    ids, mask, feats = _batch(cfg)
    dec_ids = np.random.default_rng(3).integers(4, 80, (3, 7)).astype(np.int32)
    dec_mask = np.ones((3, 7), np.int32)
    dec_mask[2, -2:] = 0
    jm = params["model"]

    enc_j = jbart.encode(jm, cfg, ids, feats, mask)
    dec_j, _ = jbart.forward(jm, cfg, ids, feats, mask, dec_ids, dec_mask)
    logits_j = jbart.lm_logits(jm, cfg, dec_j, params["final_logits_bias"])

    t = lambda a: torch.from_numpy(np.asarray(a)).long()
    with torch.no_grad():
        enc = bart.encode(model.model, pcfg, t(ids), torch.from_numpy(feats), t(mask))
        dec, enc2 = bart.forward(model.model, pcfg, t(ids), torch.from_numpy(feats), t(mask),
                                 t(dec_ids), t(dec_mask))
        logits = bart.lm_logits(model.model, pcfg, dec, model.final_logits_bias)
        dec_only = bart.decode(model.model, pcfg, t(dec_ids), enc, t(mask), t(dec_mask))
    np.testing.assert_allclose(to_np(enc), to_np(enc_j), **FP32)
    np.testing.assert_array_equal(to_np(enc2), to_np(enc))
    np.testing.assert_allclose(to_np(dec), to_np(dec_j), **FP32)
    np.testing.assert_array_equal(to_np(dec_only), to_np(dec))
    np.testing.assert_allclose(to_np(logits), to_np(logits_j), **FP32)


def test_encode_without_images_or_mask(setup):
    cfg, pcfg, params, model = setup
    ids, _, _ = _batch(cfg, seed=4)
    enc_j = jbart.encode(params["model"], cfg, ids)
    with torch.no_grad():
        enc = bart.encode(model.model, pcfg, torch.from_numpy(ids).long())
    np.testing.assert_allclose(to_np(enc), to_np(enc_j), **FP32)


def test_decode_steps_stationary_match_jax(setup):
    """Three beam-stationary decode steps with branching ancestry."""
    cfg, pcfg, params, model = setup
    ids, mask, feats = _batch(cfg, B=2)
    B, K, L = 2, 3, 6
    jm = params["model"]
    enc_j = jbart.encode(jm, cfg, ids, feats, mask)
    caches_j = jbart.init_decode_cache_layers(jm, cfg, enc_j, L, num_beams=K)
    t = lambda a: torch.from_numpy(np.asarray(a)).long()
    with torch.no_grad():
        enc = bart.encode(model.model, pcfg, t(ids), torch.from_numpy(feats), t(mask))
        caches = bart.init_decode_cache_layers(model.model, pcfg, enc, L, num_beams=K)
    rng = np.random.default_rng(5)
    anc = np.zeros((B * K, L), np.int32)
    for step in range(3):
        # each live beam takes a random parent's history, then its own slot
        anc = anc[rng.integers(0, K, B * K) + np.repeat(np.arange(B) * K, K)]
        anc[:, step] = np.arange(B * K) % K
        tokens = rng.integers(4, 80, (B * K, 1)).astype(np.int32)
        sel = build_selection_mask(jnp.asarray(anc), K, step, cfg.decoder_attention_heads)
        h_j, caches_j = jbart.decode_step_stationary(jm, cfg, tokens, caches_j, step, sel,
                                                     mask, num_beams=K)
        with torch.no_grad():
            h = bart.decode_step_stationary(model.model, pcfg, t(tokens), caches, step,
                                            torch.from_numpy(anc), t(mask), num_beams=K)
        np.testing.assert_allclose(to_np(h), to_np(h_j), **FP32)
        for mine, theirs in zip(caches, caches_j):
            for key in ("self_k", "self_v", "cross_k", "cross_v"):
                np.testing.assert_allclose(to_np(mine[key]), to_np(theirs[key]), **FP32)


def test_shift_tokens_right_and_position_check(setup):
    _, pcfg, _, model = setup
    ids = np.array([[0, 5, 6, 2, 1, 1], [0, 7, 8, 9, 10, 2]], np.int32)
    want = np.asarray(jbart.shift_tokens_right(jnp.asarray(ids), 1))
    got = bart.shift_tokens_right(torch.from_numpy(ids).long(), 1)
    np.testing.assert_array_equal(got.numpy(), want)
    too_long = torch.zeros((1, pcfg.max_position_embeddings + 1), dtype=torch.long)
    with pytest.raises(ValueError, match="max_position_embeddings"):
        bart.encode(model.model, pcfg, too_long)


def test_load_pretrained_npz_and_torch_bin(setup, tmp_path):
    cfg, pcfg, params, _ = setup
    npz_dir = str(tmp_path / "npz")
    save_pretrained(npz_dir, cfg, jax.tree_util.tree_map(np.asarray, params))
    _, model, _ = load_pretrained(npz_dir, device="cpu")
    ref = params_from_jax(params, pcfg)
    for k, v in model.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), np.asarray(ref[k]), err_msg=k)

    # a reference pytorch_model.bin: base-model names (no "model." prefix)
    # and a shorter vocabulary that partial_load slices in
    bin_dir = tmp_path / "bin"
    bin_dir.mkdir()
    small = {k[len("model."):] if k.startswith("model.") else k: v.clone()
             for k, v in ref.items()}
    for k in ("shared.weight", "encoder.embed_tokens.weight", "decoder.embed_tokens.weight"):
        small[k] = small[k][:100].clone()
    small["final_logits_bias"] = small["final_logits_bias"][:, :100].clone()
    torch.save(small, str(bin_dir / "pytorch_model.bin"))
    part = cfg.replace(partial_load=("model.shared.weight", "final_logits_bias"))
    part.save_json(str(bin_dir / "config.json"))
    _, loaded, report = load_pretrained(str(bin_dir), device="cpu")
    assert any("partially loaded model.shared.weight" in line for line in report)
    sd = loaded.state_dict()
    np.testing.assert_array_equal(sd["model.shared.weight"][:100].numpy(),
                                  np.asarray(ref["model.shared.weight"])[:100])
    np.testing.assert_array_equal(sd["model.encoder.layers.1.fc2.weight"].numpy(),
                                  np.asarray(ref["model.encoder.layers.1.fc2.weight"]))
    # a shape mismatch outside partial_load is an error
    cfg.save_json(str(bin_dir / "config.json"))
    with pytest.raises(ValueError, match="size mismatch"):
        load_pretrained(str(bin_dir), device="cpu")


def test_model_layout_and_static_positions(setup):
    cfg = setup[1]
    model = MultiModalBartForConditionalGeneration(cfg)
    assert model.model.encoder.embed_tokens is model.model.shared
    assert model.model.decoder.embed_tokens is model.model.shared
    assert "final_logits_bias" in dict(model.named_buffers())
    assert model.model.encoder.layers[0].fc1.weight.shape == (cfg.encoder_ffn_dim, cfg.d_model)
    # static (sinusoidal) positions initialise to the JAX package's table
    scfg = cfg.replace(static_position_embeddings=True)
    smodel = init_conditional_model(scfg, device="cpu")
    want = np.asarray(jbart._sinusoidal_table(scfg.max_position_embeddings, scfg.d_model))
    for side in (smodel.model.encoder, smodel.model.decoder):
        np.testing.assert_allclose(side.embed_positions.weight.detach().numpy(), want, rtol=0,
                                   atol=1e-6)
