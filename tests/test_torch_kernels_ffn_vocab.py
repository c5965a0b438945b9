"""PyTorch port, kernels K2 (fused FFN) and K4 (vocab stats), and the
tie order of the port's top-k: the plain versions (what the wrappers run on
CPU tensors) against the JAX package's XLA twins and its Pallas kernels in
interpret mode."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kmbart_tpu.generation.beam import _merge_pool as jax_merge_pool
from kmbart_tpu.generation.logits import force_token
from kmbart_tpu.ops import layers as jl
from kmbart_tpu.ops.pallas_ffn import fused_ffn as jax_fused_ffn
from kmbart_tpu.ops.pallas_vocab_stats import chunk_stats as jax_chunk_stats
from kmbart_tpu.ops.pallas_vocab_stats import chunk_stats_reference
from kmbart_tpu.ops.pallas_vocab_stats import logsumexp_from_stats as jax_lse
from kmbart_tpu.ops.topk import pad_to_chunks
from kmbart_tpu_torch.generation.beam import _merge_pool
from kmbart_tpu_torch.ops import ffn, layers, vocab_stats as vs
from kmbart_tpu_torch.ops.topk import top_k
from tests._torch_port import bf16_tol, to_jax, to_np, to_torch


def _ffn_inputs(N=256, D=128, F=512, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(N, D)), rng.normal(size=(D, F)) * 0.1,
            rng.normal(size=(F,)) * 0.1, rng.normal(size=(F, D)) * 0.05,
            rng.normal(size=(D,)) * 0.1)


def test_fused_ffn_matches_jax_kernel_and_composite():
    # rows % 256, D % 128, F % 512: the shapes the Pallas kernel tiles
    x, w1, b1, w2, b2 = _ffn_inputs()
    xj = to_jax(x, "bfloat16")
    kernel = jax_fused_ffn(xj, to_jax(w1), to_jax(b1), to_jax(w2), to_jax(b2),
                           interpret=True)
    bf = jnp.bfloat16
    composite = jl.dense(jl.gelu(jl.dense(xj, to_jax(w1), to_jax(b1), bf)),
                         to_jax(w2), to_jax(b2), bf)
    # the port keeps weights as nn.Linear does: [out, in]
    out = ffn.fused_ffn(to_torch(x, torch.bfloat16), to_torch(w1.T), to_torch(b1),
                        to_torch(w2.T), to_torch(b2))
    assert out.dtype == torch.bfloat16 and out.shape == x.shape
    for ref in (to_np(kernel), to_np(composite)):
        # <= 2 bf16 ulps: the TPU kernel's A-S erf and the composite's
        # bf16-step gelu each sit within 2 ulps of exact-erf gelu
        np.testing.assert_allclose(to_np(out), ref, rtol=0, atol=bf16_tol(ref))


@pytest.mark.parametrize("rows", [1, 37])
def test_fused_ffn_any_row_count(rows):
    """The port takes any row count (the N % 256 gate is a TPU tiling rule)."""
    x, w1, b1, w2, b2 = _ffn_inputs(N=rows, D=32, F=64, seed=rows)
    xj = to_jax(x, "bfloat16")
    bf = jnp.bfloat16
    composite = jl.dense(jl.gelu(jl.dense(xj, to_jax(w1), to_jax(b1), bf)),
                         to_jax(w2), to_jax(b2), bf)
    out = ffn.fused_ffn(to_torch(x, torch.bfloat16), to_torch(w1.T), to_torch(b1),
                        to_torch(w2.T), to_torch(b2))
    ref = to_np(composite)
    np.testing.assert_allclose(to_np(out), ref, rtol=0, atol=bf16_tol(ref))


def test_composite_ffn_fp32_matches_jax():
    """At fp32 the FFN runs as dense -> gelu -> dense in both packages."""
    x, w1, b1, w2, b2 = _ffn_inputs(N=8, D=32, F=64)
    ref = jl.dense(jl.gelu(jl.dense(to_jax(x), to_jax(w1), to_jax(b1), jnp.float32)),
                   to_jax(w2), to_jax(b2), jnp.float32)
    f32 = torch.float32
    h = layers.gelu(layers.dense(to_torch(x), to_torch(w1.T), to_torch(b1), f32))
    out = layers.dense(h, to_torch(w2.T), to_torch(b2), f32)
    np.testing.assert_allclose(to_np(out), to_np(ref), rtol=1e-5, atol=1e-5)


def _check_stats(logits):
    """Port chunk stats == JAX reference and Pallas kernel (interpret)."""
    xr = pad_to_chunks(jnp.asarray(logits))
    cm, es = vs.chunk_stats(torch.from_numpy(np.array(logits)))
    for rcm, res in (chunk_stats_reference(xr), jax_chunk_stats(xr, interpret=True)):
        # maxima are exact; exp-sums differ in fp32 summation order only
        np.testing.assert_array_equal(cm.numpy(), np.asarray(rcm))
        np.testing.assert_allclose(es.numpy(), np.asarray(res), rtol=1e-5, atol=0)
    lse = vs.logsumexp_from_stats(cm, es).numpy()
    ref = np.asarray(jax_lse(*chunk_stats_reference(xr)))
    np.testing.assert_allclose(lse, ref, rtol=1e-6)
    return cm, es, lse


def test_chunk_stats_ragged_tail():
    rng = np.random.default_rng(4)
    logits = (rng.normal(size=(8, 5000)) * 5).astype(np.float32)  # 4 chunks + 904
    _, _, lse = _check_stats(logits)
    np.testing.assert_allclose(lse, torch.logsumexp(torch.from_numpy(logits), 1).numpy(),
                               rtol=1e-6)


def test_chunk_stats_forced_token_rows():
    """Forced BOS/EOS rows are -inf but for one column: 49 of 50 chunks are
    entirely -inf. No NaN, and the row logsumexp is the kept logit."""
    rng = np.random.default_rng(0)
    logits = jnp.asarray(rng.normal(size=(8, 50320)).astype(np.float32) * 4)
    forced = np.asarray(force_token(logits, 2))
    cm, es, lse = _check_stats(forced)
    assert not torch.isnan(cm).any() and not torch.isnan(es).any()
    assert (es[:, 1:] == 0).all()
    np.testing.assert_array_equal(lse, forced[:, 2])


def test_chunk_stats_all_inf_rows():
    dead = np.full((4, 3000), -np.inf, np.float32)
    dead[0, 2999] = 1.5                          # only the ragged tail lives
    cm, es, lse = _check_stats(dead)
    assert lse[0] == np.float32(1.5) and np.all(lse[1:] == -np.inf)


def test_top_k_ties_lowest_index_first():
    """Vocab top-2K with planted equal values: lax.top_k's order."""
    rng = np.random.default_rng(5)
    x = rng.normal(size=(5, 50320)).astype(np.float32)
    x[0, [40000, 123, 4567, 1023, 1024]] = 9.0    # across and at chunk borders
    x[1, :] = 1.25                                # a degenerate row
    x[2, ::7] = -np.inf
    x[3, :] = -np.inf
    x[3, 50319] = 0.0
    x[4] = np.round(x[4] * 2)                     # many ties everywhere
    vals, idx = top_k(torch.from_numpy(x), 10)
    rv, ri = jax.lax.top_k(jnp.asarray(x), 10)
    np.testing.assert_array_equal(vals.numpy(), np.asarray(rv))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ri))


def test_merge_pool_ties_match_jax():
    """_merge_pool keeps the best K with lowest-position-first ties, as the
    JAX version does, and tracks count and worst the same way."""
    B, K, L = 3, 4, 6
    rng = np.random.default_rng(6)
    tokens = rng.integers(0, 50, (B, K, L)).astype(np.int32)
    lens = rng.integers(1, L, (B, K)).astype(np.int32)
    scores = np.array([[-1.0, -2.0, -1e9, -1e9],
                       [-0.5, -0.5, -0.5, -3.0],
                       [-1e9, -1e9, -1e9, -1e9]], np.float32)
    count = np.array([2, 4, 0], np.int32)
    worst = np.array([-2.0, -3.0, 1e9], np.float32)
    c_scores = np.array([[-2.0, -np.inf, -1.0, -np.inf],
                         [-0.5, -0.5, -np.inf, -0.25],
                         [-4.0, -4.0, -np.inf, -np.inf]], np.float32)
    c_tokens = rng.integers(0, 50, (B, K, L)).astype(np.int32)
    c_lens = rng.integers(1, L, (B, K)).astype(np.int32)

    ref = jax_merge_pool(tuple(jnp.asarray(a) for a in (tokens, lens, scores, count, worst)),
                         jnp.asarray(c_scores), jnp.asarray(c_tokens),
                         jnp.asarray(c_lens), K)
    t = lambda a: torch.from_numpy(a).long() if a.dtype == np.int32 else torch.from_numpy(a)
    out = _merge_pool(tuple(t(a) for a in (tokens, lens, scores, count, worst)),
                      t(c_scores), t(c_tokens), t(c_lens), K)
    for got, want in zip(out, ref):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
