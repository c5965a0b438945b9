"""PyTorch port, kernels K1 and K3: the plain versions (what the wrappers
run on CPU tensors) against the JAX package's XLA twins and its Pallas
kernels in interpret mode, at fp32 and bf16; and how K1's wrappers take
their inputs (row-strided fused QKV chunks, the key mask)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kmbart_tpu.ops import pallas_beam_attention as jba
from kmbart_tpu.ops.attention import (attention_core, causal_bias, merge_heads,
                                      padding_bias, split_heads)
from kmbart_tpu.ops.pallas_train_attention import train_attention_flat as jax_train_attention
from kmbart_tpu_torch.ops import beam_attention as ba
from kmbart_tpu_torch.ops import train_attention as ta
from tests._torch_port import bf16_tol, to_jax, to_np, to_torch


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", ["padding", "causal", "cross"])
def test_train_attention_matches_jax(case, dtype):
    rng = np.random.default_rng(1)
    B, Tq, H, hd = 2, 16, 4, 8
    Tk = 24 if case == "cross" else Tq
    D = H * hd
    q, k, v = (rng.normal(size=(B, T, D)) for T in (Tq, Tk, Tk))
    mask = np.ones((B, Tk), np.int32)
    mask[1, -5:] = 0
    causal = case == "causal"

    qj, kj, vj = (to_jax(a, dtype) for a in (q, k, v))
    bias = padding_bias(jnp.asarray(mask))
    if causal:
        bias = bias + causal_bias(Tq, Tk)
    twin = merge_heads(attention_core(split_heads(qj, H), split_heads(kj, H),
                                      split_heads(vj, H), bias, dtype=jnp.dtype(dtype)))
    kernel = jax_train_attention(qj, kj, vj, jnp.asarray(mask), num_heads=H,
                                 causal=causal, interpret=True)

    td = getattr(torch, dtype)
    out = ta.train_attention_flat(to_torch(q, td), to_torch(k, td), to_torch(v, td),
                                  torch.from_numpy(mask), num_heads=H, causal=causal)
    assert out.dtype == td and out.shape == (B, Tq, D)
    for ref in (to_np(twin), to_np(kernel)):
        if dtype == "float32":
            # same fp32 math; only the summation order differs
            np.testing.assert_allclose(to_np(out), ref, rtol=1e-5, atol=1e-5)
        else:
            # bf16 out of fp32 math: a last-bit difference before a rounding
            # (q·scale, P, the output) moves at most 2 bf16 ulps
            np.testing.assert_allclose(to_np(out), ref, rtol=0, atol=bf16_tol(ref))


def test_train_attention_without_mask_equals_all_keep():
    rng = np.random.default_rng(2)
    q, k, v = (to_torch(rng.normal(size=(2, 8, 32))) for _ in range(3))
    ones = torch.ones((2, 8), dtype=torch.long)
    a = ta.train_attention_flat(q, k, v, None, num_heads=4)
    b = ta.train_attention_flat(q, k, v, ones, num_heads=4)
    assert torch.equal(a, b)


def test_row_stride_takes_fused_chunks_and_refuses_other_layouts():
    """The kernels read q, k, v by row stride: the chunks of a fused [B, T,
    3D] projection go in as they are; other layouts raise."""
    qkv = torch.zeros((2, 5, 96), dtype=torch.bfloat16)
    assert [ta.row_stride(t, "t") for t in qkv.chunk(3, dim=-1)] == [96, 96, 96]
    assert ta.row_stride(torch.zeros((2, 5, 32)), "t") == 32
    assert ta.row_stride(torch.zeros((1, 1, 32), dtype=torch.bfloat16), "t") == 32
    with pytest.raises(ValueError, match="by stride"):
        ta.row_stride(torch.zeros((2, 32, 5)).transpose(1, 2), "t")   # columns strided
    with pytest.raises(ValueError, match="by stride"):
        ta.row_stride(torch.zeros((4, 5, 32))[::2], "t")              # batches apart
    with pytest.raises(ValueError, match="16-byte"):
        ta.row_stride(torch.zeros((2, 5, 33), dtype=torch.bfloat16)[..., 1:], "t")


@pytest.mark.parametrize("causal", [False, True], ids=["padding", "causal"])
def test_train_attention_on_fused_chunks(causal):
    """Self-attention hands K1 the strided chunks of its fused projection:
    outputs and the gradient of the fused projection equal those of
    contiguous copies."""
    rng = np.random.default_rng(3)
    mask = torch.ones((2, 8), dtype=torch.long)
    mask[1, -3:] = 0
    qkv = to_torch(rng.normal(size=(2, 8, 96)))
    g = to_torch(rng.normal(size=(2, 8, 32)))
    outs, grads = [], []
    for copy in (False, True):
        x = qkv.clone().requires_grad_()
        q, k, v = (t.contiguous() if copy else t for t in x.chunk(3, dim=-1))
        out = ta.train_attention(q, k, v, mask, num_heads=4, causal=causal)
        out.backward(g)
        outs.append(out.detach())
        grads.append(x.grad)
    assert torch.equal(outs[0], outs[1])
    assert torch.equal(grads[0], grads[1])


def test_kernel_mask_is_int64_on_the_device():
    assert ta._kernel_mask(None, 2, 8, "cpu") is None
    for mask in (torch.ones((2, 8), dtype=torch.bool), torch.ones((2, 8), dtype=torch.int32)):
        got = ta._kernel_mask(mask, 2, 8, "cpu")
        assert got.dtype == torch.int64 and got.is_contiguous() and bool((got == 1).all())
    same = torch.ones((2, 8), dtype=torch.long)
    assert ta._kernel_mask(same, 2, 8, "cpu") is same    # no copy
    with pytest.raises(ValueError, match="key_mask of shape"):
        ta._kernel_mask(torch.ones((2, 7)), 2, 8, "cpu")


def _beam_inputs(rng, B, K, T, H, hd):
    D = H * hd
    q = rng.normal(size=(B * K, D)) * hd ** -0.5
    kc = rng.normal(size=(B, K, T, D))
    vc = rng.normal(size=(B, K, T, D))
    # branching ancestry: each live beam's history runs through random slots
    anc = rng.integers(0, K, size=(B * K, T)).astype(np.int32)
    return q, kc, vc, anc


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("cache_index", [0, 6, 11], ids=["first", "mid", "last"])
def test_beam_attention_matches_jax(cache_index, dtype):
    rng = np.random.default_rng(3 + cache_index)
    B, K, T, H, hd = 2, 3, 12, 4, 8
    q, kc, vc, anc = _beam_inputs(rng, B, K, T, H, hd)

    qj, kj, vj = (to_jax(a, dtype) for a in (q, kc, vc))
    sel = jba.build_selection_mask(jnp.asarray(anc), K, cache_index, H)
    twin = jba.beam_gather_attention_reference(qj, kj, vj, sel, num_beams=K, num_heads=H)
    kernel = jba.beam_gather_attention(qj, kj, vj, sel, num_beams=K, num_heads=H,
                                       interpret=True)

    td = getattr(torch, dtype)
    anc_t = torch.from_numpy(anc)
    np.testing.assert_array_equal(
        to_np(ba.build_selection_mask(anc_t, K, cache_index, H)), to_np(sel))
    out = ba.beam_gather_attention(to_torch(q, td), to_torch(kc, td), to_torch(vc, td),
                                   anc_t, cache_index, num_beams=K, num_heads=H)
    assert out.dtype == torch.float32 and out.shape == (B * K, H * hd)
    # against the XLA twin: both round q, K, V and P to bf16 and do the rest
    # in fp32, so fp32 summation order is the only difference
    np.testing.assert_allclose(to_np(out), to_np(twin), rtol=1e-5, atol=1e-5)
    # the Pallas kernel also rounds its output to bf16 (its head fold is a
    # bf16 MXU matmul, pallas_beam_attention.py:200): within 2 bf16 ulps
    ref = to_np(kernel)
    np.testing.assert_allclose(to_np(out), ref, rtol=0, atol=bf16_tol(ref))


def test_beam_attention_ignores_unwritten_positions():
    """Entries past cache_index (cache rows and ancestry alike) never
    reach the output."""
    rng = np.random.default_rng(9)
    B, K, T, H, hd = 2, 3, 10, 2, 8
    q, kc, vc, anc = (torch.from_numpy(np.asarray(a)) for a in _beam_inputs(rng, B, K, T, H, hd))
    q, kc, vc = q.float(), kc.float(), vc.float()
    out = ba.beam_gather_attention(q, kc, vc, anc, 4, num_beams=K, num_heads=H)
    kc2, vc2, anc2 = kc.clone(), vc.clone(), anc.clone()
    kc2[:, :, 5:] = 1e3
    vc2[:, :, 5:] = -1e3
    anc2[:, 5:] = (anc2[:, 5:] + 1) % K
    again = ba.beam_gather_attention(q, kc2, vc2, anc2, 4, num_beams=K, num_heads=H)
    assert torch.equal(out, again)
