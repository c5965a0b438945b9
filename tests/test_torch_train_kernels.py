"""PyTorch port, the fine-tune kernels' plain versions (what the wrappers
run on CPU tensors) against the JAX package: the K1 backward (row 2), the
K2 backward (row 4) and the LM-head + CE forward and backward (rows 7-8)
against the Pallas kernels in interpret mode and against ``jax.vjp`` of the
composite; the differentiable dense, the cross-entropy head and dropout.

Tolerances: fp32 at 1e-5 (summation order only); bf16 within 2 bf16 ulps
of the reference's largest magnitude (the two sides round the same values
but may sum in another order, so a value can land one rounding apart)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kmbart_tpu.models.heads import cross_entropy_ignore_index as jax_ce
from kmbart_tpu.ops import layers as jl
from kmbart_tpu.ops.attention import attention_core, causal_bias, merge_heads, padding_bias
from kmbart_tpu.ops.attention import split_heads
from kmbart_tpu.ops.pallas_ffn import _bwd_call as jax_ffn_bwd
from kmbart_tpu.ops.pallas_ffn import fused_ffn as jax_fused_ffn
from kmbart_tpu.ops.pallas_lm_ce import _fwd_project_stats_call, fused_lm_ce as jax_lm_ce
from kmbart_tpu.ops.pallas_train_attention import train_attention_flat as jax_attention
from kmbart_tpu_torch.models.heads import cross_entropy_ignore_index
from kmbart_tpu_torch.ops import ffn, layers, lm_ce
from kmbart_tpu_torch.ops import train_attention as ta
from tests._torch_port import bf16_tol, to_jax, to_np, to_torch

FP32 = dict(rtol=1e-5, atol=1e-5)


def _close(got, want, dtype):
    want = to_np(want)
    if dtype == "float32":
        np.testing.assert_allclose(to_np(got), want, **FP32)
    else:
        np.testing.assert_allclose(to_np(got), want, rtol=0, atol=bf16_tol(want))


# ---------------------------------------------------------------------------
# row 2: the K1 backward
# ---------------------------------------------------------------------------

ATTN_CASES = {"self_padded": (16, 16, False), "causal": (16, 16, True),
              "cross": (8, 16, False)}


def _attention_inputs(Tq, Tk, B=2, H=4, hd=8, seed=0):
    rng = np.random.default_rng(seed)
    D = H * hd
    q, k, v, g = (rng.normal(size=s) for s in ((B, Tq, D), (B, Tk, D), (B, Tk, D), (B, Tq, D)))
    mask = np.ones((B, Tk), np.int32)
    mask[1, -5:] = 0
    return q, k, v, g, mask


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", list(ATTN_CASES))
def test_attention_bwd_matches_pallas_kernel(case, dtype):
    Tq, Tk, causal = ATTN_CASES[case]
    q, k, v, g, mask = _attention_inputs(Tq, Tk)
    H = 4
    jq, jk, jv = (to_jax(a, dtype) for a in (q, k, v))
    _, vjp = jax.vjp(lambda a, b, c: jax_attention(a, b, c, jnp.asarray(mask), num_heads=H,
                                                   causal=causal, interpret=True), jq, jk, jv)
    want = vjp(to_jax(g, dtype))
    td = getattr(torch, dtype)
    tq, tk, tv, tg = (to_torch(a, td) for a in (q, k, v, g))
    tm = torch.from_numpy(mask)
    got = ta.train_attention_bwd_plain(tq, tk, tv, tm, tg, num_heads=H, causal=causal)
    for a, b in zip(got, want):
        assert a.dtype == td
        _close(a, b, dtype)
    # the autograd op the model calls runs that backward on the CPU
    leaves = [t.clone().requires_grad_() for t in (tq, tk, tv)]
    ta.train_attention(*leaves, tm, num_heads=H, causal=causal).backward(tg)
    for leaf, a in zip(leaves, got):
        assert torch.equal(leaf.grad, a)


@pytest.mark.parametrize("case", list(ATTN_CASES))
def test_attention_bwd_matches_composite_vjp(case):
    """fp32: the same gradients as jax.vjp through the composite attention."""
    Tq, Tk, causal = ATTN_CASES[case]
    q, k, v, g, mask = _attention_inputs(Tq, Tk, seed=1)
    H = 4

    def composite(a, b, c):
        bias = padding_bias(jnp.asarray(mask))
        if causal:
            bias = bias + causal_bias(Tq, Tk)
        out = attention_core(split_heads(a, H), split_heads(b, H), split_heads(c, H), bias,
                             dtype=jnp.float32)
        return merge_heads(out)

    _, vjp = jax.vjp(composite, *(to_jax(a) for a in (q, k, v)))
    want = vjp(to_jax(g))
    got = ta.train_attention_bwd_plain(*(to_torch(a) for a in (q, k, v)),
                                       torch.from_numpy(mask), to_torch(g), num_heads=H,
                                       causal=causal)
    for a, b in zip(got, want):
        _close(a, b, "float32")


# ---------------------------------------------------------------------------
# row 4: the K2 backward
# ---------------------------------------------------------------------------

def _ffn_inputs(N=256, D=128, F=512, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(N, D)), rng.normal(size=(D, F)) * 0.1,
            rng.normal(size=(F,)) * 0.1, rng.normal(size=(F, D)) * 0.05,
            rng.normal(size=(D,)) * 0.1, rng.normal(size=(N, D)))


def test_ffn_bwd_matches_pallas_kernel():
    """The kernel pair on the same bf16 pre-activation: da and dx."""
    x, w1, b1, w2, b2, g = _ffn_inputs()
    bf = torch.bfloat16
    _, a = ffn.fused_ffn(to_torch(x, bf), to_torch(w1.T), to_torch(b1), to_torch(w2.T),
                         to_torch(b2), with_a=True)
    # a is the composite's first dense, rounded once
    want_a = jl.dense(to_jax(x, "bfloat16"), to_jax(w1), to_jax(b1), jnp.bfloat16)
    _close(a, want_a, "bfloat16")
    da_j, dx_j = jax_ffn_bwd(to_jax(g, "bfloat16"), to_jax(a.float().numpy(), "bfloat16"),
                             to_jax(w1, "bfloat16"), to_jax(w2, "bfloat16"), interpret=True)
    da, dx = ffn.fused_ffn_bwd_plain(to_torch(g, bf), a, to_torch(w1.T, bf),
                                     to_torch(w2.T, bf))
    assert da.dtype == dx.dtype == bf
    _close(da, da_j, "bfloat16")
    _close(dx, dx_j, "bfloat16")


def test_ffn_grads_match_pallas_vjp_and_composite():
    """All five gradients of the differentiable op against jax.vjp of the
    Pallas op (interpret) and of the composite dense -> gelu -> dense."""
    x, w1, b1, w2, b2, g = _ffn_inputs(seed=1)
    xj = to_jax(x, "bfloat16")
    params_j = [to_jax(a) for a in (w1, b1, w2, b2)]
    bf = jnp.bfloat16
    composite = lambda xx, a, b, c, d: jl.dense(jl.gelu(jl.dense(xx, a, b, bf)), c, d, bf)
    pallas = lambda xx, a, b, c, d: jax_fused_ffn(xx, a, b, c, d, interpret=True)
    leaves = [to_torch(x, torch.bfloat16).requires_grad_()]
    leaves += [to_torch(a).requires_grad_() for a in (w1.T, b1, w2.T, b2)]
    y = ffn.ffn(*leaves)
    y.backward(to_torch(g, torch.bfloat16))
    got = [leaves[0].grad, leaves[1].grad.T, leaves[2].grad, leaves[3].grad.T, leaves[4].grad]
    for fn in (pallas, composite):
        out, vjp = jax.vjp(fn, xj, *params_j)
        _close(y, out, "bfloat16")
        for a, b in zip(got, vjp(to_jax(g, "bfloat16"))):
            _close(a, b, "bfloat16")


# ---------------------------------------------------------------------------
# rows 7-8: the LM head + CE forward and backward
# ---------------------------------------------------------------------------

def _lm_inputs(B=4, T=16, D=128, V=2500, seed=0):
    rng = np.random.default_rng(seed)
    hidden = rng.normal(size=(B, T, D))
    shared = rng.normal(size=(V, D)) * 0.05
    fbias = rng.normal(size=(V,)) * 0.01
    labels = rng.integers(0, V, (B, T)).astype(np.int32)
    labels[0, :5] = -100
    return hidden, shared, fbias, labels


@pytest.mark.parametrize("all_ignored", [False, True])
def test_lm_ce_matches_pallas_fwdbwd(all_ignored):
    """V 2500 is not a multiple of the 512 tile: the ragged tail is live."""
    hidden, shared, fbias, labels = _lm_inputs()
    if all_ignored:
        labels[:] = -100

    def jax_loss(h, w):
        return jax_lm_ce(h, w, to_jax(fbias), jnp.asarray(labels), mode="fwdbwd",
                         tile_v=512, interpret=True)[0]

    loss_j, (dh_j, dw_j) = jax.value_and_grad(jax_loss, argnums=(0, 1))(
        to_jax(hidden), to_jax(shared))
    h = to_torch(hidden).requires_grad_()
    w = to_torch(shared).requires_grad_()
    loss, n = lm_ce.fused_lm_ce(h, w, to_torch(fbias), torch.from_numpy(labels).long())
    loss.backward()
    assert int(n) == int((labels != -100).sum())
    np.testing.assert_allclose(float(loss.detach()), float(loss_j), rtol=1e-5)
    if all_ignored:
        assert float(loss.detach()) == 0.0
        assert not h.grad.any() and not w.grad.any()
    _close(h.grad, dh_j, "bfloat16")
    _close(w.grad, dw_j, "bfloat16")


def test_lm_ce_fwd_stats_match_pallas_kernel():
    hidden, shared, fbias, labels = _lm_inputs(B=2, T=8, V=1100, seed=2)
    safe = np.maximum(labels.reshape(-1), 0).astype(np.int32)
    hb = to_jax(hidden.reshape(-1, 128), "bfloat16")
    logits_j, m_j, se_j, ll_j = _fwd_project_stats_call(
        hb, to_jax(shared, "bfloat16"), to_jax(fbias).reshape(1, -1),
        jnp.asarray(safe).reshape(-1, 1), 512, jnp.bfloat16, True)
    bf = torch.bfloat16
    logits, m, se, ll = lm_ce.lm_ce_fwd_plain(to_torch(hidden.reshape(-1, 128), bf),
                                              to_torch(shared, bf), to_torch(fbias),
                                              torch.from_numpy(safe))
    _close(logits, logits_j, "bfloat16")
    for a, b in ((m, m_j), (se, se_j), (ll, ll_j)):
        np.testing.assert_allclose(a.numpy(), to_np(b)[:, 0], rtol=1e-5, atol=1e-5)


def test_cross_entropy_head_matches_jax():
    """The composite head at fp32 (its custom gradient) and at bf16 (dlogits
    emitted in the logits dtype)."""
    rng = np.random.default_rng(3)
    logits = rng.normal(size=(3, 5, 40)) * 3
    labels = rng.integers(0, 40, (3, 5)).astype(np.int32)
    labels[1, 2:] = -100
    for dtype in ("float32", "bfloat16"):
        (loss_j, n_j), vjp = jax.vjp(lambda x: jax_ce(x, jnp.asarray(labels)),
                                     to_jax(logits, dtype))
        g_j, = vjp((jnp.float32(1.0), jnp.zeros((), jnp.int32)))
        x = to_torch(logits, getattr(torch, dtype)).requires_grad_()
        loss, n = cross_entropy_ignore_index(x, torch.from_numpy(labels).long())
        loss.backward()
        assert int(n) == int(n_j) and x.grad.dtype == x.dtype
        np.testing.assert_allclose(float(loss.detach()), float(loss_j), rtol=1e-5)
        _close(x.grad, g_j, dtype)


def test_lm_ce_gate():
    """The JAX gate without its TPU clauses, plus the kernels' bf16."""
    bf = torch.bfloat16
    assert lm_ce.supported(5120, 50320, 768, bf)
    assert not lm_ce.supported(5121, 50320, 768, bf)       # rows in tiles of 8
    assert not lm_ce.supported(5120, 50320, 32, bf)        # d_model % 128
    assert not lm_ce.supported(5120, 1000, 768, bf)        # vocab >= 1024
    assert not lm_ce.supported(5120, 50320, 768, torch.float32)


# ---------------------------------------------------------------------------
# dense gradients and dropout
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dense_grads_match_jax(dtype):
    rng = np.random.default_rng(4)
    x, w, b, g = rng.normal(size=(4, 6, 24)), rng.normal(size=(24, 40)), \
        rng.normal(size=(40,)), rng.normal(size=(4, 6, 40))
    jd, td = jnp.dtype(dtype), getattr(torch, dtype)
    _, vjp = jax.vjp(lambda a, k, c: jl.dense(a, k, c, jd), to_jax(x, dtype), to_jax(w),
                     to_jax(b))
    want = vjp(to_jax(g, dtype))
    leaves = [to_torch(x, td).requires_grad_(), to_torch(w.T).requires_grad_(),
              to_torch(b).requires_grad_()]
    layers.dense(*leaves, td).backward(to_torch(g, td))
    for got, ref in zip((leaves[0].grad, leaves[1].grad.T, leaves[2].grad), want):
        _close(got, ref, dtype)


def test_dropout():
    x = torch.ones((400, 250))
    gen = lambda: torch.Generator().manual_seed(7)
    assert layers.dropout(x, 0.0, gen(), True) is x            # rate 0
    assert layers.dropout(x, 0.1, gen(), False) is x           # eval
    assert layers.dropout(x, 0.1, None, True) is x             # no generator
    y = layers.dropout(x, 0.1, gen(), True)
    keep = float((y != 0).float().mean())
    assert abs(keep - 0.9) < 0.01
    assert abs(float(y.mean()) - 1.0) < 0.01                   # E[dropout(x)] == x
    assert torch.equal(y, layers.dropout(x, 0.1, gen(), True))  # same generator, same mask
    assert not torch.equal(y, layers.dropout(x, 0.1, torch.Generator().manual_seed(8), True))
    xb = x.to(torch.bfloat16)
    assert layers.dropout(xb, 0.1, gen(), True).dtype == torch.bfloat16


def test_new_wrappers_refuse_other_devices():
    """Only a CPU tensor selects a plain version; other devices go to the
    kernel launch path, which refuses what it cannot run."""
    m = lambda *s: torch.empty(s, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        ta.train_attention_bwd(m(1, 8, 32), m(1, 8, 32), m(1, 8, 32), None, m(1, 8, 32),
                               num_heads=4)
    with pytest.raises(ValueError, match="no kernel"):
        ffn.fused_ffn_bwd(m(4, 32), m(4, 64), m(64, 32), m(32, 64))
    with pytest.raises(ValueError, match="no kernel"):
        lm_ce.lm_ce_fwd(m(8, 128), m(1024, 128), m(1024), m(8).int())
    with pytest.raises(ValueError, match="no kernel"):
        lm_ce.lm_ce_bwd(m(8, 1024), m(1024, 128), m(8), m(8), m(8), m(8).int())
