"""PyTorch port, the pretraining slice's kernels' plain versions (what the
wrappers run on CPU tensors) against the JAX package: K9 and K10, the LM-CE
"nomat" pair (rows 9-10), against the Pallas kernels in interpret mode; the
differentiable ``fused_lm_ce`` in its three modes against the JAX op; K11,
the flash attention (row 11), against ``flash_attention`` in interpret mode
and its custom VJP; and the attention routing of ``multi_head_attention``
against the JAX package at a length only K11 takes.

Tolerances: fp32 at 1e-5 (summation order only) or, for K11, the JAX flash
tests' own 2e-5 / 2e-6 (online rescaling adds a few roundings per key
tile); bf16 within 2 bf16 ulps of the reference's largest magnitude (the
two sides round the same values but may sum in another order)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kmbart_tpu.ops.attention import multi_head_attention as jax_mha
from kmbart_tpu.ops.pallas_attention import flash_attention as jax_flash
from kmbart_tpu.ops.pallas_attention import flash_self_attention as jax_flash_self
from kmbart_tpu.ops.pallas_lm_ce import _fwd_stats_call, _recompute_bwd_call
from kmbart_tpu.ops.pallas_lm_ce import fused_lm_ce as jax_lm_ce
from kmbart_tpu_torch.models.bart import Attention
from kmbart_tpu_torch.ops import attention, launch_counts, lm_ce
from kmbart_tpu_torch.ops import flash_attention as fa
from tests._torch_port import bf16_tol, to_jax, to_np, to_torch

FP32 = dict(rtol=1e-5, atol=1e-5)
FLASH = dict(rtol=2e-5, atol=2e-6)     # tests/test_pallas.py's bound for the same kernel
FLASH_GRAD = dict(rtol=2e-4, atol=2e-5)


def _bf16_close(got, want):
    want = to_np(want)
    np.testing.assert_allclose(to_np(got), want, rtol=0, atol=bf16_tol(want))


# ---------------------------------------------------------------------------
# rows 9-10: the LM-CE "nomat" kernels
# ---------------------------------------------------------------------------

def _lm_inputs(B=2, T=8, D=128, V=1100, seed=0):
    rng = np.random.default_rng(seed)
    hidden = rng.normal(size=(B, T, D))
    shared = rng.normal(size=(V, D)) * 0.05
    fbias = rng.normal(size=(V,)) * 0.01
    labels = rng.integers(0, V, (B, T)).astype(np.int32)
    labels[0, :3] = -100
    return hidden, shared, fbias, labels


def test_fwd_stats_matches_pallas_kernel():
    """K9 at V 1100 with tile 512: the ragged last vocab tile is live."""
    hidden, shared, fbias, labels = _lm_inputs()
    safe = np.maximum(labels.reshape(-1), 0).astype(np.int32)
    m_j, se_j, ll_j = _fwd_stats_call(
        to_jax(hidden.reshape(-1, 128), "bfloat16"), to_jax(shared, "bfloat16"),
        to_jax(fbias).reshape(1, -1), jnp.asarray(safe).reshape(-1, 1), 512, jnp.bfloat16,
        True)
    bf = torch.bfloat16
    m, se, ll = lm_ce.lm_ce_fwd_stats(to_torch(hidden.reshape(-1, 128), bf),
                                      to_torch(shared, bf), to_torch(fbias),
                                      torch.from_numpy(safe))
    for a, b in ((m, m_j), (se, se_j), (ll, ll_j)):
        assert a.dtype == torch.float32
        np.testing.assert_allclose(a.numpy(), to_np(b)[:, 0], **FP32)


def test_recompute_bwd_matches_pallas_kernel():
    """K10: dlogits from the recomputed bf16 logits, and dh."""
    hidden, shared, fbias, labels = _lm_inputs(seed=1)
    flat = labels.reshape(-1)
    safe = np.maximum(flat, 0).astype(np.int32)
    N = flat.shape[0]
    bf = torch.bfloat16
    h, w = to_torch(hidden.reshape(-1, 128), bf), to_torch(shared, bf)
    m, se, _ = lm_ce.lm_ce_fwd_stats(h, w, to_torch(fbias), torch.from_numpy(safe))
    scale = ((flat != -100) / max(1, int((flat != -100).sum()))).astype(np.float32)
    col = lambda a: jnp.asarray(np.asarray(a, np.float32)).reshape(N, 1)
    dl_j, dh_j = _recompute_bwd_call(
        to_jax(hidden.reshape(-1, 128), "bfloat16"), to_jax(shared, "bfloat16"),
        to_jax(fbias).reshape(1, -1), col(m), col(1.0 / se), col(scale),
        jnp.asarray(safe).reshape(-1, 1), 512, jnp.bfloat16, True)
    dl, dh = lm_ce.lm_ce_recompute_bwd(h, w, to_torch(fbias), m, 1.0 / se,
                                       torch.from_numpy(scale), torch.from_numpy(safe))
    assert dl.dtype == dh.dtype == bf and dl.shape == (N, 1100)
    _bf16_close(dl, dl_j)
    _bf16_close(dh, dh_j)


@pytest.mark.parametrize("mode", ["fwdbwd", "nomat", "bwd"])
def test_fused_lm_ce_modes_match_jax(mode):
    """The differentiable loss in each mode against the JAX op in the same
    mode (interpret): the loss, dh and dW."""
    hidden, shared, fbias, labels = _lm_inputs(B=4, T=16, V=2500, seed=2)

    def jax_loss(h, w):
        return jax_lm_ce(h, w, to_jax(fbias), jnp.asarray(labels), mode=mode, tile_v=512,
                         interpret=True)[0]

    loss_j, (dh_j, dw_j) = jax.value_and_grad(jax_loss, argnums=(0, 1))(
        to_jax(hidden), to_jax(shared))
    h = to_torch(hidden).requires_grad_()
    w = to_torch(shared).requires_grad_()
    loss, n = lm_ce.fused_lm_ce(h, w, to_torch(fbias), torch.from_numpy(labels).long(),
                                mode=mode)
    loss.backward()
    assert int(n) == int((labels != -100).sum())
    np.testing.assert_allclose(float(loss.detach()), float(loss_j), rtol=1e-5)
    _bf16_close(h.grad, dh_j)
    _bf16_close(w.grad, dw_j)


def test_mode_selection(monkeypatch):
    """``mode``, then ``recompute``, then KMBART_FUSED_CE_MODE, then
    "fwdbwd" (pallas_lm_ce.py:506-510); "nomat" reaches K9 and K10."""
    monkeypatch.delenv("KMBART_FUSED_CE_MODE", raising=False)
    assert lm_ce.resolve_mode() == "fwdbwd"
    assert lm_ce.resolve_mode(recompute=True) == "nomat"
    assert lm_ce.resolve_mode(recompute=False) == "bwd"
    monkeypatch.setenv("KMBART_FUSED_CE_MODE", "nomat")
    assert lm_ce.resolve_mode() == "nomat"
    assert lm_ce.resolve_mode(recompute=False) == "bwd"
    assert lm_ce.resolve_mode(mode="fwdbwd", recompute=True) == "fwdbwd"
    with pytest.raises(ValueError, match="mode"):
        lm_ce.resolve_mode(mode="fused")

    calls = []
    for name in ("lm_ce_fwd", "lm_ce_bwd", "lm_ce_fwd_stats", "lm_ce_recompute_bwd"):
        fn = getattr(lm_ce, name)
        monkeypatch.setattr(lm_ce, name,
                            lambda *a, _fn=fn, _n=name: calls.append(_n) or _fn(*a))
    hidden, shared, fbias, labels = _lm_inputs(seed=3)
    h = to_torch(hidden).requires_grad_()
    lm_ce.fused_lm_ce(h, to_torch(shared), to_torch(fbias),
                      torch.from_numpy(labels).long())[0].backward()
    assert calls == ["lm_ce_fwd_stats", "lm_ce_recompute_bwd"]
    calls.clear()
    lm_ce.fused_lm_ce(h, to_torch(shared), to_torch(fbias), torch.from_numpy(labels).long(),
                      recompute=False)[0].backward()
    assert calls == ["lm_ce_bwd"]


# ---------------------------------------------------------------------------
# row 11: the flash attention
# ---------------------------------------------------------------------------

def _qkv(rng, B=2, Tq=16, Tk=16, H=4, hd=8):
    D = H * hd
    return (rng.normal(size=(B, Tq, D)), rng.normal(size=(B, Tk, D)),
            rng.normal(size=(B, Tk, D)))


def _to_bh(x, H):
    B, T, D = x.shape
    return jnp.asarray(x).reshape(B, T, H, D // H).transpose(0, 2, 1, 3).reshape(B * H, T, -1)


FLASH_CASES = {"padded": (16, 16, False), "causal": (16, 16, True),
               "cross": (8, 24, False), "ragged_tiles": (24, 40, False)}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", list(FLASH_CASES))
def test_flash_matches_pallas_kernel(case, dtype):
    """Against flash_attention(interpret=True) with blocks of 8, as
    tests/test_pallas.py runs it; bf16 inputs are read as fp32, so the
    fp32 bound holds for both."""
    Tq, Tk, causal = FLASH_CASES[case]
    H = 4
    q, k, v = _qkv(np.random.default_rng(0), Tq=Tq, Tk=Tk, H=H)
    mask = np.ones((2, Tk), np.int32)
    mask[1, -5:] = 0
    jd = jnp.dtype(dtype)
    jq, jk, jv = (_to_bh(to_np(to_jax(a, dtype)), H).astype(jd) for a in (q, k, v))
    key_bias = jnp.repeat(jnp.where(jnp.asarray(mask).astype(bool), 0.0, -1e9), H, axis=0)
    want = jax_flash(jq, jk, jv, key_bias, block_q=8, block_k=8, causal=causal,
                     interpret=True)
    want = np.asarray(want).reshape(2, H, Tq, -1).transpose(0, 2, 1, 3).reshape(2, Tq, -1)
    td = getattr(torch, dtype)
    got = fa.flash_attention(to_torch(q, td), to_torch(k, td), to_torch(v, td),
                             torch.from_numpy(mask), num_heads=H, causal=causal)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **FLASH)


def test_flash_fully_masked_row_matches_pallas_kernel():
    """A row whose every key is padded averages v over all keys, in both."""
    q, k, v = _qkv(np.random.default_rng(1), B=1)
    mask = np.zeros((1, 16), np.int32)
    key_bias = jnp.repeat(jnp.full((1, 16), -1e9, jnp.float32), 4, axis=0)
    want = jax_flash(_to_bh(q, 4), _to_bh(k, 4), _to_bh(v, 4), key_bias, block_q=8,
                     block_k=8, interpret=True)
    got = fa.flash_attention(to_torch(q), to_torch(k), to_torch(v), torch.from_numpy(mask),
                             num_heads=4)
    want = np.asarray(want).reshape(1, 4, 16, 8).transpose(0, 2, 1, 3).reshape(1, 16, 32)
    np.testing.assert_allclose(got.numpy(), want, **FLASH)


@pytest.mark.parametrize("causal,Tq,Tk", [(False, 16, 16), (True, 16, 16), (False, 8, 24)])
def test_flash_self_attention_matches_jax_and_grads(causal, Tq, Tk):
    """Output and gradients against flash_self_attention(interpret=True)
    (Pallas forward, XLA-math backward) at fp32."""
    H = 2
    q, k, v = _qkv(np.random.default_rng(2), B=1, Tq=Tq, Tk=Tk, H=H)
    mask = np.ones((1, Tk), np.int32)
    mask[0, -4:] = 0
    split = lambda a: jnp.asarray(a).reshape(a.shape[0], a.shape[1], H, -1)

    def loss_jax(a, b, c):
        out = jax_flash_self(a, b, c, jnp.asarray(mask), causal=causal, interpret=True,
                             dtype=jnp.float32)
        return jnp.sum(out ** 2), out

    (_, out_j), grads_j = jax.value_and_grad(loss_jax, argnums=(0, 1, 2), has_aux=True)(
        split(q), split(k), split(v))
    leaves = [to_torch(a).requires_grad_() for a in (q, k, v)]
    out = fa.flash_self_attention(*leaves, torch.from_numpy(mask), num_heads=H,
                                  causal=causal)
    (out ** 2).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(),
                               np.asarray(out_j).reshape(out.shape), **FLASH)
    for leaf, g in zip(leaves, grads_j):
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(g).reshape(leaf.shape),
                                   **FLASH_GRAD)


def test_flash_backward_keeps_input_dtype():
    """bf16 leaves get bf16 gradients, as the JAX VJP returns them."""
    bf = torch.bfloat16
    q, k, v = _qkv(np.random.default_rng(3))
    leaves = [to_torch(a, bf).requires_grad_() for a in (q, k, v)]
    out = fa.flash_self_attention(*leaves, None, num_heads=4, causal=True)
    out.sum().backward()
    assert out.dtype == torch.float32
    assert all(t.grad.dtype == bf and torch.isfinite(t.grad.float()).all() for t in leaves)


def test_flash_gate():
    """The JAX gate (pallas_attention.py:158-177) without its TPU and
    dropout clauses."""
    assert fa.supported(128, 128, 64)
    assert fa.supported(264, 264, 64, causal=True)
    assert not fa.supported(120, 128, 64)              # Tq·Tk < 128²
    assert not fa.supported(260, 260, 64)              # lengths % 8
    assert not fa.supported(264, 264, 12)              # head_dim % 8
    assert not fa.supported(264, 272, 64, causal=True)  # causal needs Tq == Tk
    assert not fa.supported(264, 264, 136)             # the kernel's head_dim bound


# ---------------------------------------------------------------------------
# attention routing and multi_head_attention at a length only K11 takes
# ---------------------------------------------------------------------------

def _attention_module(rng, D):
    attn = Attention(D)
    with torch.no_grad():
        for lin in (attn.q_proj, attn.k_proj, attn.v_proj, attn.out_proj):
            lin.weight.copy_(torch.from_numpy(rng.normal(size=(D, D)) * 0.1))
            lin.bias.copy_(torch.from_numpy(rng.normal(size=(D,)) * 0.1))
    jparams = {}
    for lin, name in ((attn.q_proj, "q"), (attn.k_proj, "k"), (attn.v_proj, "v"),
                      (attn.out_proj, "o")):
        jparams[f"{name}_kernel"] = jnp.asarray(lin.weight.detach().numpy().T)
        jparams[f"{name}_bias"] = jnp.asarray(lin.bias.detach().numpy())
    return attn, jparams


@pytest.mark.parametrize("kind", ["self", "causal", "cross"])
def test_multi_head_attention_long_matches_jax(kind):
    """T 264 (> 256, so not K1): the port routes to K11 and matches the JAX
    package's attention at fp32 (its composite on the CPU)."""
    rng = np.random.default_rng(4)
    B, T, D, H = 2, 264, 32, 4
    Tk = 72 if kind == "cross" else T   # 264·72 >= 128²
    attn, jparams = _attention_module(rng, D)
    x = rng.normal(size=(B, T, D)).astype(np.float32)
    src = rng.normal(size=(B, Tk, D)).astype(np.float32) if kind == "cross" else None
    mask = np.ones((B, Tk), np.int32)
    mask[1, -7:] = 0
    kw = dict(num_heads=H, key_mask=None if kind == "causal" else mask,
              causal=kind == "causal")
    want, _ = jax_mha(jparams, jnp.asarray(x), None if src is None else jnp.asarray(src),
                      dtype=jnp.float32, **{**kw, "key_mask": None if kw["key_mask"] is None
                                             else jnp.asarray(mask)})
    before = launch_counts()["flash_attention"]
    calls = []
    orig = fa.flash_attention
    fa.flash_attention = lambda *a, **k: calls.append(1) or orig(*a, **k)
    try:
        got = attention.multi_head_attention(
            attn, torch.from_numpy(x), None if src is None else torch.from_numpy(src),
            dtype=torch.float32, **{**kw, "key_mask": None if kw["key_mask"] is None
                                    else torch.from_numpy(mask)})
    finally:
        fa.flash_attention = orig
    assert calls and launch_counts()["flash_attention"] == before   # plain version on the CPU
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **FP32)


@pytest.mark.parametrize("T,H,route", [(72, 12, "k1"), (264, 12, "k11"), (128, 16, "k11"),
                                       (72, 16, "composite"), (120, 16, "composite")])
def test_attention_routing(T, H, route, monkeypatch):
    """K1 up to 256 tokens and 12 heads, else K11 from 128² scores, else
    the composite (ops/attention.py:110-130 and 186-197)."""
    rng = np.random.default_rng(5)
    D = 8 * H
    attn, _ = _attention_module(rng, D)
    taken = []
    monkeypatch.setattr(attention, "train_attention",
                        lambda *a, **k: taken.append("k1") or torch.zeros(a[0].shape))
    monkeypatch.setattr(attention, "flash_self_attention",
                        lambda *a, **k: taken.append("k11") or torch.zeros(a[0].shape))
    x = torch.from_numpy(rng.normal(size=(1, T, D)).astype(np.float32))
    attention.multi_head_attention(attn, x, num_heads=H, key_mask=torch.ones(1, T),
                                   dtype=torch.float32)
    assert taken == ([] if route == "composite" else [route])
    # attention-prob dropout in training keeps every length on the composite
    taken.clear()
    attention.multi_head_attention(attn, x, num_heads=H, key_mask=torch.ones(1, T),
                                   dtype=torch.float32, dropout_rate=0.1, train=True,
                                   generator=torch.Generator().manual_seed(0))
    assert taken == []


@pytest.mark.parametrize("hd,H", [(128, 8), (96, 4), (256, 4)])
def test_attention_routing_wide_heads(hd, H, monkeypatch):
    """A head wider than BART's 64 goes to K1 up to 12 heads, as the JAX
    package's gate routes it on the TPU (pallas_train_attention.py:402-441),
    not to K11 or the composite."""
    from kmbart_tpu.ops import pallas_train_attention as jpta
    from kmbart_tpu_torch.ops import train_attention as ta
    monkeypatch.setattr(jpta.jax, "default_backend", lambda: "tpu")
    monkeypatch.delenv("KMBART_NO_FUSED_ATTN", raising=False)
    monkeypatch.delenv("KMBART_FUSED_ATTN_HEADS_MAX", raising=False)
    T = 72
    assert ta.supported(T, T, hd)
    rng = np.random.default_rng(6)
    D = hd * H
    attn, _ = _attention_module(rng, D)
    taken = []
    monkeypatch.setattr(attention, "train_attention",
                        lambda *a, **k: taken.append("k1") or torch.zeros(a[0].shape))
    monkeypatch.setattr(attention, "flash_self_attention",
                        lambda *a, **k: taken.append("k11") or torch.zeros(a[0].shape))
    x = torch.from_numpy(rng.normal(size=(1, T, D)).astype(np.float32))
    for causal in (False, True):
        assert jpta.train_attention_supported(T, T, hd, H, 0.0, True, causal=causal)
        attention.multi_head_attention(attn, x, num_heads=H, key_mask=torch.ones(1, T),
                                       causal=causal, dtype=torch.float32)
    assert taken == ["k1", "k1"]


def test_new_wrappers_refuse_other_devices():
    """Only a CPU tensor selects a plain version; other devices go to the
    kernel launch path, which refuses what it cannot run."""
    m = lambda *s: torch.empty(s, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        lm_ce.lm_ce_fwd_stats(m(8, 128), m(1024, 128), m(1024), m(8).int())
    with pytest.raises(ValueError, match="no kernel"):
        lm_ce.lm_ce_recompute_bwd(m(8, 128), m(1024, 128), m(1024), m(8), m(8), m(8),
                                  m(8).int())
    with pytest.raises(ValueError, match="no kernel"):
        fa.flash_attention(m(1, 8, 32), m(1, 8, 32), m(1, 8, 32), None, num_heads=4)
