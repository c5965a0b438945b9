"""PyTorch port, K11 on the tensor cores (csrc/flash_attention.cu): a CPU
emulation of the bf16 kernel's arithmetic against the JAX package's flash
kernel (``flash_attention(interpret=True)``), and the rule by which a causal
query tile skips key tiles.

The emulation does what the kernel does, in the kernel's order: scores from
the bf16 q and k in fp32, scaled after the product and carried in the log2
domain (p = exp2(s·log2 e − m·log2 e)); key tiles of 64 and query tiles of
64; the online softmax from m = -1e9 in fp32; P·V as two products with
p_hi = bf16(p) and p_lo = bf16(p - p_hi) (``p_split``), l summed from the
fp32 p; the tiles ``keys_read`` allows.

Tolerance: FLASH_RTOL (2e-5) of max(1, max|v|), as chip_smoke.py holds the
kernel to the plain version on the card. It holds because p_hi + p_lo is
within 2^-16 p of p (each bf16 rounding keeps 8 significant bits, the
second of a residual at most 2^-8 p), and the output is a convex combination
of v rows, so the split moves it by at most 2^-16 max|v| = 1.5e-5 max|v|;
the scores are the same products summed in another order (a few fp32
ulps)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kmbart_tpu.ops.pallas_attention import flash_attention as jax_flash
from kmbart_tpu_torch.ops import flash_attention as fa
from tests._torch_port import to_torch

FLASH_RTOL = 2e-5   # chip_smoke.py: K11 against its plain version, of max(1, max|v|)
TILE_Q = 64         # csrc/flash_attention.cu kBQ
TILE_K = 64         # csrc/flash_attention.cu kBK
LOG2E = 1.4426950408889634


def keys_read(keeps_key0, q0, k_len, causal):
    """The kernel's rule (device function ``keys_read``): the keys [0, n) it
    reads for the query tile that starts at row q0, given whether the batch
    row keeps key 0. A causal tile skips the key tiles wholly above its
    diagonal only where key 0 is kept: every query row then has a finite
    score, so each skipped term would be exp(−1e9 − m) = 0 in fp32, the same
    bits. Where key 0 is masked a row may have no finite score, and such a
    row averages over all Tk keys. On the card, chip_smoke.py's "key0" rows
    hold the kernel's branch to the plain version."""
    if causal and keeps_key0:
        return min(k_len, q0 + TILE_Q)
    return k_len


def _emulate(q, k, v, bias, causal, skip=True):
    """The bf16 kernel's arithmetic. q [BH, Tq, hd], k, v [BH, Tk, hd] fp32
    holding bf16 values; bias [BH, Tk] (0 or -1e9). ``skip=False`` reads
    every key tile, whatever ``keys_read`` says."""
    BH, Tq, hd = q.shape
    Tk = k.shape[1]
    scale = hd ** -0.5
    out = torch.empty((BH, Tq, hd))
    for bh in range(BH):
        for q0 in range(0, Tq, TILE_Q):
            rows = torch.arange(q0, min(q0 + TILE_Q, Tq))
            s_rows = (q[bh, rows] @ k[bh].t()) * scale
            m = torch.full((len(rows),), -1e9 * LOG2E)
            l = torch.zeros(len(rows))
            acc = torch.zeros((len(rows), hd))
            n_keys = keys_read(bool(bias[bh, 0] == 0), q0, Tk, causal) if skip else Tk
            for k0 in range(0, n_keys, TILE_K):
                keys = torch.arange(k0, min(k0 + TILE_K, Tk))
                s = s_rows[:, keys] + bias[bh, keys]
                if causal:
                    s = torch.where(keys[None, :] > rows[:, None], -1e9, s)
                s = s * LOG2E
                m_new = torch.maximum(m, s.amax(dim=1))
                p = torch.exp2(s - m_new[:, None])
                alpha = torch.exp2(m - m_new)
                hi, lo = fa.p_split(p)
                acc = acc * alpha[:, None] + hi @ v[bh, keys] + lo @ v[bh, keys]
                l = l * alpha + p.sum(dim=1)
                m = m_new
            out[bh, rows] = acc / l.clamp(min=1e-30)[:, None]
    return out


def _inputs(seed, B, H, Tq, Tk, hd, pad):
    """bf16-valued q, k, v [B·H, T, hd] (fp32) and the key bias [B·H, Tk]:
    the odd batch rows' last ``pad`` keys masked."""
    rng = np.random.default_rng(seed)
    q, k, v = (to_torch(rng.normal(size=(B * H, T, hd)), torch.bfloat16).float()
               for T in (Tq, Tk, Tk))
    mask = np.ones((B, Tk), np.int32)
    if pad:
        mask[1::2, Tk - pad:] = 0
    return q, k, v, mask


def _bias_bh(mask, H):
    return torch.from_numpy(np.repeat(np.where(mask.astype(bool), 0.0, -1e9), H, axis=0)
                            .astype(np.float32))


def _jax(q, k, v, bias, causal):
    Tq = q.shape[1]
    return np.asarray(jax_flash(*(jnp.asarray(t.numpy()) for t in (q, k, v, bias)),
                                block_q=Tq, block_k=8, causal=causal, interpret=True))


@pytest.mark.parametrize("Tq,Tk,causal,pad", [(296, 296, False, 9), (272, 272, True, 7)])
def test_p_split_matches_pallas_kernel(Tq, Tk, causal, pad):
    """The long-caption encoder (296 with padded keys) and decoder (causal
    272) shapes, at two batch rows and two heads of 64."""
    H = 2
    q, k, v, mask = _inputs(0, 2, H, Tq, Tk, 64, pad)
    bias = _bias_bh(mask, H)
    want = _jax(q, k, v, bias, causal)
    got = _emulate(q, k, v, bias, causal).numpy()
    tol = FLASH_RTOL * max(1.0, float(v.abs().max()))
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)
    # the split is what carries p: bf16(p) alone is not within the bound
    hi_only = _emulate_hi_only(q, k, v, bias, causal)
    assert np.abs(hi_only - want).max() > tol


def _emulate_hi_only(q, k, v, bias, causal):
    """As ``_emulate`` with p_lo = 0: p rounded to bf16 once."""
    split = fa.p_split
    fa.p_split = lambda p: (split(p)[0], torch.zeros_like(p))
    try:
        return _emulate(q, k, v, bias, causal).numpy()
    finally:
        fa.p_split = split


def test_p_split_is_within_2_to_the_minus_16():
    p = torch.from_numpy(np.random.default_rng(1).random(100_000).astype(np.float32))
    hi, lo = fa.p_split(p)
    assert hi.dtype == lo.dtype == torch.float32
    assert torch.equal(hi, hi.to(torch.bfloat16).float())
    assert torch.equal(lo, lo.to(torch.bfloat16).float())
    assert float(((hi + lo - p).abs() / p).max()) <= 2.0 ** -16


def test_keys_read():
    """A causal query tile stops at its diagonal tile only where key 0 is
    kept; otherwise, and without causality, every key is read."""
    assert keys_read(True, 0, 272, True) == 64
    assert keys_read(True, 192, 272, True) == 256
    assert keys_read(True, 256, 272, True) == 272     # the ragged last tile
    assert keys_read(False, 0, 272, True) == 272      # key 0 masked
    assert keys_read(True, 0, 296, False) == 296


def test_causal_skip_gives_the_same_bits_only_where_key_0_is_kept():
    """Batch row 0 keeps key 0: skipping the tiles above the diagonal gives
    the bits of reading every tile. Batch row 1 masks key 0, so query 0 has
    no finite score and averages over all keys: there the rule reads every
    tile and matches the JAX kernel, and a skip would not."""
    H, T = 2, 200
    q, k, v, mask = _inputs(2, 2, H, T, T, 64, 0)
    mask[1, 0] = 0
    bias = _bias_bh(mask, H)
    skipped = _emulate(q, k, v, bias, True)
    full = _emulate(q, k, v, bias, True, skip=False)
    assert torch.equal(skipped[:H], full[:H])
    want = _jax(q, k, v, bias, True)
    tol = FLASH_RTOL * max(1.0, float(v.abs().max()))
    np.testing.assert_allclose(skipped.numpy(), want, rtol=0, atol=tol)
    # what a skip in batch row 1 would give at query 0: the mean of its
    # first tile's v rows, not of all T
    first_tile = v[H:, :TILE_K].mean(dim=1)
    assert np.allclose(want[H:, 0], v[H:].mean(dim=1).numpy(), atol=tol)
    assert not np.allclose(want[H:, 0], first_tile.numpy(), atol=tol)
