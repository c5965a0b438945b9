"""K8 in one pass (kmbart_tpu_torch/csrc/lm_ce_bwd.cu) mirrored on the CPU.

The kernel walks the vocab in 32-deep slices for 64-row units across
768-column groups of D, in the parts of ops/lm_ce.py bwd_plan. Each slice's
logits become bf16 dlogits through kmb_wg::dlogit (0 past V), the first
column group's unit stores them by TMA into the [N, padded_vocab(V)] buffer
(the store clipped at N rows and the padded pitch), and each part's fp32
sum of dlogits @ W is written out and added in part order by finalize_sum
(or, with one part, rounded to bf16 directly). These tests hold that:
every dlogits element of the padded buffer is stored by exactly one unit,
the pad columns are zero, and a numpy mirror of the kernel's order and
formula gives the dlogits of lm_ce_bwd_plain and of the JAX package's
_bwd_call (in interpret mode) bit for bit (the same formula, each product
and difference rounded once in fp32), for a loss scale of either sign,
and their dh within 2 bf16 ulps of the reference's largest magnitude: the
fp32 sums run in other orders (a part's wgmma chain, the part order, the
plain version's single matmul, the Pallas kernel's vocab tiles), each dh
element rounded once to bf16.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kmbart_tpu.ops.pallas_lm_ce import _bwd_call, _fwd_project_stats_call
from kmbart_tpu_torch.ops import lm_ce
from tests._torch_port import to_jax, to_np, to_torch
from tests.test_torch_beam_plan import _bf16
from tests.test_torch_lm_ce_plan import bwd_parts, bwd_unit

ROWS, SLICE, GROUP = lm_ce.BWD_ROWS, lm_ce.BWD_SLICE, lm_ce.BWD_GROUP


def tol(ref, ulps=2):
    """``ulps`` bf16 ulps of the reference's largest magnitude: dh scales
    with 1 / (valid rows), far below 1."""
    return ulps * 2.0 ** (np.floor(np.log2(max(float(np.abs(ref).max()), 2.0 ** -126))) - 7)


def dlogit(logits, m, inv_se, scale, onehot):
    """kmb_wg::dlogit (K8's transform and K10's EPI_DLOGITS epilogue) on
    fp32 arrays: bf16(scale (exp(logit - m) inv_se - [the label's column]))
    with each product and difference rounded once in fp32."""
    e = np.exp((logits - m[:, None]).astype(np.float32)).astype(np.float32)
    p = (e * inv_se[:, None]).astype(np.float32)
    return _bf16((scale[:, None] * (p - onehot).astype(np.float32)).astype(np.float32))


def emulate_k8(logits, w, m, inv_se, scale, labels, plan):
    """K8 in the kernel's order: the padded dlogits buffer formed slice by
    slice (0 past V, pad columns included) and stored by the units of the
    first column group, and dh as each part's fp32 sum over its slices,
    the parts added in part order from 0, then rounded to bf16. Returns
    (the buffer, dh, how many times each buffer element was stored)."""
    N, V = logits.shape
    pitch = lm_ce.padded_vocab(V)
    ksteps = -(-V // SLICE)
    buf = np.full((N, pitch), np.nan, np.float32)
    stored = np.zeros((N, pitch), np.int64)
    sums = np.zeros((plan.splits, N, w.shape[1]), np.float32)
    parts = bwd_parts(plan)
    wpad = np.zeros((ksteps * SLICE, w.shape[1]), np.float32)
    wpad[:V] = w   # TMA zero-fills W's rows past V
    for t in range(plan.units):
        s, r, c = bwd_unit(t, plan)
        rows = slice(r * ROWS, min(N, (r + 1) * ROWS))
        acc = np.zeros((rows.stop - rows.start, w.shape[1]), np.float32)
        for k in range(*parts[s]):
            cols = np.arange(k * SLICE, (k + 1) * SLICE)
            live = cols < V
            tile = np.zeros((rows.stop - rows.start, SLICE), np.float32)
            onehot = (cols[None, :] == labels[rows, None]).astype(np.float32)
            tile[:, live] = dlogit(logits[rows][:, cols[live]], m[rows], inv_se[rows],
                                   scale[rows], onehot[:, live])
            if c == 0:   # the store, clipped at the padded pitch
                keep = cols < pitch
                buf[rows, cols[keep]] = tile[:, keep]
                stored[rows, cols[keep]] += 1
            acc = (acc + tile @ wpad[k * SLICE:(k + 1) * SLICE]).astype(np.float32)
        sums[s, rows] = acc
    total = np.zeros_like(sums[0])
    for s in range(plan.splits):
        total = (total + sums[s]).astype(np.float32)
    return buf, _bf16(total), stored


def _head(seed, N=24, V=1100, D=128):
    """A small ragged head (V 1100 = 34 x 32 + 12, pitch 1104) with labels
    in column 0, in column V - 1 and in the ragged last slice, its bf16
    logits (K7's rounding) and statistics from the JAX package's forward
    kernel in interpret mode, and rows whose scale is 0 (ignored labels)."""
    rng = np.random.default_rng(seed)
    h = rng.normal(size=(N, D)).astype(np.float32)
    w = (rng.normal(size=(V, D)) * 0.05).astype(np.float32)
    fbias = (rng.normal(size=(V,)) * 0.01).astype(np.float32)
    labels = rng.integers(0, V, N).astype(np.int32)
    labels[:3] = [0, V - 1, V - 5]
    lj, m_j, se_j, _ = _fwd_project_stats_call(
        to_jax(h, "bfloat16"), to_jax(w, "bfloat16"), jnp.asarray(fbias).reshape(1, -1),
        jnp.asarray(labels).reshape(-1, 1), 128, jnp.bfloat16, True)
    logits = to_np(lj)
    m = np.array(to_np(m_j)[:, 0])
    inv_se = (1.0 / to_np(se_j)[:, 0]).astype(np.float32)
    valid = np.ones(N, bool)
    valid[[1, 5, 6]] = False   # the label in column V - 1 among them
    scale = (valid / valid.sum()).astype(np.float32)
    return logits, _bf16(w), m, inv_se, scale, labels


@pytest.mark.parametrize("n,d,v", [(5120, 768, 50320), (9216, 768, 50320),
                                   (12288, 768, 50320), (24, 128, 1100), (4608, 1024, 50265)])
def test_every_dlogits_element_is_stored_once(n, d, v):
    """The store's coverage at the heads, the edge and a two-group head:
    the units of the first column group store each 32-column slice of
    their 64 rows, clipped at N and at the padded pitch, so every element
    of the [N, padded_vocab(V)] buffer (its pad columns too) is written
    exactly once, whatever the part count."""
    pitch = lm_ce.padded_vocab(v)
    ksteps = -(-v // SLICE)
    assert (ksteps - 1) * SLICE < pitch <= ksteps * SLICE   # the last slice reaches the pad
    for splits in (None, 1):
        g = lm_ce.bwd_plan(n, d, v, 132, splits)
        parts = bwd_parts(g)
        count = np.zeros((g.row_blocks, ksteps), np.int64)   # (row block, slice) stores
        for t in range(g.units):
            s, r, c = bwd_unit(t, g)
            if c == 0:
                count[r, parts[s][0]:parts[s][1]] += 1
        assert (count == 1).all()


def _references(logits, w, m, inv_se, scale, labels):
    """(dlogits, dh) of lm_ce_bwd_plain and of _bwd_call in interpret mode,
    as fp32 arrays."""
    N = logits.shape[0]
    bf = torch.bfloat16
    dl_p, dh_p = lm_ce.lm_ce_bwd_plain(
        to_torch(logits, bf), to_torch(w, bf), torch.from_numpy(m), torch.from_numpy(inv_se),
        torch.from_numpy(scale), torch.from_numpy(labels))
    col = lambda a: jnp.asarray(a).reshape(N, 1)  # noqa: E731
    dl_j, dh_j = _bwd_call(to_jax(logits, "bfloat16"), to_jax(w, "bfloat16"), col(m),
                           col(inv_se), col(scale), jnp.asarray(labels).reshape(-1, 1), 128,
                           True)
    return ((dl_p.float().numpy(), dh_p.float().numpy()), (to_np(dl_j), to_np(dh_j)))


@pytest.mark.parametrize("splits", [None, 1, 4])
def test_k8_emulation_matches_plain_and_pallas_kernel(splits):
    """The mirror at the edge (N 24, V 1100, D 128) in the plan's 35 parts
    of one slice, in one part, and in four: its dlogits equal
    lm_ce_bwd_plain's and _bwd_call's bit for bit and its dh is within 2
    bf16 ulps of theirs, its pad columns and ignored rows are zero, every
    element is stored once, and the part counts agree with each other
    within the same."""
    logits, w, m, inv_se, scale, labels = _head(21)
    N, V = logits.shape
    plan = lm_ce.bwd_plan(N, w.shape[1], V, 132, splits)
    assert plan.splits == {None: 35, 1: 1, 4: 4}[splits]
    buf, dh, stored = emulate_k8(logits, w, m, inv_se, scale, labels, plan)
    assert buf.shape == (N, 1104) and (stored == 1).all()
    assert not buf[:, V:].any()
    for ref_dl, ref_dh in _references(logits, w, m, inv_se, scale, labels):
        np.testing.assert_array_equal(buf[:, :V], ref_dl)
        np.testing.assert_allclose(dh, ref_dh, rtol=0, atol=tol(ref_dh))
    assert not buf[[1, 5, 6]].any() and buf[0, 0] < 0 and buf[2, V - 5] < 0
    _, dh_one, _ = emulate_k8(logits, w, m, inv_se, scale, labels,
                              lm_ce.bwd_plan(N, w.shape[1], V, 132, 1))
    np.testing.assert_allclose(dh, dh_one, rtol=0, atol=tol(dh_one))


def test_k8_emulation_with_a_negative_loss_scale():
    """A negative loss scale (the cotangent of -loss, or a negative weight
    on the LM loss): the mirror's dlogits are the references' bit for bit,
    the negated dlogits of the positive scale, and its dh is within 2 bf16
    ulps of theirs, finite everywhere."""
    logits, w, m, inv_se, scale, labels = _head(23)
    N, V = logits.shape
    plan = lm_ce.bwd_plan(N, w.shape[1], V, 132)
    neg = (-scale).astype(np.float32)
    buf, dh, _ = emulate_k8(logits, w, m, inv_se, neg, labels, plan)
    pos, _, _ = emulate_k8(logits, w, m, inv_se, scale, labels, plan)
    assert np.isfinite(buf).all() and np.isfinite(dh).all()
    np.testing.assert_array_equal(buf, -pos)
    assert buf[0, 0] > 0 and buf[0, 1] < 0
    for ref_dl, ref_dh in _references(logits, w, m, inv_se, neg, labels):
        np.testing.assert_array_equal(buf[:, :V], ref_dl)
        np.testing.assert_allclose(dh, ref_dh, rtol=0, atol=tol(ref_dh))


def test_k8_emulation_two_column_groups():
    """A head wider than one 768-column group (D 1024 over V 300, N 70:
    two row blocks, the second ragged): both groups form the same dlogits,
    only the first stores them, they are the plain version's bit for bit,
    and the mirror's dh is the plain version's within 2 bf16 ulps."""
    rng = np.random.default_rng(22)
    N, V, D = 70, 300, 1024
    logits = _bf16(rng.normal(size=(N, V)).astype(np.float32))
    w = _bf16((rng.normal(size=(V, D)) * 0.05).astype(np.float32))
    m = logits.max(axis=1)
    inv_se = (1.0 / np.exp(logits - m[:, None]).sum(axis=1)).astype(np.float32)
    scale = np.full(N, 1.0 / N, np.float32)
    labels = rng.integers(0, V, N).astype(np.int32)
    plan = lm_ce.bwd_plan(N, D, V, 132)
    assert (plan.row_blocks, plan.groups) == (2, 2)
    buf, dh, stored = emulate_k8(logits, w, m, inv_se, scale, labels, plan)
    assert (stored == 1).all() and not buf[:, V:].any()
    bf = torch.bfloat16
    dl_p, dh_p = lm_ce.lm_ce_bwd_plain(
        to_torch(logits, bf), to_torch(w, bf), torch.from_numpy(m), torch.from_numpy(inv_se),
        torch.from_numpy(scale), torch.from_numpy(labels))
    np.testing.assert_array_equal(buf[:, :V], dl_p.float().numpy())
    ref = dh_p.float().numpy()
    np.testing.assert_allclose(dh, ref, rtol=0, atol=tol(ref))
