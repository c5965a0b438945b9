"""K3's bf16 kernel (kmbart_tpu_torch/csrc/beam_attention.cu) emulated on the
CPU, and its shared-memory plan (kmbart_tpu_torch/ops/beam_attention.py
beam_plan).

The emulation repeats the kernel's arithmetic in numpy fp32, in the
kernel's order: a block per (sample, head); the positions in the plan's
chunks; only the slab rows some query beam descends through are staged
(the others are NaN here, so reading one would show); each score is eight
lanes' fp32 fma chains over 16-byte pieces of the bf16 q and k rows,
joined by a butterfly; p = bf16(e / l) after an fp32 softmax whose sum is
lane-strided and joined by a warp butterfly; P.V walks the positions in
order with fp32 fmas. It is the gather form: each beam reads its own
ancestor row, where the TPU kernel scores every (slot, position) pair and
masks all but the ancestors to -1e9.

Tolerances: against the JAX oracle (``beam_gather_attention_reference``)
and the port's plain version, both fp32 after the same bf16 roundings of q,
k, v and p, only the order of the fp32 sums and the last bit of exp
differ; a last-bit difference before p's bf16 rounding can move one p by
one bf16 ulp, so the outputs agree within 2 bf16 ulps of their largest
magnitude (``bf16_tol``), the tolerance chip_smoke.py holds the kernel to.
The Pallas kernel (interpret mode) rounds its output to bf16 as well
(pallas_beam_attention.py:200): the same 2 ulps.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kmbart_tpu.ops import pallas_beam_attention as jba
from kmbart_tpu_torch.ops import beam_attention as ba
from tests._torch_port import bf16_tol, to_jax, to_np, to_torch

GROUP = 8     # lanes per dot product (csrc/beam_attention.cu kGroup)


def _bf16(x):
    """Round fp32 to bf16 (nearest even), back in fp32."""
    return torch.from_numpy(np.array(x, np.float32)).to(torch.bfloat16).float().numpy()


def _butterfly(lanes):
    """The value every lane holds after xor-shuffle sums over the last axis
    (its length a power of two), in the kernel's order."""
    n = lanes.shape[-1]
    idx = np.arange(n)
    o = n // 2
    while o:
        lanes = (lanes + lanes[..., idx ^ o]).astype(np.float32)
        o //= 2
    return lanes[..., 0]


def emulate_k3(q, kc, vc, anc, cache_index, H):
    """K3's bf16 kernel on numpy inputs: q [B·K, D], caches [B, K, T, D]
    (any float dtype, rounded to bf16 as the kernel's loads are), ancestry
    [B·K, T]. Returns fp32 [B·K, D]."""
    B, K, T, D = kc.shape
    hd = D // H
    n = cache_index + 1
    plan = ba.beam_plan(K, cache_index, hd)
    anc = anc.reshape(B, K, T)[:, :, :n]
    qb = _bf16(q).reshape(B, K, H, hd)
    out = np.zeros((B, K, H, hd), np.float32)
    for b in range(B):
        # stage the slab: rows (j, t) no beam of the sample descends through
        # stay unread (NaN)
        used = np.zeros((K, n), bool)
        for qq in range(K):
            used[anc[b, qq], np.arange(n)] = True
        k_s = np.where(used[:, :, None, None], _bf16(kc[b, :, :n]).reshape(K, n, H, hd), np.nan)
        v_s = np.where(used[:, :, None, None], _bf16(vc[b, :, :n]).reshape(K, n, H, hd), np.nan)
        rows_k = k_s[anc[b], np.arange(n)[None, :]]          # [K(q), n, H, hd]
        rows_v = v_s[anc[b], np.arange(n)[None, :]]
        # scores: lane gl owns 16-byte pieces gl, gl + 8, ... of the head row
        lanes = np.zeros((K, n, H, GROUP), np.float32)
        for gl in range(GROUP):
            for c in range(gl, hd // 8, GROUP):
                for e in range(8):
                    d = 8 * c + e
                    prod = (qb[b, :, None, :, d] * rows_k[..., d]).astype(np.float32)
                    lanes[..., gl] = (lanes[..., gl] + prod).astype(np.float32)
        s = _butterfly(lanes)                                 # [K, n, H]
        # softmax over the positions, a warp per query beam
        m = s.max(axis=1, keepdims=True)
        e = np.exp((s - m).astype(np.float32)).astype(np.float32)
        warp = np.zeros((K, H, 32), np.float32)
        for t in range(n):
            warp[:, :, t % 32] = (warp[:, :, t % 32] + e[:, t]).astype(np.float32)
        l = _butterfly(warp)                                  # [K, H]
        p = _bf16((e / l[:, None, :]).astype(np.float32))
        # P.V over the chunks, positions in order
        acc = np.zeros((K, H, hd), np.float32)
        for c in range(plan.nchunks):
            for t in range(c * plan.chunk, min(n, (c + 1) * plan.chunk)):
                acc = (acc + (p[:, t, :, None] * rows_v[:, t]).astype(np.float32)) \
                    .astype(np.float32)
        out[b] = acc
    return out.reshape(B * K, D)


def _inputs(rng, B, K, T, H, hd, ancestry):
    D = H * hd
    q = (rng.normal(size=(B * K, D)) * hd ** -0.5).astype(np.float32)
    kc = rng.normal(size=(B, K, T, D)).astype(np.float32)
    vc = rng.normal(size=(B, K, T, D)).astype(np.float32)
    if ancestry == "branching":      # each live beam's history through random slots
        anc = rng.integers(0, K, size=(B * K, T))
    elif ancestry == "shared":       # every beam descends from one slot
        anc = np.full((B * K, T), K - 1)
    else:                            # "distinct": each beam keeps its own slot
        anc = np.tile(np.arange(K)[:, None], (B, T))
    return q, kc, vc, anc.astype(np.int32)


CASES = [  # (B, K, T, H, hd, cache_index, ancestry)
    (2, 5, 12, 4, 8, 11, "branching"),
    (2, 5, 12, 4, 8, 0, "branching"),
    (2, 5, 12, 4, 16, 6, "shared"),
    (2, 5, 12, 4, 16, 11, "distinct"),
    (2, 1, 10, 2, 32, 9, "branching"),
    (3, 4, 10, 2, 32, 7, "branching"),
    (1, 5, 40, 2, 128, 39, "branching"),   # three chunks of 15 positions at head_dim 128
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,K,T,H,hd,cache_index,ancestry", CASES)
def test_k3_emulation_matches_jax(B, K, T, H, hd, cache_index, ancestry, dtype):
    rng = np.random.default_rng(40 + cache_index + hd)
    q, kc, vc, anc = _inputs(rng, B, K, T, H, hd, ancestry)
    qj, kj, vj = (to_jax(a, dtype) for a in (q, kc, vc))
    rounded = [to_np(a) for a in (qj, kj, vj)]   # the inputs both sides see
    got = emulate_k3(*rounded, anc, cache_index, H)
    assert np.isfinite(got).all()                # no unstaged row was read

    sel = jba.build_selection_mask(jnp.asarray(anc), K, cache_index, H)
    oracle = to_np(jba.beam_gather_attention_reference(qj, kj, vj, sel, num_beams=K,
                                                       num_heads=H))
    np.testing.assert_allclose(got, oracle, rtol=0, atol=bf16_tol(oracle))
    pallas = to_np(jba.beam_gather_attention(qj, kj, vj, sel, num_beams=K, num_heads=H,
                                             interpret=True))
    np.testing.assert_allclose(got, pallas, rtol=0, atol=bf16_tol(pallas))
    td = getattr(torch, dtype)
    plain = ba.beam_gather_attention_plain(to_torch(q, td), to_torch(kc, td), to_torch(vc, td),
                                           torch.from_numpy(anc), cache_index, num_beams=K,
                                           num_heads=H)
    np.testing.assert_allclose(got, to_np(plain), rtol=0, atol=bf16_tol(to_np(plain)))


def test_k3_emulation_reads_only_ancestor_rows():
    """Rows no beam descends through, and positions past cache_index, never
    reach the output: poisoning them changes nothing."""
    rng = np.random.default_rng(7)
    B, K, T, H, hd, ci = 2, 4, 12, 2, 16, 8
    q, kc, vc, anc = _inputs(rng, B, K, T, H, hd, "branching")
    anc[:, :ci + 1] = anc[:, :ci + 1] % 2          # slots 2 and 3 unused up to ci
    base = emulate_k3(q, kc, vc, anc, ci, H)
    kc2, vc2 = kc.copy(), vc.copy()
    kc2[:, 2:, :ci + 1] = np.nan
    vc2[:, 2:, :ci + 1] = np.inf
    kc2[:, :, ci + 1:] = 1e3
    np.testing.assert_array_equal(emulate_k3(q, kc2, vc2, anc, ci, H), base)


@pytest.mark.parametrize("K,cache_index,hd,chunk,smem", [
    (5, 31, 64, 32, 45440),     # the main path's last step: the whole slab, one chunk
    (5, 0, 64, 1, 3280),
    (5, 15, 64, 16, 23680),
    (5, 31, 128, 15, 44800),    # head_dim 128: three chunks
    (1, 31, 64, 32, 9088),
    (4, 31, 32, 32, 19200),
])
def test_beam_plan(K, cache_index, hd, chunk, smem):
    plan = ba.beam_plan(K, cache_index, hd)
    n = cache_index + 1
    assert (plan.n, plan.chunk, plan.smem) == (n, chunk, smem)
    assert plan.smem == ba.beam_smem_bytes(K, n, hd, chunk)
    # the chunks cover the positions once, in order
    assert (plan.nchunks - 1) * plan.chunk < n <= plan.nchunks * plan.chunk
    assert plan.smem <= ba.SMEM_LIMIT
    if plan.chunk < n:
        assert plan.chunk == 8 or ba.beam_smem_bytes(K, n, hd, chunk + 1) > ba.SMEM_BUDGET


def test_beam_plan_main_path_occupancy():
    """At the main path's last step the whole slab is one chunk, and five
    blocks fit an SM's 228 KB of shared memory (1 KB reserved a block)."""
    plan = ba.beam_plan(5, 31, 64)
    assert 5 * (plan.smem + 1024) <= 228 * 1024
    assert plan.nchunks == 1


def test_beam_plan_long_cache_and_refusal():
    plan = ba.beam_plan(5, 999, 64)    # the ancestry and scores alone take 45 KB
    assert plan.chunk == 8 and plan.smem <= ba.SMEM_LIMIT
    assert plan.nchunks * plan.chunk >= plan.n
    with pytest.raises(ValueError, match="shared memory"):
        ba.beam_plan(64, 100_000, 64)
