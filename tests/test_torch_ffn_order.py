"""The order in which K2's inference route sums its second GEMM, on the CPU.

csrc/ffn.cu's inference forward walks F2's depth in INFERENCE_KPER-slice
parts at every row count and adds them in part order from 0, then b2, then
rounds once to bf16: in a running fp32 sum inside one block ("sum"), or
from the parts of a cluster's blocks, one or two a block ("cluster"). The
partials route (fused_ffn_partials) writes the same parts to an fp32
buffer and adds them in the same order in a third launch.

Two things are held here. The indexing: a mirror of how
csrc/wgmma_gemm.cuh's tile_at hands a cluster block its parts and of which
(rank, slot) cluster_reduce reads for each part, run over every plan
infer_plan can return (tied to the source by its constants and loop
bounds), must add each part of a tile once, in order, for every row of it.
The arithmetic: a torch emulation of each order (every part's dot products
taken in float64 from the bf16 operands and rounded once to fp32, so a
part's value depends on its row alone) gives the partials route's bits,
sits within the bf16 tolerance of the JAX package's Pallas kernel
(interpret mode) and XLA composite, and a row's bits do not depend on the
rows beside it. Neither runs the kernel: chip_smoke.py holds its real
summing order to the partials route on the card.
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kmbart_tpu.ops import layers as jl
from kmbart_tpu.ops.pallas_ffn import fused_ffn as jax_fused_ffn
from kmbart_tpu_torch.ops import ffn
from tests._torch_port import bf16_tol, to_jax, to_np, to_torch

# D 64, F 1024: two parts of INFERENCE_KPER 64-deep slices
D, F = 64, 1024
PART = ffn.INFERENCE_KPER * ffn.K_TILE
CUH = Path(ffn.__file__).resolve().parents[1] / "csrc" / "wgmma_gemm.cuh"
# the cluster slots an H100 80GB HBM3 reported (test_torch_ffn_plan.py)
H100_SLOTS = {1: 132, 2: 66, 3: 39, 4: 30, 5: 22, 6: 17, 7: 15, 8: 15}


def _inputs(n, seed=0, f=F):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, D)), rng.normal(size=(D, f)) * 0.1,
            rng.normal(size=(f,)) * 0.1, rng.normal(size=(f, D)) * 0.05,
            rng.normal(size=(D,)) * 0.1)


def _port_args(x, w1, b1, w2, b2):
    """The port's operands: bf16 x and weights as nn.Linear keeps them
    ([out, in]), fp32 biases."""
    bf = torch.bfloat16
    return (to_torch(x, bf), to_torch(w1.T, bf), to_torch(b1), to_torch(w2.T, bf),
            to_torch(b2))


def _h(x, w1, b1):
    """F1 as the kernels round it: h = bf16(gelu(bf16(x @ W1ᵀ + b1)))."""
    a = (x.double() @ w1.double().t()).float() + b1
    return ffn._gelu_f32(a.to(torch.bfloat16).float()).to(torch.bfloat16)


def _parts(h, w2):
    """F2's parts: fp32 [splits, N, D], part p over depth [p·PART, (p+1)·PART)."""
    return torch.stack([(h[:, p:p + PART].double() @ w2[:, p:p + PART].double().t()).float()
                        for p in range(0, h.shape[1], PART)])


# ---------------------------------------------------------------------------
# the kernel's indexing, mirrored from csrc/wgmma_gemm.cuh


def _cuh():
    return CUH.read_text()


def _cluster_reduce_body():
    src = _cuh()
    start = src.index("__device__ __forceinline__ void cluster_reduce(")
    return src[start:src.index("\n}\n", start)]


def _kernel_max_parts():
    """The parts cluster_reduce reads at most: its loops' bound."""
    return int(re.search(r"constexpr int MAX_CLUSTER = (\d+);", _cuh()).group(1))


def held_parts(g):
    """{(tile, rank): [part in slot 0, slot 1, ...]}: tile_at gives block t
    of a cluster grid rank t % (splits / ppc) of tile t // (splits / ppc) and
    the depth slices [rank·ppc·kper, min(ksteps, (rank + 1)·ppc·kper)); the
    main loop keeps a part in slot q every kper of them."""
    ppc = g.splits // g.cluster
    ksteps = -(-g.depth // ffn.K_TILE)
    held = {}
    for t in range(g.ctas):
        rank, mn = t % (g.splits // ppc), t // (g.splits // ppc)
        kb = rank * ppc * g.kper
        nk = min(ksteps, kb + ppc * g.kper) - kb
        held[(mn, rank)] = [(kb + q * g.kper) // g.kper for q in range(ppc) if q * g.kper < nk]
    return held


def reduce_reads(g, rank):
    """(rows of the tile, [(source rank, slot) in the order added]) of
    cluster_reduce on the block of ``rank``: band = ceil(TILE_ROWS / (S /
    ppc)) rows from rank·band; for r < MAX_CLUSTER while r < S, part r from
    rank r >> 1 slot r & 1 with two parts a block, else rank r slot 0."""
    s = g.splits
    ppc = s // g.cluster
    band = (g.tile_rows + s // ppc - 1) // (s // ppc)
    lo = rank * band
    rows = range(lo, max(lo, min(g.tile_rows, lo + band)))
    reads = [((r >> 1, r & 1) if ppc == 2 else (r, 0))
             for r in range(_kernel_max_parts()) if r < s]
    return rows, reads


def test_mirror_follows_the_kernel_source():
    """The mirror's constants and reads are the source's: MAX_CLUSTER is the
    plan's, both of cluster_reduce's loops over the parts stop there, part r
    comes from rank r >> 1 slot r & 1 (or rank r), the band is split over
    S / ppc ranks, and gemm_launch refuses a cluster tile of more parts."""
    assert _kernel_max_parts() == ffn.MAX_CLUSTER
    body = _cluster_reduce_body()
    assert body.count("for (int r = 0; r < MAX_CLUSTER; ++r)") == 2
    assert body.count("if (r < S)") == 2
    assert "map_to_rank(off + (r & 1) * L::PART_BYTES, r >> 1)" in body
    assert "map_to_rank(off, r)" in body
    assert "const int band = (L::TILE_ROWS + S / p.ppc - 1) / (S / p.ppc);" in body
    assert "p.splits > MAX_CLUSTER" in _cuh()
    assert "r.split = t % (p.splits / p.ppc);" in _cuh()
    assert "r.kb = r.split * p.ppc * p.kper;" in _cuh()


def _every_plan(f):
    """Every F2 plan infer_plan returns at width F: chosen at the main-path
    and edge row counts on 132 (H100 slots) and 114 SMs, and each mode
    forced."""
    for n in (1, 37, 320, 560, 3072, 4608):
        for sms, slots in ((132, H100_SLOTS), (114, None)):
            yield ffn.infer_plan(n, 768, f, sms, slots)[1]
            splits = -(-(-(-f // ffn.K_TILE)) // ffn.INFERENCE_KPER)
            for mode in ffn.f2_modes(splits, sms, slots):
                yield ffn.infer_plan(n, 768, f, sms, slots, mode=mode)[1]


@pytest.mark.parametrize("f", range(512, 8192 + 1, 512))
def test_cluster_reduce_adds_each_part_once_in_order(f):
    """For 1-16 parts: a cluster plan's every tile row is summed by one rank,
    from every part once, in order; more than MAX_CLUSTER parts never go to
    a cluster (the reduce would read the first MAX_CLUSTER alone)."""
    clusters = 0
    for g in _every_plan(f):
        assert g.splits == -(-f // PART)
        if g.mode == "sum":
            continue
        clusters += 1
        assert g.splits <= ffn.MAX_CLUSTER and g.splits % g.cluster == 0
        held = held_parts(g)
        for mn in range(g.row_tiles * g.col_tiles):
            # the cluster's blocks hold its parts once, in rank order
            assert [p for rank in range(g.cluster) for p in held[(mn, rank)]] == \
                list(range(g.splits))
            covered = []
            for rank in range(g.cluster):
                rows, reads = reduce_reads(g, rank)
                covered += list(rows)
                if rows:
                    assert [held[(mn, src)][slot] for src, slot in reads] == \
                        list(range(g.splits))
            assert covered == list(range(g.tile_rows))
    # F up to 4096 (eight parts) has cluster plans; wider F has none
    assert (clusters > 0) == (f <= ffn.MAX_CLUSTER * PART)


def test_mirror_catches_a_cluster_of_more_parts_than_the_reduce_reads():
    """The mirror is not vacuous: a plan of 16 parts on clusters of eight
    (two a block), which the plan refuses, would have its last eight parts
    dropped by the reduce."""
    _, g = ffn.infer_plan(320, 768, 4096, 132, H100_SLOTS, mode="cluster2@64x256")
    wide = g._replace(depth=8192, splits=16, cluster=8, ctas=g.row_tiles * g.col_tiles * 8)
    held = held_parts(wide)
    _, reads = reduce_reads(wide, 0)
    assert [held[(0, src)][slot] for src, slot in reads] == list(range(8))


# ---------------------------------------------------------------------------
# the arithmetic, in the kernel's indexing


def running_sum(x, w1, b1, w2, b2):
    """MODE_SUM: each part in a fresh accumulator added to a running sum."""
    parts = _parts(_h(x, w1, b1), w2)
    s = torch.zeros(parts.shape[1:])
    for part in parts:
        acc = torch.zeros_like(s) + part
        s = s + acc
    return (s + b2).to(torch.bfloat16)


def cluster_sum(x, w1, b1, w2, b2, g):
    """MODE_CLUSTER under plan ``g``: each block's parts held by slot
    (held_parts), each tile's rows summed by the ranks of reduce_reads from
    the parts they read, in their order, then b2, then bf16."""
    parts = _parts(_h(x, w1, b1), w2)
    held = held_parts(g)
    out = torch.full((x.shape[0], w2.shape[0]), float("nan"), dtype=torch.bfloat16)
    for mn in range(g.row_tiles * g.col_tiles):
        r0, c0 = mn // g.col_tiles * g.tile_rows, mn % g.col_tiles * g.tile_cols
        for rank in range(g.cluster):
            rows, reads = reduce_reads(g, rank)
            if not rows:
                continue
            rs = slice(r0 + rows.start, min(x.shape[0], r0 + rows.stop))
            cs = slice(c0, min(w2.shape[0], c0 + g.tile_cols))
            s = torch.zeros_like(parts[0][rs, cs])
            for src, slot in reads:
                s = s + parts[held[(mn, src)][slot]][rs, cs]
            out[rs, cs] = (s + b2[cs]).to(torch.bfloat16)
    return out


def partials_finalize(x, w1, b1, w2, b2):
    """The partials route: the fp32 [splits, N, D] buffer, then
    ffn_finalize's s = 0; s += part[p] in split order; bf16(s + b2)."""
    partial = _parts(_h(x, w1, b1), w2).reshape(-1, x.shape[0] * w2.shape[0])
    n = partial.shape[1]
    out = torch.empty(n, dtype=torch.bfloat16)
    s = torch.zeros(n)
    for p in range(partial.shape[0]):
        s += partial[p]
    out[:] = (s + b2.repeat(x.shape[0])).to(torch.bfloat16)
    return out.reshape(x.shape[0], -1)


def test_two_parts_at_these_widths():
    assert F // PART == 2
    _, second = ffn.infer_plan(256, D, F, 132)
    assert (second.splits, second.kper) == (2, ffn.INFERENCE_KPER)


@pytest.mark.parametrize("n", [1, 37, 320])
def test_on_chip_orders_equal_the_partials_route_bit_for_bit(n):
    args = _port_args(*_inputs(n, seed=n))
    want = partials_finalize(*args)
    gots = [running_sum(*args)]
    for mode in ffn.f2_modes(2, 132, H100_SLOTS):
        if mode != "sum":
            gots.append(cluster_sum(*args, ffn.infer_plan(n, D, F, 132, H100_SLOTS, mode)[1]))
    assert len(gots) == 4
    for got in gots:
        assert got.dtype == torch.bfloat16 and got.shape == (n, D)
        assert torch.equal(got, want)


@pytest.mark.parametrize("mode", list(ffn.CLUSTER_MODES))
def test_eight_part_clusters_equal_the_partials_route_bit_for_bit(mode):
    """F 4096: eight parts, clusters of eight (or four, two parts a block)."""
    args = _port_args(*_inputs(70, seed=11, f=4096))
    g = ffn.infer_plan(70, D, 4096, 132, H100_SLOTS, mode)[1]
    assert g.splits == 8 and g.cluster == 8 // ffn.CLUSTER_MODES[mode][0]
    assert torch.equal(cluster_sum(*args, g), partials_finalize(*args))


def test_running_sum_matches_jax_kernel_and_composite():
    # rows % 256: the Pallas kernel's row tile
    x, w1, b1, w2, b2 = _inputs(256)
    xj = to_jax(x, "bfloat16")
    kernel = jax_fused_ffn(xj, to_jax(w1), to_jax(b1), to_jax(w2), to_jax(b2),
                           interpret=True)
    bf = jnp.bfloat16
    composite = jl.dense(jl.gelu(jl.dense(xj, to_jax(w1), to_jax(b1), bf)),
                         to_jax(w2), to_jax(b2), bf)
    out = to_np(running_sum(*_port_args(x, w1, b1, w2, b2)))
    for ref in (to_np(kernel), to_np(composite)):
        # <= 2 bf16 ulps, as test_torch_kernels_ffn_vocab.py holds the kernel's
        # plain version: the TPU kernel's A-S erf and the composite's
        # bf16-step gelu each sit within 2 ulps of exact-erf gelu
        np.testing.assert_allclose(out, ref, rtol=0, atol=bf16_tol(ref))
    # and the port's plain version (one fp32 product over the whole depth)
    plain = ffn.fused_ffn_plain(*_port_args(x, w1, b1, w2, b2))
    np.testing.assert_allclose(out, to_np(plain), rtol=0, atol=bf16_tol(to_np(plain)))


def test_running_sum_is_row_count_invariant():
    x, w1, b1, w2, b2 = _port_args(*_inputs(320, seed=7))
    full = running_sum(x, w1, b1, w2, b2)
    for n in (1, 37):
        assert torch.equal(running_sum(x[:n], w1, b1, w2, b2), full[:n])
    # and at another place in the batch
    assert torch.equal(running_sum(x[37:74], w1, b1, w2, b2), full[37:74])


@pytest.mark.parametrize("n", [1, 37])
def test_partials_route_on_the_cpu_is_the_plain_version(n):
    args = _port_args(*_inputs(n, seed=3))
    assert torch.equal(ffn.fused_ffn_partials(*args), ffn.fused_ffn_plain(*args))
    assert torch.equal(ffn.fused_ffn(*args), ffn.fused_ffn_plain(*args))
