"""K4's selection against the JAX package's exact top-k family.

The port's top-k has one order: values descending, equal values lowest
index first, -0.0 equal to +0.0 (``ops/topk.py top_k``, a stable sort). On
the card K4's two stages compute it (``csrc/vocab_stats.cu``), which cannot
run here. These tests hold the JAX package's ``topk_from_chunk_stats``,
``radix_top_k`` and ``exact_top_k`` to that plain version on tie-heavy rows,
pin the kernel's algorithm with an emulation of its two stages in PyTorch
(64-bit keys, radix select over 8-bit digits with its early stop, the
merge), and check the route of ``exact_top_k`` and ``stats_top_k``: the
kernel for every k it takes, the sort for any other.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kmbart_tpu.ops import topk as jax_topk
from kmbart_tpu.ops.pallas_vocab_stats import chunk_stats_reference
from kmbart_tpu_torch.ops import topk, vocab_stats as vs

CHUNK = topk.CHUNK
SHAPES = {"vocab": 50320, "flat": 5 * 50320, "ragged": 3000}


def tie_rows(n, seed=0):
    """Eight [n] rows from a numpy seed, each a hard case for the tie order."""
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(8, n)) * 4).astype(np.float32)
    x[0, [n - 1, 123, n // 2, 1023, 1024]] = 9.0     # planted ties, across and at chunk borders
    x[1, :] = 1.25                                    # a constant row
    x[2, ::7] = -np.inf                               # -inf stripes
    x[2, [5, 6, 8, 1022, 1025]] = 7.5
    x[3, :] = -np.inf                                 # all -inf but one column (forced BOS/EOS)
    x[3, n // 3] = 0.5
    x[4] = np.round(x[4] * 2) / 2                     # halves: ties everywhere
    zeros = rng.choice(n, 40, replace=False)          # mixed +-0.0 on top of negatives
    x[5] = -np.abs(x[5]) - 1.0
    x[5, zeros] = np.where(rng.random(40) < 0.5, -0.0, 0.0)
    x[6, 1020:1028] = x[6].max() + 1.0                # one tied group straddling a border
    x[7] = np.round(x[7])                             # integers, fewer distinct values
    return x


CASES = [(name, k) for name in SHAPES for k in (2, 10)]
# Two differences inside the reference (ROADMAP.md section 3), pinned where
# they show: past a row's finite entries the greedy walks
# (topk_from_chunk_stats, _chunk_max_top_k) repeat index 0, where the sort
# goes on with the -inf columns in order; lax.top_k (and radix_top_k's
# final sort, which is lax.top_k) orders -0.0 below +0.0.
NEG_INF_TAIL_ROW = 3   # one finite column: a top-10 runs into -inf
SIGNED_ZERO_ROW = 5


@pytest.fixture(scope="module")
def rows():
    return {name: tie_rows(n, seed=i) for i, (name, n) in enumerate(SHAPES.items())}


def port_top_k(x, k):
    vals, idx = topk.top_k(torch.from_numpy(x), k)
    return vals.numpy(), idx.numpy()


def assert_same(got, want, rows_=slice(None)):
    """Values bit for bit (so -0.0 is not +0.0) and indices."""
    (gv, gi), (wv, wi) = got, want
    np.testing.assert_array_equal(np.asarray(gv)[rows_].view(np.uint32),
                                  np.asarray(wv)[rows_].view(np.uint32))
    np.testing.assert_array_equal(np.asarray(gi)[rows_], np.asarray(wi)[rows_])


def total_order(row, idx):
    """idx sorted as lax.top_k orders them: value descending, +0.0 before
    -0.0, then index."""
    return idx[np.lexsort((idx, np.signbit(row[idx]), -row[idx]))]


def check_against_port(got, x, k, walk=False, lax=False):
    """``got`` equals the port's top_k on every row, but where the
    reference differs: with ``walk``, past the -inf-tail row's finite entry
    the indices repeat 0 (values still bit-equal); with ``lax``, the
    signed-zero row lists the entries of lax.top_k's total order."""
    want = port_top_k(x, k)
    skip = {NEG_INF_TAIL_ROW} if walk else set()
    if lax:
        skip.add(SIGNED_ZERO_ROW)
    assert_same(got, want, [r for r in range(len(x)) if r not in skip])
    gv, gi = (np.asarray(a) for a in got)
    if walk:
        r = NEG_INF_TAIL_ROW
        np.testing.assert_array_equal(gv[r].view(np.uint32), want[0][r].view(np.uint32))
        n_fin = int(np.isfinite(want[0][r]).sum())
        np.testing.assert_array_equal(gi[r][:n_fin + 1], want[1][r][:n_fin + 1])
        assert (gi[r][n_fin:] == 0).all()
    if lax:
        r = SIGNED_ZERO_ROW
        np.testing.assert_array_equal(gv[r], want[0][r])   # as floats: -0.0 == +0.0
        np.testing.assert_array_equal(gi[r], total_order(x[r], np.arange(x.shape[1]))[:k])


# ---------------------------------------------------------------------------
# (a) the JAX package's functions against the port's plain top_k
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name,k", CASES)
def test_jax_chunk_walk_equals_port(rows, name, k):
    """The beam step's selection (topk_from_chunk_stats over the chunk
    maxima of the statistics' reference) equals the sort."""
    x = rows[name]
    xr = jax_topk.pad_to_chunks(jnp.asarray(x))
    cm = chunk_stats_reference(xr)[0]
    check_against_port(jax_topk.topk_from_chunk_stats(xr, cm, k), x, k, walk=True)


def jax_walks(n, k):
    """Whether the JAX package's exact_top_k takes its chunk-max walk (N >
    4096 k, its default threshold) rather than lax.top_k."""
    return n > jax_topk.exact_top_k.__kwdefaults__["iterative_threshold"] * k


@pytest.mark.parametrize("name,k", CASES)
def test_jax_exact_top_k_equals_port(rows, name, k):
    """exact_top_k equals the sort, by its chunk-max walk where N > 4096 k,
    else by lax.top_k."""
    x = rows[name]
    walk = jax_walks(x.shape[1], k)
    check_against_port(jax_topk.exact_top_k(jnp.asarray(x), k), x, k, walk=walk, lax=not walk)


@pytest.mark.parametrize("name,k", CASES)
def test_jax_radix_top_k_equals_port(rows, name, k):
    """Fast sampling's radix select equals the sort; on the signed-zero row
    it takes the sort's entries, in lax.top_k's order."""
    x = rows[name]
    xr = jax_topk.pad_to_chunks(jnp.asarray(x))
    got = jax_topk.radix_top_k(xr, k)
    keep = [r for r in range(len(x)) if r != SIGNED_ZERO_ROW]
    want = port_top_k(x, k)
    assert_same(got, want, keep)
    r = SIGNED_ZERO_ROW
    np.testing.assert_array_equal(np.asarray(got[1])[r], total_order(x[r], want[1][r]))


def test_lax_top_k_orders_negative_zero_below_positive_zero():
    """A difference inside the reference, recorded here: lax.top_k (and
    radix_top_k's final sort, which is lax.top_k) puts -0.0 below +0.0,
    while topk_from_chunk_stats and _chunk_max_top_k, the beam step's
    selections, tie them and go by index, as the port does."""
    x = np.full((1, 3000), -5.0, np.float32)
    x[0, [3, 10, 1030]] = -0.0
    x[0, [5, 7, 2000]] = 0.0
    xr = jax_topk.pad_to_chunks(jnp.asarray(x))
    want = port_top_k(x, 5)
    np.testing.assert_array_equal(want[1], [[3, 5, 7, 10, 1030]])
    assert_same(jax_topk.topk_from_chunk_stats(xr, chunk_stats_reference(xr)[0], 5), want)
    np.testing.assert_array_equal(np.asarray(jax.lax.top_k(jnp.asarray(x), 5)[1]),
                                  [[5, 7, 2000, 3, 10]])
    np.testing.assert_array_equal(np.asarray(jax_topk.radix_top_k(xr, 5)[1]),
                                  [[5, 7, 3, 10, 1030]])


# ---------------------------------------------------------------------------
# (b) the kernel's two stages, emulated in PyTorch
# ---------------------------------------------------------------------------

def kernel_keys(x):
    """The kernel's 64-bit keys, ordered_u32(v) << 32 | (0xFFFFFFFF - col)
    with -0.0 mapped to +0.0, held in int64 with the top bit flipped (so
    the signed order is the unsigned one)."""
    x = torch.where(x == 0, torch.zeros_like(x), x)
    u = x.view(torch.int32).long() & 0xFFFFFFFF
    ordered = torch.where(u >= 2 ** 31, ~u & 0xFFFFFFFF, u | 2 ** 31)
    col = torch.arange(x.shape[-1])
    return (ordered - 2 ** 31) * 2 ** 32 + (0xFFFFFFFF - col)


PAD_KEY = -2 ** 63   # unsigned key 0, below every real key


def digits(keys):
    """[..., 8] unsigned 8-bit digits of the keys, most significant first."""
    out = torch.stack([(keys >> s) & 0xFF for s in range(56, -8, -8)], dim=-1)
    out[..., 0] ^= 0x80
    return out


def select_threshold(keys, k, valid=None):
    """The kernel's select_threshold over groups of keys [G, n] (those
    where ``valid``; distinct but for PAD_KEY, at least k real ones a
    group): rounds of 8-bit digits,
    each picking the highest digit whose count from the top reaches the
    entries still wanted, until every key of the chosen bin is wanted.
    Returns (threshold keys [G], rounds [G])."""
    G = keys.shape[0]
    dig = digits(keys)
    match = torch.ones_like(keys, dtype=torch.bool) if valid is None else valid.clone()
    remaining = torch.full((G,), k)
    done = torch.zeros(G, dtype=torch.bool)
    chosen = torch.zeros((G, 8), dtype=torch.long)
    rounds = torch.zeros(G, dtype=torch.long)
    for r in range(8):
        live = ~done
        hist = torch.zeros((G, 256), dtype=torch.long).scatter_add_(
            1, dig[:, :, r], match.long())
        suffix = hist.flip(-1).cumsum(-1).flip(-1)
        d = (suffix >= remaining[:, None]).sum(-1) - 1
        above = torch.where(d < 255, suffix.gather(1, (d + 1).clamp(max=255)[:, None])[:, 0], 0)
        chosen[:, r] = torch.where(live, d, 0)
        rounds += live.long()
        remaining = torch.where(live, remaining - above, remaining)
        now_done = hist.gather(1, d[:, None])[:, 0] == remaining
        match &= (dig[:, :, r] == d[:, None]) | done[:, None]
        done |= live & now_done
        if bool(done.all()):
            break
    assert bool(done.all())
    top = chosen[:, 0] ^ 0x80
    thr = (top - 256 * (top >= 128)) * 2 ** 56
    for r in range(1, 8):
        thr = thr + chosen[:, r] * 2 ** (56 - 8 * r)
    return thr, rounds


def emulate_kernel(x, k):
    """Stage 1 a chunk of 1024 columns (its k largest keys, unsorted, PAD_KEY
    filling a chunk of at most k columns), stage 2 a row (the same select
    over the row's C*k candidates, the survivors ranked, the values read
    back from x). Returns (values, indices, stage-1 rounds)."""
    R, N = x.shape
    C = -(-N // CHUNK)
    keys = torch.nn.functional.pad(kernel_keys(x), (0, C * CHUNK - N), value=PAD_KEY)
    keys = keys.reshape(R * C, CHUNK)
    n_real = torch.clamp(N - torch.arange(C) * CHUNK, max=CHUNK).repeat(R)
    cand = torch.full((R * C, k), PAD_KEY)
    small = n_real <= k
    cand[small] = keys[small, :k]
    big = ~small
    real = torch.arange(CHUNK)[None, :] < n_real[big][:, None]   # the kernel's owned columns
    thr, rounds = select_threshold(keys[big], k, real)
    taken = real & (keys[big] >= thr[:, None])
    assert bool((taken.sum(-1) == k).all()), "stage 1: not exactly k survivors"
    cand[big] = keys[big][taken].reshape(-1, k)
    cand = cand.reshape(R, C * k)
    thr2, _ = select_threshold(cand, k)
    taken = cand >= thr2[:, None]
    assert bool((taken.sum(-1) == k).all()), "stage 2: not exactly k survivors"
    top = torch.sort(cand[taken].reshape(R, k), dim=-1, descending=True).values
    idx = 0xFFFFFFFF - (top & 0xFFFFFFFF)
    return torch.gather(x, 1, idx), idx, rounds


@pytest.mark.parametrize("name,k", CASES)
def test_kernel_emulation_equals_port(rows, name, k):
    x = torch.from_numpy(rows[name])
    vals, idx, rounds = emulate_kernel(x, k)
    assert_same((vals.numpy(), idx.numpy()), port_top_k(rows[name], k))
    assert int(rounds.max()) <= 8


def test_kernel_emulation_beam_step_shape():
    """Rows of the beam step's [320, 50320] at k 10 and sampling's k 50,
    random logits: the usual chunk stops within three rounds."""
    rng = np.random.default_rng(7)
    x = torch.from_numpy((rng.normal(size=(48, 50320)) * 4).astype(np.float32))
    for k in (10, 50):
        vals, idx, rounds = emulate_kernel(x, k)
        assert_same((vals.numpy(), idx.numpy()), port_top_k(x.numpy(), k))
        assert float(rounds.float().mean()) <= 3.0


@pytest.mark.parametrize("name", ["vocab", "ragged"])
def test_kernel_emulation_at_the_largest_k(rows, name):
    """k 1024, the kernel's largest: every chunk hands over all its columns
    (key 0 filling the ragged tail's), and the merge selects over them."""
    x = torch.from_numpy(rows[name][:4])
    vals, idx, _ = emulate_kernel(x, CHUNK)
    assert_same((vals.numpy(), idx.numpy()), port_top_k(rows[name][:4], CHUNK))


# ---------------------------------------------------------------------------
# (c) the route, (d) the statistics, and the wrappers on the CPU
# ---------------------------------------------------------------------------

# (n, k, whether the kernel takes it): wherever 1 <= k <= min(n, 1024),
# whatever n / k; the JAX function's N > 4096 k threshold weighs the TPU's
# k-step walk against its sort, and on the card the kernel is faster than
# the sort at every shape measured (PERF.md, row 6)
ROUTES = [(50320, 10, True), (50320, 50, True), (5 * 50320, 10, True), (40960, 10, True),
          (50320, 1024, True), (3000, 1024, True), (50320, 1025, False),
          (50320, 2000, False), (1000, 1001, False), (50320, 0, False)]


@pytest.mark.parametrize("n,k,kernel", ROUTES)
def test_route_takes_the_kernel_wherever_it_can(monkeypatch, n, k, kernel):
    """Off the CPU exact_top_k launches K4's selection with its statistics
    off, and stats_top_k with them on, for every k the kernel takes; any
    other k goes to the stable sort, and stats_top_k then takes the
    statistics from K4 at k 0."""
    calls = []

    def kernel_call(x, k, stats=True):
        calls.append((k, stats))
        R, C = x.shape[0], -(-x.shape[1] // CHUNK)
        m = lambda *shape, dtype=torch.float32: torch.empty(shape, dtype=dtype, device="meta")
        return m(R, C), m(R, C), m(R, k), m(R, k, dtype=torch.long)

    monkeypatch.setattr(vs, "chunk_stats_topk", kernel_call)
    x = torch.empty((2, n), device="meta")
    assert vs.kernel_takes(n, k) == kernel
    vals, idx = vs.exact_top_k(x, k)
    assert calls == ([(k, False)] if kernel else [])
    assert vals.shape == idx.shape == (2, min(n, k)) and idx.dtype == torch.long
    calls.clear()
    cm, es, vals, idx = vs.stats_top_k(x, k)
    assert calls == ([(k, True)] if kernel else [(0, True)])
    assert cm.shape == (2, -(-n // CHUNK)) and vals.shape == (2, min(n, k))


def test_exact_top_k_routes_by_shape_off_the_cpu():
    """Off the CPU a k the kernel takes goes to its launch path (which
    refuses a meta tensor) at any row width, a larger k to the sort."""
    m = lambda n: torch.empty((2, n), device="meta")
    for n in (50320, 40960):
        with pytest.raises(ValueError, match="no kernel"):
            vs.exact_top_k(m(n), 10)
    vals, idx = vs.exact_top_k(m(50320), 2000)
    assert vals.shape == (2, 2000) and idx.dtype == torch.long
    with pytest.raises(ValueError, match="no kernel"):
        vs.chunk_stats_topk(m(50320), 10)


@pytest.mark.parametrize("name", list(SHAPES))
def test_chunk_stats_topk_plain_keeps_the_statistics(monkeypatch, rows, name):
    """The plain version returns chunk_stats_plain's (cm, es) as they are
    (the objects themselves: two calls of the CPU exp-sum may differ in the
    last bit with the buffers' alignment) and the sort's top-k."""
    x = torch.from_numpy(rows[name])
    stats = vs.chunk_stats_plain(x)
    monkeypatch.setattr(vs, "chunk_stats_plain", lambda logits: stats)
    cm, es, vals, idx = vs.chunk_stats_topk_plain(x, 10)
    assert cm is stats[0] and es is stats[1]
    assert_same((vals.numpy(), idx.numpy()), port_top_k(rows[name], 10))
    none = vs.chunk_stats_topk_plain(x, 10, stats=False)
    assert none[0] is None and none[1] is None and torch.equal(none[3], idx)


def test_cpu_wrappers_are_the_plain_versions(monkeypatch, rows):
    x = torch.from_numpy(rows["vocab"])
    stats = vs.chunk_stats_plain(x)
    monkeypatch.setattr(vs, "chunk_stats_plain", lambda logits: stats)
    cm, es, vals, idx = vs.chunk_stats_topk(x, 10)
    assert cm is stats[0] and es is stats[1]
    assert_same((vals.numpy(), idx.numpy()), port_top_k(rows["vocab"], 10))
    cm0, es0 = vs.chunk_stats(x)
    assert cm0 is stats[0] and es0 is stats[1]
    assert vs.chunk_stats_topk(x, 0)[2].shape == (8, 0)
    want = port_top_k(rows["vocab"], 10)
    assert_same(tuple(t.numpy() for t in vs.exact_top_k(x, 10)), want)
    cm, es, vals, idx = vs.stats_top_k(x, 10)
    assert cm is stats[0] and es is stats[1]
    assert_same((vals.numpy(), idx.numpy()), want)
    cm, es, vals, idx = vs.stats_top_k(x, 2000)
    assert cm is stats[0] and es is stats[1]
    assert_same((vals.numpy(), idx.numpy()), port_top_k(rows["vocab"], 2000))
