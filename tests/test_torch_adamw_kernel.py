"""K12 (ops/adamw.py, csrc/adamw.cu) on the CPU.

Nothing here builds or runs the CUDA kernels. The tests hold the wrapper's
launch plan (the row/stride description of each tensor, the launches a
step, the table's bytes against the C struct), and run the whole kernel
path of ``training/adamw.py AdamW`` on CPU tensors against a mirror of the
three kernels that reads the tables it is handed (``_MirrorLib``, in numpy,
operation by operation as the kernels round): moments and step counts equal
and parameters equal to the plain per-tensor path bit for bit (the mirror
takes sqrt and pow from torch, as the card's kernel and plain path share
CUDA's). The plain path itself is held to the code it was before K12
(``_update_before``).
"""

import ctypes
import os
import re

import numpy as np
import pytest
import torch

from kmbart_tpu_torch.ops import LAUNCHES, _cuda, adamw, launch_counts, reset_launch_counts
from kmbart_tpu_torch.training.adamw import AdamW, AdamWState

T = adamw.TABLE


class CTable(ctypes.Structure):
    """csrc/adamw.cu ``AdamWTable``, field by field."""
    _fields_ = [("p", ctypes.c_void_p * T), ("g", ctypes.c_void_p * T),
                ("m", ctypes.c_void_p * T), ("v", ctypes.c_void_p * T),
                ("sp", ctypes.c_longlong * T), ("sg", ctypes.c_longlong * T),
                ("smv", ctypes.c_longlong * T), ("cols", ctypes.c_int * T),
                ("group", ctypes.c_int * T), ("block_end", ctypes.c_int * T)]


def _source():
    with open(os.path.join(_cuda.CSRC_DIR, "adamw.cu")) as f:
        return f.read()


def test_table_constants_and_fields_match_the_source():
    src = _source()
    assert int(re.search(r"kTensors = (\d+);", src).group(1)) == adamw.TABLE
    assert int(re.search(r"kChunk = (\d+);", src).group(1)) == adamw.CHUNK
    body = re.search(r"struct AdamWTable \{(.*?)\};", src, re.S).group(1)
    fields = re.findall(r"(\w+)\[kTensors\]", body)
    assert fields == [name for name, _ in CTable._fields_]
    assert ctypes.sizeof(CTable) == adamw.TABLE_BYTES
    assert re.search(r"sizeof\(AdamWTable\) == (\d+) \* kTensors", src).group(1) == \
        str(adamw.TABLE_BYTES // T)


# ---------------------------------------------------------------------------
# the launch plan
# ---------------------------------------------------------------------------

def _base(*shape):
    return torch.zeros(shape)


@pytest.mark.parametrize("make,want", [
    (lambda: _base(7, 5), (1, 35, [35])),
    (lambda: _base(5), (1, 5, [5])),
    (lambda: torch.zeros(()), (1, 1, [1])),
    (lambda: _base(1, 9), (1, 9, [9])),
    (lambda: _base(8, 6).narrow(0, 2, 3), (1, 18, [18])),          # dim 0: contiguous
    (lambda: _base(8, 6).narrow(1, 2, 3), (8, 3, [6])),
    (lambda: _base(4, 6, 5).narrow(1, 3, 3), (4, 15, [30])),
    (lambda: _base(4, 6, 5).narrow(2, 1, 2), (24, 2, [5])),
    (lambda: _base(4, 1, 6).narrow(2, 0, 3), (4, 3, [6])),       # size-1 dims ignored
    (lambda: _base(2, 6, 8)[:, :, :4][:, :3], None),              # two outer strides
    (lambda: _base(3, 4, 8)[:2, :, :4], (8, 4, [8])),
    (lambda: _base(4, 16)[:, ::2], (32, 1, [2])),
])
def test_rows_of_describes_contiguous_and_narrowed_tensors(make, want):
    t = make()
    if want is None:
        with pytest.raises(ValueError, match="one row stride"):
            adamw.rows_of(t)
        return
    rows, cols, strides = adamw.rows_of(t)
    assert (rows, cols, strides) == want
    # the description addresses exactly the tensor's elements
    base = t.storage_offset()
    idx = [base + r * strides[0] + c for r in range(rows) for c in range(cols)]
    flat = torch.arange(t.untyped_storage().nbytes() // 4, dtype=torch.float32)
    view = flat.as_strided(t.shape, t.stride(), base)
    assert torch.equal(view.reshape(-1), flat[idx])


def test_rows_of_shares_one_description_and_refuses_other_layouts():
    p = _base(12, 8).narrow(1, 4, 4)
    m = torch.zeros(12, 4)
    assert adamw.rows_of(p, m, m) == (12, 4, [8, 4, 4])
    with pytest.raises(ValueError, match="one row stride"):
        adamw.rows_of(_base(5, 7).t())
    with pytest.raises(ValueError, match="overlapping"):
        adamw.rows_of(_base(1, 5).expand(4, 5))
    with pytest.raises(ValueError, match="shapes differ"):
        adamw.rows_of(_base(2, 3), _base(3, 2))


@pytest.mark.parametrize("n,capacity,want", [
    (0, T, []), (1, T, [(0, 1)]), (T, T, [(0, T)]), (T + 1, T, [(0, T), (T, T + 1)]),
    (262, T, [(0, 262)]), (274, T, [(0, 274)]), (10, 4, [(0, 4), (4, 8), (8, 10)])])
def test_launch_slices_cut_tensors_under_the_table(n, capacity, want):
    assert adamw.launch_slices(n, capacity) == want


def test_blocks_and_table_bytes():
    assert adamw.blocks_of(1, 1) == 1
    assert adamw.blocks_of(1, adamw.CHUNK) == 1
    assert adamw.blocks_of(1, adamw.CHUNK + 1) == 2
    assert adamw.blocks_of(3072, 384) == 3072
    entries = [(16 * (i + 1), 32 * (i + 1), 48 * (i + 1), 5 + i, 7, 9, 11, i % 3, 2 + i)
               for i in range(5)]
    table = adamw.Table(entries)
    table.set_grads(np.arange(1, 6, dtype=np.uint64) * 64)
    c = CTable.from_address(table.address)
    assert table.count == 5 and table.blocks == sum(2 + i for i in range(5))
    for i, e in enumerate(entries):
        assert (c.p[i], c.g[i], c.m[i], c.v[i]) == (e[0], 64 * (i + 1), e[1], e[2])
        assert (c.sp[i], c.sg[i], c.smv[i], c.cols[i], c.group[i]) == (7, 9, 11, 5 + i, i % 3)
        assert c.block_end[i] == sum(2 + j for j in range(i + 1))
    assert c.p[5] is None and c.cols[5] == 0
    with pytest.raises(ValueError):
        adamw.Table([])
    with pytest.raises(ValueError):
        adamw.Table(entries * (T // 5 + 1))


def test_launch_counter_listed_and_idle_after_a_cpu_update():
    assert "adamw" in LAUNCHES
    reset_launch_counts()
    opt = AdamW(lr=1e-2)
    params = {"w": torch.ones(3, 4)}
    opt.update({"w": torch.full((3, 4), 0.5)}, opt.init(params), params)
    assert launch_counts()["adamw"] == 0


# ---------------------------------------------------------------------------
# the plain path: bit for bit the code it was before K12
# ---------------------------------------------------------------------------

@torch.no_grad()
def _update_before(self, grads, state, params, lr=None, ok=None, part=None, any_over=None):
    """``AdamW.update`` as it was before K12 (the plain path, verbatim)."""
    lr = self.lr if lr is None else lr
    b1, b2, eps = self.b1, self.b2, self.eps
    step = state.step + (1 if ok is None else ok.to(torch.int32))
    per_leaf = self.skip_unused and state.leaf_steps is not None
    mu, nu = dict(state.mu), dict(state.nu)
    leaf_steps = None if state.leaf_steps is None else dict(state.leaf_steps)
    groups = self.groups_for(params)
    grads_of = {key: [torch.zeros_like(params[n], dtype=torch.float32) if grads.get(n) is None
                      else grads[n].float() for n in names] for key, names in groups.items()}
    if per_leaf:
        flags = torch.stack([torch.stack([(g != 0).any() for g in gs]).any()
                             for gs in grads_of.values()])
        if any_over is not None:
            flags = any_over(flags)
        used_of = dict(zip(groups, flags))
    for key, names in groups.items():
        gs = grads_of[key]
        if per_leaf:
            used = used_of[key]
            if ok is not None:
                used = used & ok
            leaf_steps[key] = state.leaf_steps[key] + used.to(torch.int32)
            t = leaf_steps[key].float()
        else:
            used = ok
            t = step.float()
        if self.correct_bias:
            t = t.clamp(min=1.0)
            step_size = lr * torch.sqrt(1.0 - b2 ** t) / (1.0 - b1 ** t)
        else:
            step_size = lr
        for name, g in zip(names, gs):
            p = params[name]
            if part is not None:
                p = part(name, p)
                if p is None:
                    continue
                g = part(name, g)
            m, v = state.mu[name], state.nu[name]
            new_m = b1 * m + (1.0 - b1) * g
            new_v = b2 * v + (1.0 - b2) * torch.square(g)
            new_p = p - step_size * new_m / (torch.sqrt(new_v) + eps)
            if self.weight_decay > 0.0:
                new_p = new_p - lr * self.weight_decay * p
            if used is not None:
                new_p = torch.where(used, new_p, p)
                new_m = torch.where(used, new_m, m)
                new_v = torch.where(used, new_v, v)
            p.copy_(new_p)
            mu[name], nu[name] = new_m, new_v
    return AdamWState(step=step, mu=mu, nu=nu, leaf_steps=leaf_steps)


SHAPES = {"enc.0.w": (6, 10), "enc.1.w": (6, 10), "enc.0.b": (10,), "enc.1.b": (10,),
          "emb": (13, 10), "odd": (3, 7, 5), "bias": (1, 9)}
GROUPS = {"enc/w": ["enc.0.w", "enc.1.w"], "enc/b": ["enc.0.b", "enc.1.b"],
          "emb": ["emb"], "odd": ["odd"], "bias": ["bias"]}


def _params(seed=0, shapes=SHAPES):
    g = torch.Generator().manual_seed(seed)
    return {n: torch.randn(s, generator=g) for n, s in shapes.items()}


def _grads(step, shapes=SHAPES):
    """Step ``step``'s gradients: at 1 a group all zero, at 2 a None in a
    used group; "bias" never has one (a buffer)."""
    g = torch.Generator().manual_seed(100 + step)
    grads = {n: torch.randn(s, generator=g) * 1e-2 for n, s in shapes.items()}
    grads["bias"] = None
    if step == 1:
        grads["enc.0.b"] = torch.zeros(10)
        grads["enc.1.b"] = torch.zeros(10)
    if step == 2:
        grads["enc.1.w"] = None
    return grads


# the guard's values over five steps (None: no guard)
OKS = [True, True, None, False, True]


def _part(name, t):
    return t.narrow(1, 2, 5) if t.dim() > 1 and t.shape[1] >= 7 else t


@pytest.mark.parametrize("kw", [dict(), dict(weight_decay=0.01),
                                dict(weight_decay=0.01, correct_bias=False, skip_unused=False),
                                dict(groups=None)])
@pytest.mark.parametrize("part", [None, _part])
def test_plain_path_is_the_code_before(kw, part):
    kw = {"groups": GROUPS, **kw}
    opt = AdamW(lr=1e-2, **kw)
    a, b = _params(), _params()
    init = lambda ps: opt.init({n: t if part is None else part(n, t) for n, t in ps.items()})
    sa, sb = init(a), init(b)
    for i, ok in enumerate(OKS):
        okt = None if ok is None else torch.tensor(ok)
        sa = opt.update(_grads(i), sa, a, ok=okt, part=part)
        sb = _update_before(opt, _grads(i), sb, b, ok=okt, part=part)
    assert all(torch.equal(a[n], b[n]) for n in a)
    for field in ("mu", "nu"):
        x, y = getattr(sa, field), getattr(sb, field)
        assert all(torch.equal(x[n], y[n]) for n in y)
    assert torch.equal(sa.step, sb.step)
    assert (sa.leaf_steps is None) == (sb.leaf_steps is None)
    for k, v in (sb.leaf_steps or {}).items():
        assert torch.equal(sa.leaf_steps[k], v)


# ---------------------------------------------------------------------------
# the kernel path against a mirror of the kernels
# ---------------------------------------------------------------------------

def _floats(address, count, dtype=ctypes.c_float):
    return np.ctypeslib.as_array((dtype * count).from_address(address))


def _rows(address, rows, cols, stride):
    """[rows, cols] float32 numpy view of the memory at ``address``."""
    if rows == 0 or cols == 0:
        return np.zeros((rows, cols), np.float32)
    flat = _floats(address, (rows - 1) * stride + cols)
    return np.lib.stride_tricks.as_strided(flat, (rows, cols), (4 * stride, 4))


def _entries(c, count):
    """(index, rows) of the table's tensors, from its cumulative blocks."""
    start = 0
    for i in range(count):
        per_row = -(-c.cols[i] // adamw.CHUNK)
        yield i, (c.block_end[i] - start) // per_row if per_row else 0
        start = c.block_end[i]


# sqrt and pow as this CPU's torch computes them, standing for the card's
# __fsqrt_rn and powf, which the card's plain path shares (CUDA's sqrt is
# correctly rounded; torch's vectorised CPU sqrt is not always, and glibc's
# powf rounds some powers apart from torch's)
def _powf(base, exp):
    return np.float32(torch.pow(torch.tensor(base, dtype=torch.float32),
                                torch.tensor(exp, dtype=torch.float32)))


def _sqrtf(x):
    return torch.sqrt(torch.from_numpy(np.ascontiguousarray(x, np.float32))).numpy()


class _MirrorLib:
    """csrc/adamw.cu's three entry points in numpy, on CPU memory: each
    operation in fp32, rounded alone, in the kernels' order."""

    def __init__(self):
        self.calls = []

    def kmb_adamw_table_bytes(self):
        return adamw.TABLE_BYTES

    def kmb_adamw_used(self, table, count, blocks, flags, groups, clear, stream):
        self.calls.append("used")
        c = CTable.from_address(table)
        fl = _floats(flags, groups, ctypes.c_uint8)
        if clear:
            fl[:] = 0
        for i, rows in _entries(c, count):
            if c.g[i] and (_rows(c.g[i], rows, c.cols[i], c.sg[i]) != 0).any():
                fl[c.group[i]] = 1
        return 0

    def kmb_adamw_steps(self, steps, used, ok, gused, gstep, groups, per_leaf, correct_bias,
                        lr, b1, b2, stream):
        self.calls.append("steps")
        st = _floats(steps, 1 + groups, ctypes.c_int32)
        used = _floats(used, groups, ctypes.c_uint8)
        okv = int(_floats(ok, 1, ctypes.c_uint8)[0] != 0) if ok else 1
        gu, gs = _floats(gused, groups, ctypes.c_int32), _floats(gstep, groups)
        f = np.float32
        step = int(st[0]) + okv
        for i in range(groups):
            if per_leaf:
                u = int(used[i] != 0) & okv
                st[1 + i] += u
                t = int(st[1 + i])
            else:
                u, t = okv, step
            s = f(lr)
            if correct_bias:
                tf = max(f(t), f(1))
                s = (f(lr) * _sqrtf(f(1) - _powf(b2, tf))[0]) / (f(1) - _powf(b1, tf))
            gu[i], gs[i] = u, s
        st[0] = step
        return 0

    def kmb_adamw_update(self, table, count, blocks, gused, gstep, b1, c1, b2, c2, eps, wdlr,
                         decay, stream):
        self.calls.append("update")
        c = CTable.from_address(table)
        groups = max(c.group[i] for i in range(count)) + 1
        gu, gs = _floats(gused, groups, ctypes.c_int32), _floats(gstep, groups)
        f = np.float32
        b1, c1, b2, c2, eps, wdlr = map(f, (b1, c1, b2, c2, eps, wdlr))
        for i, rows in _entries(c, count):
            if not gu[c.group[i]]:
                continue
            cols = c.cols[i]
            p = _rows(c.p[i], rows, cols, c.sp[i])
            m = _rows(c.m[i], rows, cols, c.smv[i])
            v = _rows(c.v[i], rows, cols, c.smv[i])
            g = _rows(c.g[i], rows, cols, c.sg[i]) if c.g[i] else np.zeros_like(p)
            nm = b1 * m + c1 * g
            nv = b2 * v + c2 * (g * g)
            np_ = p - (gs[c.group[i]] * nm) / (_sqrtf(nv) + eps)
            if decay:
                np_ = np_ - wdlr * p
            p[...], m[...], v[...] = np_, nm, nv
        return 0


@pytest.fixture
def mirror(monkeypatch):
    lib = _MirrorLib()
    monkeypatch.setattr(_cuda, "lib", lambda: lib)
    monkeypatch.setattr(_cuda, "prepare", lambda device: (lib, None))
    monkeypatch.setattr(_cuda, "require_cuda", lambda name, *ts, contiguous=True: ts[0].device)
    return lib


def _run_both(opt, shapes, grads_of, oks, part=None, any_over=None):
    """Five steps of the kernel path (through the mirror) and of the plain
    path from one start; returns both (params, state)."""
    k, p = _params(shapes=shapes), _params(shapes=shapes)
    init = lambda ps: opt.init({n: t if part is None else part(n, t) for n, t in ps.items()})
    sk, sp = init(k), init(p)
    for i, ok in enumerate(oks):
        okt = None if ok is None else torch.tensor(ok)
        sk = opt._update_kernel(grads_of(i), sk, k, None, okt, part, any_over)
        sp = opt.update_plain(grads_of(i), sp, p, ok=okt, part=part, any_over=any_over)
    return (k, sk), (p, sp)


def _assert_same(kernel, plain):
    (k, sk), (p, sp) = kernel, plain
    for field in ("mu", "nu"):
        x, y = getattr(sk, field), getattr(sp, field)
        assert all(torch.equal(x[n], y[n]) for n in y), field
    assert int(sk.step) == int(sp.step)
    assert (sk.leaf_steps is None) == (sp.leaf_steps is None)
    assert {n: int(v) for n, v in (sk.leaf_steps or {}).items()} == \
        {n: int(v) for n, v in (sp.leaf_steps or {}).items()}
    assert all(torch.equal(k[n], p[n]) for n in p)


@pytest.mark.parametrize("kw", [dict(), dict(weight_decay=0.01),
                                dict(weight_decay=0.01, correct_bias=False, skip_unused=False),
                                dict(groups=None)])
@pytest.mark.parametrize("part", [None, _part])
def test_kernel_path_matches_the_plain_path(mirror, kw, part):
    kw = {"groups": GROUPS, **kw}
    opt = AdamW(lr=1e-2, **kw)
    reset_launch_counts()
    kernel, plain = _run_both(opt, SHAPES, _grads, OKS, part=part)
    _assert_same(kernel, plain)
    # three launches a step (used, steps, update), the moments in place
    assert launch_counts()["adamw"] == 3 * len(OKS)
    assert mirror.calls == ["used", "steps", "update"] * len(OKS)
    start = opt.init({n: t if part is None else part(n, t) for n, t in _params().items()})
    assert kernel[1].mu is not start.mu and kernel[1].mu.keys() == start.mu.keys()


def test_kernel_path_ors_the_flags_over_ranks(mirror):
    """``any_over`` gets the flags between the launches: here another rank
    saw a gradient in "enc/b" at the step where this one's are zero."""
    opt = AdamW(lr=1e-2, groups=GROUPS)
    seen = []

    def any_over(flags):
        seen.append(flags.clone())
        out = flags.clone()
        out[list(opt.groups_for(SHAPES)).index("enc/b")] = True
        return out
    kernel, plain = _run_both(opt, SHAPES, _grads, OKS, any_over=any_over)
    _assert_same(kernel, plain)
    assert len(seen) == 2 * len(OKS) and all(f.dtype == torch.bool for f in seen)
    assert int(kernel[1].leaf_steps["enc/b"]) == 4


def test_kernel_path_over_several_launches(mirror):
    """More tensors than a table holds: two launches of each kernel a step,
    groups spanning both, sizes past a block and off the vector width."""
    shapes = {f"t{i}": ((3, 5) if i % 3 else (adamw.CHUNK + 3,)) for i in range(T + 20)}
    groups = {f"g{j}": [f"t{i}" for i in range(j, T + 20, 7)] for j in range(7)}
    opt = AdamW(lr=1e-3, groups=groups)

    def grads_of(step):
        gen = torch.Generator().manual_seed(step)
        grads = {n: torch.randn(s, generator=gen) for n, s in shapes.items()}
        if step == 1:
            grads.update({n: torch.zeros(shapes[n]) for n in groups["g3"]})
        return grads
    reset_launch_counts()
    kernel, plain = _run_both(opt, shapes, grads_of, [True, True, False])
    _assert_same(kernel, plain)
    assert launch_counts()["adamw"] == 5 * 3
    assert mirror.calls[:5] == ["used", "used", "steps", "update", "update"]


def test_kernel_path_state_in_place_and_resumed(mirror):
    """The returned state's steps are views of one vector, advanced in
    place; a state from elsewhere (a resume) is copied in and goes on."""
    opt = AdamW(lr=1e-2, groups=GROUPS)
    params = _params()
    state = opt.init(params)
    s1 = opt._update_kernel(_grads(0), state, params, None, None, None, None)
    assert int(state.step) == 0 and all(int(v) == 0 for v in state.leaf_steps.values())
    assert s1.mu is state.mu and int(s1.step) == 1
    s2 = opt._update_kernel(_grads(1), s1, params, None, None, None, None)
    assert s2.step is s1.step and int(s1.step) == 2          # advanced in place
    assert int(s2.leaf_steps["enc/b"]) == 1 and int(s2.leaf_steps["emb"]) == 2
    # a resume: new moment dicts and step tensors, as checkpoint/io.py loads them
    resumed = AdamWState(step=torch.tensor(7, dtype=torch.int32),
                         mu={n: t.clone() for n, t in s2.mu.items()},
                         nu={n: t.clone() for n, t in s2.nu.items()},
                         leaf_steps={k: torch.tensor(int(v) + 5, dtype=torch.int32)
                                     for k, v in s2.leaf_steps.items()})
    plain_params = {n: t.clone() for n, t in params.items()}
    ref = opt.update_plain(_grads(3), resumed, plain_params)
    s3 = opt._update_kernel(_grads(3), resumed, params, None, None, None, None)
    assert int(resumed.step) == 7                              # copied in, not advanced
    assert int(s3.step) == int(ref.step) == 8
    assert {k: int(v) for k, v in s3.leaf_steps.items()} == \
        {k: int(v) for k, v in ref.leaf_steps.items()}
    assert all(torch.equal(s3.mu[n], ref.mu[n]) for n in ref.mu)


def test_kernel_path_refuses_other_layouts(mirror):
    opt = AdamW(lr=1e-2)
    params = {"w": torch.zeros(6, 4).t()}      # transposed: no row description
    with pytest.raises(ValueError, match="one row stride"):
        opt._update_kernel({"w": None}, opt.init({"w": torch.zeros(4, 6)}),
                           params, None, None, None, None)
    params = {"w": torch.zeros(4, 6)}
    with pytest.raises(ValueError, match="laid out unlike"):
        opt._update_kernel({"w": torch.ones(6, 4).t()}, opt.init(params), params,
                           None, None, None, None)
    with pytest.raises(TypeError, match="fp32"):
        opt._update_kernel({"w": torch.ones(4, 6, dtype=torch.bfloat16)}, opt.init(params),
                           params, None, None, None, None)


def test_kernel_path_resumes_from_a_checkpoint(mirror, tmp_path):
    """The moments checkpoint/io.py loads (kernels transposed back from the
    JAX layout) are row-major, so a resume goes through the kernel path and
    steps as the plain path does."""
    from kmbart_tpu_torch.checkpoint.io import (jax_leaf_groups, load_training_data,
                                                save_training_data)
    from kmbart_tpu_torch.config import tiny_config
    from kmbart_tpu_torch.models.conditional import init_conditional_model
    from kmbart_tpu_torch.training.state import model_tensors
    cfg = tiny_config()
    params = model_tensors(init_conditional_model(cfg, device="cpu"))
    opt = AdamW(lr=1e-2, groups=jax_leaf_groups(cfg))
    gen = torch.Generator().manual_seed(0)

    def grads():
        return {n: torch.randn(t.shape, generator=gen) * 1e-2 for n, t in params.items()}
    state = opt.update_plain(grads(), opt.init(params), params)
    save_training_data(str(tmp_path), cfg, opt_state=state, epoch=0, step=1)
    loaded = load_training_data(str(tmp_path), cfg, device="cpu")["opt_state"]
    assert all(t.is_contiguous() for t in (*loaded.mu.values(), *loaded.nu.values()))
    g = grads()
    plain_params = {n: t.detach().clone() for n, t in params.items()}
    ref = opt.update_plain(g, loaded, plain_params)
    reset_launch_counts()
    got = opt._update_kernel(g, loaded, params, None, None, None, None)
    assert launch_counts()["adamw"] == 3
    assert all(torch.equal(params[n], plain_params[n]) for n in params)
    assert all(torch.equal(got.mu[n], ref.mu[n]) and torch.equal(got.nu[n], ref.nu[n])
               for n in ref.mu)
    assert int(got.step) == int(ref.step) == 2
