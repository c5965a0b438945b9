"""clock64 timelines of block 0 of the LM-CE kernels on the card.

    python tools/lm_ce_timeline.py [--tree DIR] [--out DIR] [--kernels k7,k9,k10]

Copies ``DIR/kmbart_tpu_torch/csrc`` (default: this checkout's) into
``_exp/timeline/`` (git-ignored), patches clock64 marks into the copy,
builds it with the package's own build, and runs K7 (``lm_ce_fwd``) at the
fine-tune head, N 5120, and at the pretraining head, N 9216, and K9
(``lm_ce_fwd_stats``) and K10 (``lm_ce_recompute_bwd``: its dlogits pass
and its dh pass) at N 9216 (V 50320, D 768), once each with the marks
armed after a warm-up call. Prints one JSON line a kernel: for each of block 0's
roles (the two consumer warpgroups' first threads, and the producer) the
share of its span spent waiting for data (the ring's full barriers), for
the other consumer (the ping-pong barrier), for free stages (the producer's
empty barriers), in main loops and in epilogues, with medians a tile or a
unit and a slice. Run it from the root of the tree it imports
(``--tree``'s Python modules are the ones on ``sys.path``), on a machine
with the card; it needs ``nvcc``.

The marks are placed by text anchors in the sources: an anchor that is not
found is reported and its marks are missing from the summary.
"""

import argparse
import ctypes
import json
import os
import shutil
import sys

import numpy as np

CAP = 16384   # marks a role
CODES = {"pp_wait": 10, "pp_done": 11, "full_wait": 12, "full_done": 13, "loop_done": 14,
         "epi_done": 15, "empty_wait": 16, "empty_done": 17, "issued": 18, "released": 19}

DECLS = f"""
#define KMB_TL_CAP {CAP}
static __device__ unsigned long long kmb_tl[3][2 * KMB_TL_CAP];
static __device__ int kmb_tl_on;
#define KMB_TL(code) do {{ if (tl_on && threadIdx.x % 128 == 0 && tl_n < KMB_TL_CAP) {{ \\
    kmb_tl[threadIdx.x / 128][2 * tl_n] = (code); \\
    kmb_tl[threadIdx.x / 128][2 * tl_n + 1] = clock64(); ++tl_n; }} }} while (0)
#define KMB_TL_DECL unsigned tl_n = 0; const bool tl_on = blockIdx.x == 0 && kmb_tl_on;
"""

EXPORTS = """
static unsigned long long kmb_tl_zero[3][2 * KMB_TL_CAP];
KMB_EXPORT int kmb_tl_arm_{s}(int on) {{
  cudaError_t e = cudaSuccess;
  if (on) e = cudaMemcpyToSymbol(kmb_tl, kmb_tl_zero, sizeof(kmb_tl_zero));
  if (e == cudaSuccess) e = cudaMemcpyToSymbol(kmb_tl_on, &on, sizeof(int));
  return e;
}}
KMB_EXPORT int kmb_tl_read_{s}(void* dst) {{
  return cudaMemcpyFromSymbol(dst, kmb_tl, sizeof(kmb_tl));
}}
"""

# (file, anchor, replacement): every occurrence of the anchor is replaced
PATCHES = [
    ("wgmma_gemm.cuh", "namespace kmb_wg {\n", DECLS + "namespace kmb_wg {\n"),
    ("wgmma_gemm.cuh", "  const int tiles = tile_count<L>(p);\n",
     "  const int tiles = tile_count<L>(p);\n  KMB_TL_DECL\n"),
    ("wgmma_gemm.cuh",
     "          mbar_wait(empty0 + 8 * stage, ((q / NST) & 1) ^ 1);  // round 0 finds it free\n",
     "          KMB_TL(16);\n"
     "          mbar_wait(empty0 + 8 * stage, ((q / NST) & 1) ^ 1);  // round 0 finds it free\n"
     "          KMB_TL(17);\n"),
    ("wgmma_gemm.cuh", "      if (!L::SHARED && i > 0) bar_sync(1 + cw, 256);\n",
     "      KMB_TL(10);\n      if (!L::SHARED && i > 0) bar_sync(1 + cw, 256);\n      KMB_TL(11);\n"),
    ("wgmma_gemm.cuh",
     "        mbar_wait(full0 + 8 * stage, (q / NST) & 1);\n"
     "        const uint32_t a_s = base + stage * L::STAGE_BYTES + a_share;",
     "        KMB_TL(12);\n        mbar_wait(full0 + 8 * stage, (q / NST) & 1);\n        KMB_TL(13);\n"
     "        const uint32_t a_s = base + stage * L::STAGE_BYTES + a_share;"),
    ("wgmma_gemm.cuh",
     "      if (lane0) mbar_arrive(empty0 + 8 * ((q - 1) % NST));\n#pragma unroll\n"
     "      for (int hf = 0; hf < L::H; ++hf) fence_acc(acc[hf]);\n",
     "      if (lane0) mbar_arrive(empty0 + 8 * ((q - 1) % NST));\n#pragma unroll\n"
     "      for (int hf = 0; hf < L::H; ++hf) fence_acc(acc[hf]);\n      KMB_TL(14);\n"),
    ("wgmma_gemm.cuh", "out_c, out_d, lone);\n      }\n    }\n",
     "out_c, out_d, lone);\n      }\n      KMB_TL(15);\n    }\n"),
    # K8's kernel; with the transform off, K10's second pass in trees older
    # than its own units (--tree)
    ("lm_ce_bwd.cu", "  const int units = unit_count(p);\n",
     "  const int units = unit_count(p);\n  KMB_TL_DECL\n"),
    ("lm_ce_bwd.cu",
     "while (cur.t < units) produce(cur, units, p, base, full0, empty0, map_a, map_w);",
     "while (cur.t < units) { KMB_TL(16); produce(cur, units, p, base, full0, empty0, map_a, "
     "map_w); KMB_TL(17); }"),
    ("lm_ce_bwd.cu", "        wg::mbar_wait(in0 + 8 * stage, (q / NST) & 1);\n",
     "        KMB_TL(12);\n        wg::mbar_wait(in0 + 8 * stage, (q / NST) & 1);\n"
     "        KMB_TL(13);\n"),
    ("lm_ce_bwd.cu", "        wg::mbar_wait(full0 + 8 * stage, (q / NST) & 1);\n",
     "        KMB_TL(12);\n        wg::mbar_wait(full0 + 8 * stage, (q / NST) & 1);\n"
     "        KMB_TL(13);\n"),
    ("lm_ce_bwd.cu",
     "        asm volatile(\"wgmma.commit_group.sync.aligned;\\n\" ::: \"memory\");\n",
     "        asm volatile(\"wgmma.commit_group.sync.aligned;\\n\" ::: \"memory\");\n"
     "        KMB_TL(18);\n"),
    ("lm_ce_bwd.cu",
     "          if (it > 0 && lane0) wg::mbar_arrive(empty0 + 8 * ((q - 1) % NST));\n",
     "          if (it > 0 && lane0) wg::mbar_arrive(empty0 + 8 * ((q - 1) % NST));\n"
     "          KMB_TL(19);\n"),
    # K10's second pass on its own units (dh_tiles)
    ("lm_ce_bwd.cu", "  const int units = unit_count<DH_ROWS, DH_COLS>(p);\n",
     "  const int units = unit_count<DH_ROWS, DH_COLS>(p);\n  KMB_TL_DECL\n"),
    ("lm_ce_bwd.cu",
     "          wg::mbar_wait(empty0 + 8 * stage, ((q / DH_NST) & 1) ^ 1);  // round 0 finds it free\n",
     "          KMB_TL(16);\n"
     "          wg::mbar_wait(empty0 + 8 * stage, ((q / DH_NST) & 1) ^ 1);  // round 0 finds it free\n"
     "          KMB_TL(17);\n"),
    ("lm_ce_bwd.cu", "        wg::mbar_wait(full0 + 8 * stage, (q / DH_NST) & 1);\n",
     "        KMB_TL(12);\n        wg::mbar_wait(full0 + 8 * stage, (q / DH_NST) & 1);\n"
     "        KMB_TL(13);\n"),
    ("lm_ce_bwd.cu", "        if (lane0) wg::mbar_arrive(empty0 + 8 * stage);\n",
     "        if (lane0) wg::mbar_arrive(empty0 + 8 * stage);\n        KMB_TL(19);\n"),
    ("lm_ce_bwd.cu", "      wg::fence_acc(acc[0]);\n      wg::fence_acc(acc[1]);\n",
     "      wg::fence_acc(acc[0]);\n      wg::fence_acc(acc[1]);\n      KMB_TL(14);\n"),
    ("lm_ce_bwd.cu", "__floats2bfloat162_rn(v0, v1);\n          }\n",
     "__floats2bfloat162_rn(v0, v1);\n          }\n      KMB_TL(15);\n"),
]


def patch(src, dst):
    """The patched copy of csrc/ at dst; returns the anchors not found."""
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(src, dst)
    missing = []
    for name, old, new in PATCHES:
        path = os.path.join(dst, name)
        with open(path) as f:
            text = f.read()
        if old not in text:
            missing.append(f"{name}: {old.strip()[:60]}")
            continue
        with open(path, "w") as f:
            f.write(text.replace(old, new))
    for name, s in (("lm_ce.cu", "f"), ("lm_ce_bwd.cu", "b")):
        with open(os.path.join(dst, name), "a") as f:
            f.write(EXPORTS.format(s=s))
    return missing


def marks(raw, slot):
    """(codes, clocks) of one role's marks, in order."""
    r = raw[slot].reshape(-1, 2)
    n = int(np.argmax(r[:, 0] == 0)) if (r[:, 0] == 0).any() else len(r)
    return r[:n, 0].astype(np.int64), r[:n, 1].astype(np.float64)


def spans(codes, clk, a, b):
    """The durations from each mark a to the next mark b."""
    out, start = [], None
    for c, t in zip(codes, clk):
        if c == a:
            start = t
        elif c == b and start is not None:
            out.append(t - start)
            start = None
    return np.asarray(out)


def med(x):
    return float(np.median(x)) if len(x) else None


def summarize(raw):
    """Each role's shares of its span and its medians, in cycles."""
    out = {}
    for slot, role in ((0, "consumer0"), (1, "consumer1"), (2, "producer")):
        codes, clk = marks(raw, slot)
        if not len(codes):
            continue
        span = clk[-1] - clk[0]
        r = {"marks": int(len(codes)), "span_cycles": span}
        for name, a, b in (("data", 12, 13), ("ping_pong", 10, 11), ("stage", 16, 17),
                           ("epilogue", 14, 15)):
            d = spans(codes, clk, a, b)
            if len(d):
                r[f"{name}_share"] = float(d.sum() / span)
                r[f"{name}_median"] = med(d)
                r[f"{name}_count"] = int(len(d))
        # main loops: from the ping-pong barrier (or a unit's first wait) to
        # the loop's end
        loop = spans(codes, clk, 11, 14) if (codes == 11).any() else np.asarray([])
        if len(loop):
            r["main_loop_median"] = med(loop)
            r["main_loop_share"] = float(loop.sum() / span)
        full = clk[codes == 13]
        if len(full) > 1:
            r["slice_period_median"] = med(np.diff(full))
        issue = spans(codes, clk, 13, 18)
        if len(issue):
            r["issue_median"] = med(issue)
        rel = spans(codes, clk, 18, 19)
        if len(rel):
            r["wait_previous_median"] = med(rel)
        # a tile's first slice against the others: data waits at tile starts
        first = []
        for i, c in enumerate(codes):
            if c == 11:
                j = next((k for k in range(i + 1, len(codes)) if codes[k] == 13), None)
                if j is not None and codes[j - 1] == 12:
                    first.append(clk[j] - clk[j - 1])
        if first:
            r["first_slice_data_median"] = med(np.asarray(first))
            r["first_slice_data_share"] = float(np.sum(first) / span)
        out[role] = r
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", default=".")
    ap.add_argument("--out", default=os.path.join("_exp", "timeline_out"))
    ap.add_argument("--kernels", default="k7,k9,k10",
                    help="which of k7 (at N 5120 and 9216), k9 and k10 to run")
    args = ap.parse_args()
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)
    import torch
    from kmbart_tpu_torch.ops import _cuda, lm_ce
    work = os.path.join(tree, "_exp", "timeline")
    missing = patch(os.path.join(tree, "kmbart_tpu_torch", "csrc"), os.path.join(work, "csrc"))
    _cuda.CSRC_DIR = os.path.join(work, "csrc")
    _cuda.BUILD_DIR = os.path.join(work, "build")
    for s in ("f", "b"):
        _cuda._SIGNATURES[f"kmb_tl_arm_{s}"] = (ctypes.c_int, [ctypes.c_int])
        _cuda._SIGNATURES[f"kmb_tl_read_{s}"] = (ctypes.c_int, [ctypes.c_void_p])
    lib = _cuda.lib()
    print(json.dumps({"missing_anchors": missing}), flush=True)

    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(0)
    V, D = 50320, 768
    w = (torch.randn((V, D), generator=g, device=dev) * 0.02).to(torch.bfloat16)
    fbias = torch.randn((V,), generator=g, device=dev) * 0.02

    def rows(N):
        h = torch.randn((N, D), generator=g, device=dev).to(torch.bfloat16)
        labels = torch.randint(0, V, (N,), generator=g, device=dev, dtype=torch.int32)
        valid = torch.rand((N,), generator=g, device=dev) > 0.1
        return h, labels, (valid.float() / valid.sum()).contiguous()

    def record(name, N, fn, tus):
        fn()
        torch.cuda.synchronize()
        for s in tus:
            _cuda.check(getattr(lib, f"kmb_tl_arm_{s}")(1), "arm")
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        row = {"kernel": name, "shape": [N, V, D], "ms_marked": start.elapsed_time(end)}
        for s in tus:
            _cuda.check(getattr(lib, f"kmb_tl_arm_{s}")(0), "disarm")
            raw = np.zeros((3, 2 * CAP), np.uint64)
            _cuda.check(getattr(lib, f"kmb_tl_read_{s}")(raw.ctypes.data), "read")
            np.save(os.path.join(args.out, f"timeline_{name}_{N}_{s}.npy"), raw)
            row[{"f": "projection", "b": "dh_pass"}[s]] = summarize(raw)
        print(json.dumps(row), flush=True)

    os.makedirs(args.out, exist_ok=True)
    which = set(args.kernels.split(","))
    if "k7" in which:
        for N in (5120, 9216):
            h, labels, _ = rows(N)
            record("k7", N, lambda: lm_ce.lm_ce_fwd(h, w, fbias, labels), ("f",))
    h, labels, scale = rows(9216)
    if "k9" in which:
        record("k9", 9216, lambda: lm_ce.lm_ce_fwd_stats(h, w, fbias, labels), ("f",))
    if "k10" in which:
        m, se, _ = lm_ce.lm_ce_fwd_stats(h, w, fbias, labels)
        inv_se = (1.0 / se).contiguous()
        record("k10", 9216, lambda: lm_ce.lm_ce_recompute_bwd(h, w, fbias, m, inv_se, scale,
                                                             labels), ("f", "b"))

if __name__ == "__main__":
    main()
