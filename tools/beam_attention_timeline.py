"""clock64 / %globaltimer timelines of K3 (beam-stationary decode attention)
on the card.

    python tools/beam_attention_timeline.py [--tree DIR] [--out DIR]

Copies ``DIR/kmbart_tpu_torch/csrc`` (default: this checkout's) into
``_exp/k3_timeline/`` (git-ignored), patches marks into the copy's
``beam_attention.cu``, builds it with the package's own build, and runs K3
once at each main-path shape with the marks armed after a warm-up call:
generation's decode step (B 64, K 5, T 32, D 768, 12 heads) at cache
positions 0, 15 and 31, a TP 2 rank's (6 heads of 64) at 31, and the
serving pool's ring mode (pool 112) with windows 1..32, all 32 and all 1.

Every block records its SM (``%smid``) and its start and end on the
card's global clock (ns), and its first thread records clock64 marks at
each phase. One JSON line a call: the grid (blocks, SMs used, the most blocks
an SM ran at once, the waves: blocks that started only after some block of
the grid had ended, the grid's span and the blocks' median duration) and,
for each phase of a block (the span between two marks), its median and
mean in cycles over the blocks. The marks are placed by text anchors; an
anchor that is not found is reported. Run it from the root of the tree it
imports, on a machine with the card; it needs ``nvcc``.
"""

import argparse
import ctypes
import json
import os
import shutil
import sys

import numpy as np

CAP = 48          # marks a block
BLOCKS = 4096     # blocks recorded

DECLS = f"""
#define KMB_TL_CAP {CAP}
#define KMB_TL_BLOCKS {BLOCKS}
static __device__ unsigned long long kmb_tl[KMB_TL_BLOCKS][KMB_TL_CAP][2];
static __device__ unsigned long long kmb_tl_grid[KMB_TL_BLOCKS][4];
static __device__ int kmb_tl_on;
__device__ __forceinline__ unsigned long long kmb_tl_gt() {{
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}}
__device__ __forceinline__ unsigned kmb_tl_smid() {{
  unsigned s;
  asm volatile("mov.u32 %0, %%smid;" : "=r"(s));
  return s;
}}
#define KMB_TL(code) do {{ if (tl_live && threadIdx.x == 0 && tl_n < KMB_TL_CAP) {{ \\
    kmb_tl[blockIdx.x][tl_n][0] = (code); \\
    kmb_tl[blockIdx.x][tl_n][1] = clock64(); ++tl_n; }} }} while (0)
#define KMB_TL_START unsigned tl_n = 0; \\
  const bool tl_live = kmb_tl_on && blockIdx.x < KMB_TL_BLOCKS; \\
  if (tl_live && threadIdx.x == 0) {{ kmb_tl_grid[blockIdx.x][0] = kmb_tl_smid(); \\
    kmb_tl_grid[blockIdx.x][1] = kmb_tl_gt(); }} \\
  KMB_TL(1);
#define KMB_TL_END do {{ KMB_TL(99); if (tl_live && threadIdx.x == 0) \\
    kmb_tl_grid[blockIdx.x][2] = kmb_tl_gt(); }} while (0)
"""

EXPORTS = """
KMB_EXPORT int kmb_k3_tl_arm(int on) {
  cudaError_t e = cudaSuccess;
  if (on) {
    void* p = nullptr;
    e = cudaGetSymbolAddress(&p, kmb_tl);
    if (e == cudaSuccess) e = cudaMemset(p, 0, sizeof(kmb_tl));
    if (e == cudaSuccess) e = cudaGetSymbolAddress(&p, kmb_tl_grid);
    if (e == cudaSuccess) e = cudaMemset(p, 0, sizeof(kmb_tl_grid));
  }
  if (e == cudaSuccess) e = cudaMemcpyToSymbol(kmb_tl_on, &on, sizeof(int));
  return e;
}
KMB_EXPORT int kmb_k3_tl_read(void* marks, void* grid) {
  cudaError_t e = cudaMemcpyFromSymbol(marks, kmb_tl, sizeof(kmb_tl));
  if (e == cudaSuccess) e = cudaMemcpyFromSymbol(grid, kmb_tl_grid, sizeof(kmb_tl_grid));
  return e;
}
"""

# Phase codes of the block's first thread: 1 start, 2 prologue done
# (ancestry, queries), 3 a chunk's data landed, 4 its own scores of the last
# chunk done, 5 every score written, 6 softmax done, 7 a chunk consumed, 99
# the output stored.
PHASES = {1: "start", 2: "prologue", 3: "data", 4: "own_scores", 5: "all_scores",
          6: "softmax", 7: "chunk_done", 99: "stored"}

# (file, anchor, replacement): the marks of the kernel (a block per
# (sample, head), chunks by cp.async behind block barriers)
PATCHES = [
    ("beam_attention.cu", '#include "common.cuh"\n', '#include "common.cuh"\n' + DECLS),
    # the block-per-head kernel
    ("beam_attention.cu",
     "  extern __shared__ __align__(16) unsigned char smem[];\n"
     "  const int b = blockIdx.x / H, h = blockIdx.x % H;\n",
     "  extern __shared__ __align__(16) unsigned char smem[];\n"
     "  KMB_TL_START\n  const int b = blockIdx.x / H, h = blockIdx.x % H;\n"),
    ("beam_attention.cu", "    acc_s[i] = 0.f;\n  }\n  __syncthreads();\n",
     "    acc_s[i] = 0.f;\n  }\n  __syncthreads();\n  KMB_TL(2);\n"),
    ("beam_attention.cu", "    else cp_async_wait<0>();\n    __syncthreads();\n",
     "    else cp_async_wait<0>();\n    __syncthreads();\n    KMB_TL(3);\n"),
    ("beam_attention.cu", "      if (load == nchunks - 1) {\n        __syncthreads();\n",
     "      if (load == nchunks - 1) {\n        KMB_TL(4);\n        __syncthreads();\n"
     "        KMB_TL(5);\n"),
    ("beam_attention.cu", "        }\n      }\n    } else {\n",
     "        }\n        KMB_TL(6);\n      }\n    } else {\n"),
    ("beam_attention.cu", "    __syncthreads();  // the buffer is read: it may take chunk load + 2\n",
     "    KMB_TL(7);\n    __syncthreads();  // the buffer is read: it may take chunk load + 2\n"),
    ("beam_attention.cu",
     "  for (int i = tid; i < K * hd; i += kThreads)\n"
     "    out[((size_t)b * K + i / hd) * D + (size_t)h * hd + i % hd] = acc_s[i];\n}\n",
     "  for (int i = tid; i < K * hd; i += kThreads)\n"
     "    out[((size_t)b * K + i / hd) * D + (size_t)h * hd + i % hd] = acc_s[i];\n"
     "  KMB_TL_END;\n}\n"),
]


def patch(src, dst):
    """The patched copy of csrc/ at dst; returns the anchors not found."""
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(src, dst)
    missing = []
    path = os.path.join(dst, "beam_attention.cu")
    with open(path) as f:
        text = f.read()
    for _, old, new in PATCHES:
        if old not in text:
            missing.append(old.strip()[:60])
            continue
        text = text.replace(old, new)
    with open(path, "w") as f:
        f.write(text + EXPORTS)
    return missing


def summarize(marks, grid, nblocks):
    """The grid's waves and each phase's cycles over the blocks."""
    g = grid[:nblocks].astype(np.float64)
    smid, t0, t1 = g[:, 0], g[:, 1], g[:, 2]
    ok = t1 > 0
    out = {"blocks": int(nblocks), "blocks_recorded": int(ok.sum())}
    if not ok.any():
        return out
    smid, t0, t1 = smid[ok], t0[ok], t1[ok]
    # the most blocks one SM ran at once: sweep each SM's intervals
    most = 0
    for s in np.unique(smid):
        ev = sorted([(a, 1) for a in t0[smid == s]] + [(b, -1) for b in t1[smid == s]],
                    key=lambda e: (e[0], e[1]))
        cur = 0
        for _, d in ev:
            cur += d
            most = max(most, cur)
    first_end = t1.min()
    late = int((t0 >= first_end).sum())
    out.update({"sms_used": int(len(np.unique(smid))), "most_blocks_on_an_sm": int(most),
                "blocks_starting_after_the_first_end": late,
                "grid_span_ns": float(t1.max() - t0.min()),
                "block_ns_median": float(np.median(t1 - t0)),
                "block_ns_max": float((t1 - t0).max()),
                "start_spread_ns": float(np.percentile(t0, 99) - t0.min())})
    phases = {}
    for blk in np.nonzero(ok)[0]:
        m = marks[blk]
        n = int(np.argmax(m[:, 0] == 0)) if (m[:, 0] == 0).any() else len(m)
        codes, clk = m[:n, 0].astype(np.int64), m[:n, 1].astype(np.float64)
        for i in range(1, n):
            key = f"{PHASES.get(int(codes[i - 1]), codes[i - 1])}>" \
                  f"{PHASES.get(int(codes[i]), codes[i])}"
            phases.setdefault(key, []).append(clk[i] - clk[i - 1])
        if n > 1:
            phases.setdefault("block_cycles", []).append(clk[n - 1] - clk[0])
    out["phases_cycles"] = {k: {"median": float(np.median(v)), "mean": float(np.mean(v)),
                                "count": len(v)} for k, v in sorted(phases.items())}
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", default=".")
    ap.add_argument("--out", default=os.path.join("_exp", "k3_timeline_out"))
    args = ap.parse_args()
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)
    import torch
    from kmbart_tpu_torch.ops import _cuda
    from kmbart_tpu_torch.ops import beam_attention as ba
    work = os.path.join(tree, "_exp", "k3_timeline")
    missing = patch(os.path.join(tree, "kmbart_tpu_torch", "csrc"), os.path.join(work, "csrc"))
    _cuda.CSRC_DIR = os.path.join(work, "csrc")
    _cuda.BUILD_DIR = os.path.join(work, "build")
    _cuda._SIGNATURES["kmb_k3_tl_arm"] = (ctypes.c_int, [ctypes.c_int])
    _cuda._SIGNATURES["kmb_k3_tl_read"] = (ctypes.c_int, [ctypes.c_void_p, ctypes.c_void_p])
    lib = _cuda.lib()
    print(json.dumps({"missing_anchors": missing}), flush=True)
    os.makedirs(args.out, exist_ok=True)

    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(0)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count

    def inputs(B, K, T, D, H):
        q = (torch.randn((B * K, D), generator=g, device=dev) * (D // H) ** -0.5).to(torch.bfloat16)
        kc = torch.randn((B, K, T, D), generator=g, device=dev).to(torch.bfloat16)
        vc = torch.randn((B, K, T, D), generator=g, device=dev).to(torch.bfloat16)
        anc = torch.randint(0, K, (B * K, T), generator=g, device=dev, dtype=torch.int32)
        return q, kc, vc, anc

    def record(name, B, K, T, D, H, ci, valid=None):
        q, kc, vc, anc = inputs(B, K, T, D, H)
        kw = dict(num_beams=K, num_heads=H)
        if valid is not None:
            kw["valid_counts"] = torch.as_tensor(valid, dtype=torch.int32, device=dev)
        call = lambda: ba.beam_gather_attention(q, kc, vc, anc, ci, **kw)  # noqa: E731
        call()
        torch.cuda.synchronize()
        _cuda.check(lib.kmb_k3_tl_arm(1), "arm")
        call()
        torch.cuda.synchronize()
        _cuda.check(lib.kmb_k3_tl_arm(0), "disarm")
        marks = np.zeros((BLOCKS, CAP, 2), np.uint64)
        grid = np.zeros((BLOCKS, 4), np.uint64)
        _cuda.check(lib.kmb_k3_tl_read(marks.ctypes.data, grid.ctypes.data), "read")
        np.savez_compressed(os.path.join(args.out, f"k3_{name}.npz"), marks=marks, grid=grid)
        row = {"call": name, "shape": [B, K, T, D, H], "cache_index": ci, "sms": sms}
        nblocks = int(np.count_nonzero(grid[:, 2]))
        row.update(summarize(marks, grid, max(nblocks, 1)))
        print(json.dumps(row), flush=True)

    spread = [1 + i % 32 for i in range(112)]
    for ci in (0, 15, 31):
        record(f"ci{ci}", 64, 5, 32, 768, 12, ci)
    record("tp2_ci31", 64, 5, 32, 384, 6, 31)
    record("ring_1_32", 112, 5, 32, 768, 12, 10, spread)
    record("ring_all_32", 112, 5, 32, 768, 12, 17, [32] * 112)
    record("ring_all_1", 112, 5, 32, 768, 12, 5, [1] * 112)


if __name__ == "__main__":
    main()
