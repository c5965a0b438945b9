// The persistent, warp-specialised wgmma + TMA GEMM main loop of K2, K2b
// (ffn.cu) and K7-K10's products (lm_ce.cu), shared by the files that
// instantiate it under their own kernel names (a profile tells them apart):
// C = A @ B with A [M, K] read K-major and B either K-major [Ncols, K] or
// MN-major [K, Ncols] (B_MN, through wgmma's transpose of 16-bit operands),
// bf16 operands, fp32 accumulation, and one of five epilogues: EPI_GELU and
// EPI_DGELU are K2's and K2b's (ffn.cu's source note), EPI_OUT rounds the
// sum (plus an optional fp32 bias) to bf16 (the second GEMMs of K2 and K2b,
// and the dh product of K8 and K10), EPI_STATS is K7's and K9's (the LM
// head's logits and a partial cross-entropy statistic per row of each
// 128-column tile) and EPI_DLOGITS is K10's first pass (the dlogits formed
// from the logits in registers; lm_ce.cu's source note).
//
// One block an SM, 384 threads. Warpgroup 2 is the producer: one thread
// issues the TMA copies (cp.async.bulk.tensor, 128-byte swizzle) into a ring
// of STAGES 64-deep K slices of A and B in shared memory, each stage with a
// full and an empty mbarrier. Warpgroups 0 and 1 are consumers that take
// turns ("ping-pong"): each owns every other 128 x 128 output tile of the
// block and computes it with wgmma.mma_async m64n128k16 (two 64-row halves,
// 128 accumulator registers a thread), so one warpgroup's epilogue overlaps
// the other's main loop. setmaxnreg moves registers from the producer to the
// consumers. Each consumer has a 32 KB tile buffer in TMA's swizzled layout;
// every bf16 result leaves by a TMA store. TMA zero-fills rows and columns
// past the edges of its maps and its stores clip them, so any M, any K and
// any Ncols % 8 run; a row pitch may exceed the row (make_map's ld), which
// lets A be a view of a wider buffer.
//
// The persistent tile order is columns fastest, then rows, then splits: the
// column tiles of one row block run together, so an A slice comes from L2
// for all but the first of them. A GEMM whose B is much larger than L2 and
// whose A is not (K7: W is 77 MB, h 8-14 MB) asks for rows fastest instead
// (ROWS_FIRST): the row tiles of one column block run together, so each B
// slice comes from HBM about once and A stays in L2. When the output tiles
// alone leave SMs idle the host's plan (ops/ffn.py gemm_plan) splits the K
// walk into fp32 partials that finalize_sum adds in split order; no
// atomics, so the result is deterministic.
#pragma once

#include <cuda.h>  // CUtensorMap and its enums; the encoder is fetched at run time

#include "common.cuh"

namespace kmb_wg {

typedef __nv_bfloat16 bf16;
constexpr int BM = 128;                       // tile rows: two 64-row wgmma halves
constexpr int BN = 128;                       // tile columns
constexpr int BK = 64;                        // K slice per stage: one 128-byte swizzle row
constexpr int STAGES = 5;
constexpr int A_BYTES = BM * BK * 2;          // 16 KB
constexpr int B_BYTES = BN * BK * 2;          // 16 KB
constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
constexpr int TILE_BYTES = BM * BN * 2;       // a consumer's bf16 tile buffer: two 64-column boxes
constexpr int BOX_BYTES = TILE_BYTES / 2;
constexpr int THREADS = 384;                  // two consumer warpgroups + the producer's
constexpr int NBARS = 2 * STAGES + 4;         // full, empty; aux_full, aux_empty per consumer
constexpr int SMEM_BYTES = STAGES * STAGE_BYTES + 2 * TILE_BYTES + 8 * NBARS + 1024;  // + align
// setmaxnreg moves registers inside a block: the producer warpgroup gives
// back what the consumers take, or their setmaxnreg.inc waits forever. At
// one block an SM ptxas gives these kernels 168 a thread (40 * 128 + 232 *
// 256 = 168 * 384); gemm() checks the count it finds before the first launch.
constexpr int PRODUCER_REGS = 40;
constexpr int CONSUMER_REGS = 232;

enum { EPI_GELU = 0, EPI_OUT = 1, EPI_DGELU = 2, EPI_STATS = 3, EPI_DLOGITS = 4 };

// Fields past store_d are zero in an aggregate initialiser that stops there.
struct GemmArgs {
  const float* bias;  // added to the sum before the epilogue's rounding, or null (not EPI_STATS)
  float* partial;     // EPI_OUT with a split K walk: fp32 [splits, M, Ncols], else null
  int M, Ncols;
  int ksteps;         // 64-deep K slices in all
  int kper, splits;   // the K walk in `splits` parts of kper slices (the last may be short)
  int store_d;        // EPI_GELU: also store a through the second output map
  int store_c;        // EPI_STATS: store the bf16 tile (0: the statistics alone, K9)
  const int* labels;  // EPI_STATS, EPI_DLOGITS: each row's label column, [M]
  float* stats;       // EPI_STATS: fp32 [3, M, ceil(Ncols / BN)]: max, exp-sum, label logit
  const float* row_m;       // EPI_DLOGITS: each row's logit max, [M]
  const float* row_inv_se;  // EPI_DLOGITS: 1 / each row's exp-sum, [M]
  const float* row_scale;   // EPI_DLOGITS: each row's loss scale (0: an ignored label), [M]
};

__device__ __forceinline__ float gelu_exact(float z) {
  return z * 0.5f * (1.f + erff(z * 0.70710678118654752f));
}

__device__ __forceinline__ float dgelu_exact(float z) {
  // d/dz [z Phi(z)] = Phi(z) + z phi(z)
  return 0.5f * (1.f + erff(z * 0.70710678118654752f)) +
         z * 0.39894228040143268f * expf(-0.5f * z * z);
}

// one element of the LM loss's dlogits, scale (exp(logit - m) inv_se - [the
// label's column]), from the bf16-rounded logit: K8's first launch and
// K10's EPI_DLOGITS both call it, and the _rn intrinsics keep the compiler
// from contracting either into an FMA, so the two agree bit for bit
__device__ __forceinline__ float dlogit(float logit, float m, float inv_se, float scale,
                                        bool label) {
  const float p = __fmul_rn(expf(logit - m), inv_se);
  return __fmul_rn(scale, __fsub_rn(p, label ? 1.f : 0.f));
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count));
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// returns once the barrier's phase differs from `parity`
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// one 2-D box of `map` at (c0 innermost, c1) into shared memory, completing on `bar`
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// one 2-D box from shared memory to `map` at (c0, c1); TMA clips the edges
__device__ __forceinline__ void tma_store(const CUtensorMap* map, uint32_t src, int c0, int c1) {
  asm volatile("cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], [%1];\n" ::
                   "l"(reinterpret_cast<uint64_t>(map)),
               "r"(src), "r"(c0), "r"(c1)
               : "memory");
}

__device__ __forceinline__ void tma_store_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// the committed stores have read their shared memory
__device__ __forceinline__ void tma_store_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

__device__ __forceinline__ void tma_store_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// makes this thread's shared-memory writes visible to TMA (the async proxy)
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// named barriers: 1 and 2 order the two consumers' main loops (256
// threads); 3 + cw holds consumer cw's own 128 threads
__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// wgmma shared-memory matrix descriptor, 128-byte swizzle. K-major tiles:
// rows of 128 bytes, 8-row groups 1024 bytes apart (SBO); LBO unused.
// MN-major tiles: 64-element MN blocks LBO bytes apart, 8-deep K groups SBO.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) | (static_cast<uint64_t>(sbo >> 4) << 32) |
         (1ull << 62);
}

// d[64 x 128] += A[64 x 16] * B[16 x 128]; TRANS_B: B is MN-major in shared memory
template <int TRANS_B>
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, %67;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),
        "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]),
        "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
        "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1), "n"(TRANS_B));
}

// keeps the compiler from moving accumulator reads or writes across the
// asynchronous wgmma (its registers change behind the compiler's back)
__device__ __forceinline__ void fence_acc(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Byte offset of (row, col) of a 128 x 128 bf16 tile in a consumer's buffer:
// two [128 rows][64 columns] boxes, each row 128 bytes with its 16-byte
// chunks permuted by row % 8 (TMA's 128-byte swizzle).
__device__ __forceinline__ uint32_t tile_offset(int row, int col) {
  return (col >> 6) * BOX_BYTES + row * 128 + ((((col & 63) >> 3) ^ (row & 7)) << 4) +
         ((col & 7) << 1);
}

// Tile t of the block's share (t = blockIdx.x, + gridDim.x, ...; columns
// fastest, or rows fastest with ROWS_FIRST, then splits) and its K slices
// [kb, kb + nk).
struct Tile {
  int row0, col0, split, kb, nk;
};

template <bool ROWS_FIRST>
__device__ __forceinline__ Tile tile_at(int t, const GemmArgs& p) {
  const int tiles_n = (p.Ncols + BN - 1) / BN, tiles_m = (p.M + BM - 1) / BM;
  const int tiles_mn = tiles_n * tiles_m;
  Tile r;
  r.split = t / tiles_mn;
  if constexpr (ROWS_FIRST) {
    r.row0 = t % tiles_mn % tiles_m * BM;
    r.col0 = t % tiles_mn / tiles_m * BN;
  } else {
    r.row0 = (t % tiles_mn) / tiles_n * BM;
    r.col0 = t % tiles_n * BN;
  }
  r.kb = r.split * p.kper;
  r.nk = min(p.ksteps, r.kb + p.kper) - r.kb;
  return r;
}

// The end of every epilogue that leaves through the consumer's tile buffer:
// its threads' writes are made visible to TMA and waited for, then the
// leader stores the buffer's two 64-column boxes through `map` at the tile's
// place and, when `wait`, waits until the store has read the buffer (else
// it calls tma_store_wait_read itself before the buffer is written again).
__device__ __forceinline__ void store_tile(const CUtensorMap* map, uint32_t buf, const Tile& tl,
                                           bool wait = true) {
  fence_async_smem();
  bar_sync(3 + threadIdx.x / 128, 128);
  if (threadIdx.x % 128 == 0) {
    tma_store(map, buf, tl.col0, tl.row0);
    tma_store(map, buf + BOX_BYTES, tl.col0 + 64, tl.row0);
    tma_store_commit();
    if (wait) tma_store_wait_read();
  }
}

// The LM-head epilogues' inputs from global memory, loaded before the tile's
// main loop so that their latency hides behind it: the thread's bias pairs
// (columns c0 + 8 j + {0, 1}; 0 past Ncols) and its four rows' labels, as
// tile columns less c0 (-1 past M); for EPI_DLOGITS also the four rows'
// max, 1 / exp-sum and scale (0 past M).
struct RowIn {
  float2 bias[BN / 8];
  int label[4];
  float m[4], inv_se[4], scale[4];
};

template <int EPI>
__device__ __forceinline__ RowIn row_inputs(const GemmArgs& p, const Tile& tl) {
  const int t = threadIdx.x % 128;
  const int r0 = 16 * (t / 32) + (t % 32) / 4, c0 = 2 * (t % 4);
  RowIn in;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int col = tl.col0 + c0 + 8 * j;
    in.bias[j] = col + 1 < p.Ncols ? *reinterpret_cast<const float2*>(p.bias + col)
                                   : make_float2(col < p.Ncols ? p.bias[col] : 0.f, 0.f);
  }
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int row = tl.row0 + 64 * (r >> 1) + r0 + 8 * (r & 1);
    const bool live = row < p.M;
    in.label[r] = live ? p.labels[row] - tl.col0 - c0 : -1;
    if (EPI == EPI_DLOGITS) {
      in.m[r] = live ? p.row_m[row] : 0.f;
      in.inv_se[r] = live ? p.row_inv_se[row] : 0.f;
      in.scale[r] = live ? p.row_scale[row] : 0.f;
    }
  }
  return in;
}

// K7's epilogue on a consumer's tile (register layout as in epilogue below):
// logits = bf16(acc + bias), stored by TMA through out_c when store_c, and
// from the same rounded values, for each row r < M of the tile, the partial
// (max, exp-sum about that max, label logit or 0) over the tile's columns
// below Ncols, at stats[{0, 1, 2} M nvt + r nvt + col0 / BN]. A thread holds
// 32 values of each of its four rows; the four lanes t % 4 of a row reduce
// by shuffles. Columns past Ncols (W's rows there load as zero) count as
// -inf: exp gives them exactly 0, and the row max stays finite because
// col0 < Ncols.
__device__ __forceinline__ void stats_epilogue(float (&acc)[2][64], const RowIn& in,
                                               const GemmArgs& p, const Tile& tl,
                                               unsigned char* bufp, uint32_t buf,
                                               const CUtensorMap* out_c) {
  const int t = threadIdx.x % 128, cw = threadIdx.x / 128;
  const bool leader = t == 0, store = p.store_c != 0;
  const int r0 = 16 * (t / 32) + (t % 32) / 4, c0 = 2 * (t % 4);
  if (store) bar_sync(3 + cw, 128);  // the leader's last store has read the buffer
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int col = tl.col0 + c0 + 8 * j;
    const bool in0 = col < p.Ncols, in1 = col + 1 < p.Ncols;
    const float b0 = in.bias[j].x, b1 = in.bias[j].y;
#pragma unroll
    for (int hf = 0; hf < 2; ++hf)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float& v0 = acc[hf][4 * j + 2 * h];
        float& v1 = acc[hf][4 * j + 2 * h + 1];
        const __nv_bfloat162 r = __floats2bfloat162_rn(v0 + b0, v1 + b1);
        if (store)
          *reinterpret_cast<__nv_bfloat162*>(bufp + tile_offset(64 * hf + r0 + 8 * h,
                                                                c0 + 8 * j)) = r;
        const float2 f = __bfloat1622float2(r);
        v0 = in0 ? f.x : -INFINITY;
        v1 = in1 ? f.y : -INFINITY;
      }
  }
  if (store) store_tile(out_c, buf, tl, false);  // it runs while the statistics are taken
  const int nvt = (p.Ncols + BN - 1) / BN;
  const size_t plane = static_cast<size_t>(p.M) * nvt;
#pragma unroll
  for (int hf = 0; hf < 2; ++hf)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = tl.row0 + 64 * hf + r0 + 8 * h;
      float m = -INFINITY;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j)
        m = fmaxf(m, fmaxf(acc[hf][4 * j + 2 * h], acc[hf][4 * j + 2 * h + 1]));
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 2));
      const int label = in.label[2 * hf + h];
      float se = 0.f, ll = 0.f;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const float v0 = acc[hf][4 * j + 2 * h], v1 = acc[hf][4 * j + 2 * h + 1];
        se += expf(v0 - m);
        se += expf(v1 - m);
        if (label == 8 * j) ll = v0;
        if (label == 8 * j + 1) ll = v1;
      }
#pragma unroll
      for (int o = 1; o <= 2; o <<= 1) {
        se += __shfl_xor_sync(0xffffffffu, se, o);
        ll += __shfl_xor_sync(0xffffffffu, ll, o);
      }
      if (row < p.M && t % 4 == 0) {
        const size_t i = static_cast<size_t>(row) * nvt + tl.col0 / BN;
        p.stats[i] = m;
        p.stats[plane + i] = se;
        p.stats[2 * plane + i] = ll;
      }
    }
  if (store && leader) tma_store_wait_read();
}

// K10's first pass on a consumer's tile (register layout as in epilogue
// below): the logits bf16(acc + bias) rounded as stats_epilogue rounds
// them, then dlogit of each with its row's statistics, 0 in the columns
// past Ncols, into the tile buffer and out by TMA through out_c, whose map
// spans the dlogits buffer's padded row, so its pad columns get zeros.
__device__ __forceinline__ void dlogits_epilogue(float (&acc)[2][64], const RowIn& in,
                                                 const GemmArgs& p, const Tile& tl,
                                                 unsigned char* bufp, uint32_t buf,
                                                 const CUtensorMap* out_c) {
  const int t = threadIdx.x % 128, cw = threadIdx.x / 128;
  const int r0 = 16 * (t / 32) + (t % 32) / 4, c0 = 2 * (t % 4);
  bar_sync(3 + cw, 128);  // the leader's last store has read the buffer
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int col = tl.col0 + c0 + 8 * j;
    const bool in0 = col < p.Ncols, in1 = col + 1 < p.Ncols;
#pragma unroll
    for (int hf = 0; hf < 2; ++hf)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = 2 * hf + h;
        const float2 f = __bfloat1622float2(__floats2bfloat162_rn(
            acc[hf][4 * j + 2 * h] + in.bias[j].x, acc[hf][4 * j + 2 * h + 1] + in.bias[j].y));
        const float d0 = in0 ? dlogit(f.x, in.m[r], in.inv_se[r], in.scale[r],
                                      in.label[r] == 8 * j) : 0.f;
        const float d1 = in1 ? dlogit(f.y, in.m[r], in.inv_se[r], in.scale[r],
                                      in.label[r] == 8 * j + 1) : 0.f;
        *reinterpret_cast<__nv_bfloat162*>(bufp + tile_offset(64 * hf + r0 + 8 * h,
                                                              c0 + 8 * j)) =
            __floats2bfloat162_rn(d0, d1);
      }
  }
  store_tile(out_c, buf, tl);
}

// The epilogue of consumer cw on its tile. Thread t holds, for half hf, j <
// 16 and h < 2, the pair acc[hf][4j + 2h], acc[hf][4j + 2h + 1] at tile row
// 64 hf + 16 (t / 32) + t % 32 / 4 + 8h and columns 8j + 2 (t % 4) + {0, 1}.
// `bufp` is the consumer's tile buffer (`buf` its shared-memory address);
// out_c is the result's map, out_d F1's a (stored when store_d) or B1's a
// (loaded by the producer).
template <int EPI>
__device__ __forceinline__ void epilogue(float (&acc)[2][64], const RowIn& in,
                                         const GemmArgs& p, const Tile& tl,
                                         unsigned char* bufp, uint32_t buf, uint32_t aux_full,
                                         uint32_t aux_empty, uint32_t aux_parity,
                                         const CUtensorMap* out_c, const CUtensorMap* out_d) {
  const int t = threadIdx.x % 128, cw = threadIdx.x / 128;
  const bool leader = t == 0;
  const int r0 = 16 * (t / 32) + (t % 32) / 4, c0 = 2 * (t % 4);
  if (EPI == EPI_STATS) {
    stats_epilogue(acc, in, p, tl, bufp, buf, out_c);
    return;
  }
  if (EPI == EPI_DLOGITS) {
    dlogits_epilogue(acc, in, p, tl, bufp, buf, out_c);
    return;
  }
  if (EPI == EPI_OUT && p.partial != nullptr) {
    // a split K walk: fp32 partial sums straight to global memory
    const size_t part = static_cast<size_t>(tl.split) * p.M * p.Ncols;
#pragma unroll
    for (int hf = 0; hf < 2; ++hf)
#pragma unroll
      for (int j = 0; j < BN / 8; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = tl.row0 + 64 * hf + r0 + 8 * h, col = tl.col0 + c0 + 8 * j;
          if (row < p.M && col < p.Ncols)  // Ncols is even: a pair is in or out whole
            *reinterpret_cast<float2*>(p.partial + part + static_cast<size_t>(row) * p.Ncols +
                                       col) = make_float2(acc[hf][4 * j + 2 * h],
                                                          acc[hf][4 * j + 2 * h + 1]);
        }
    return;
  }
  if (EPI == EPI_DGELU) {
    mbar_wait(aux_full, aux_parity);  // the a tile is in the buffer
  } else {
    bar_sync(3 + cw, 128);  // the leader's last store has read the buffer
  }
  // pass 1, from the registers: a (F1), y or dx, or da (from a, in place)
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int col = c0 + 8 * j;
    float2 b = make_float2(0.f, 0.f);
    if (p.bias != nullptr && tl.col0 + col < p.Ncols)
      b = *reinterpret_cast<const float2*>(p.bias + tl.col0 + col);
#pragma unroll
    for (int hf = 0; hf < 2; ++hf)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        __nv_bfloat162* pair =
            reinterpret_cast<__nv_bfloat162*>(bufp + tile_offset(64 * hf + r0 + 8 * h, col));
        const float v0 = acc[hf][4 * j + 2 * h], v1 = acc[hf][4 * j + 2 * h + 1];
        if (EPI == EPI_DGELU) {
          const float2 a = __bfloat1622float2(*pair);
          *pair = __floats2bfloat162_rn(v0 * dgelu_exact(a.x), v1 * dgelu_exact(a.y));
        } else {
          *pair = __floats2bfloat162_rn(v0 + b.x, v1 + b.y);
        }
      }
  }
  if (EPI == EPI_GELU) {
    if (p.store_d) store_tile(out_d, buf, tl);
    bar_sync(3 + cw, 128);  // pass 1 is in the buffer (and the store of a has read it)
    // pass 2, h = bf16(gelu(a)) in place: 16-byte chunks, eight erfs each
#pragma unroll 2
    for (int k = 0; k < TILE_BYTES / 16 / 128; ++k) {
      uint4* chunk = reinterpret_cast<uint4*>(bufp + 16 * (128 * k + t));
      uint4 v = *chunk;
      __nv_bfloat162* e = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        const float2 a = __bfloat1622float2(e[m]);
        e[m] = __floats2bfloat162_rn(gelu_exact(a.x), gelu_exact(a.y));
      }
      *chunk = v;
    }
  }
  store_tile(out_c, buf, tl);
  if (EPI == EPI_DGELU && leader) mbar_arrive(aux_empty);  // the buffer may take the next a tile
}

// out = A @ B over the block's tiles (A [M, K] K-major; B K-major [Ncols, K]
// or, B_MN, MN-major [K, Ncols]). q counts K slices through the ring, over
// all the block's tiles in order: slice q sits in stage q % STAGES, in that
// stage's (q / STAGES)-th round. ROWS_FIRST picks the tile order (tile_at).
template <int EPI, bool B_MN, bool ROWS_FIRST = false>
__device__ __forceinline__ void gemm_tiles(const CUtensorMap* tma_a, const CUtensorMap* tma_b,
                                           const CUtensorMap* out_c, const CUtensorMap* out_d,
                                           const GemmArgs& p) {
  extern __shared__ unsigned char smem_raw[];
  // 128-byte swizzled TMA boxes want 1024-byte aligned shared memory
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  const uint32_t base = smem_u32(smem);
  const uint32_t bufs = base + STAGES * STAGE_BYTES;   // consumer cw's buffer at bufs + cw*TILE
  const uint32_t full0 = bufs + 2 * TILE_BYTES;        // full[s] at full0 + 8s
  const uint32_t empty0 = full0 + 8 * STAGES;          // empty[s] at empty0 + 8s
  const uint32_t aux_full0 = empty0 + 8 * STAGES;      // aux_full[cw] at aux_full0 + 8cw
  const uint32_t aux_empty0 = aux_full0 + 16;          // aux_empty[cw] at aux_empty0 + 8cw
  const int tiles = ((p.Ncols + BN - 1) / BN) * ((p.M + BM - 1) / BM) * p.splits;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full0 + 8 * s, 1);       // the producer's arrive, plus the bytes
      mbar_init(empty0 + 8 * s, 4);      // one arrive from each warp of the consumer
    }
    for (int c = 0; c < 2; ++c) {
      mbar_init(aux_full0 + 8 * c, 1);
      mbar_init(aux_empty0 + 8 * c, 1);  // the consumer's leader
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= 256) {
    // producer warpgroup: one thread keeps the ring full
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    if (threadIdx.x == 256) {
      uint32_t q = 0;
      int i = 0;
      for (int t = blockIdx.x; t < tiles; t += gridDim.x, ++i) {
        const Tile tl = tile_at<ROWS_FIRST>(t, p);
        for (int k = tl.kb; k < tl.kb + tl.nk; ++k, ++q) {
          const uint32_t stage = q % STAGES;
          mbar_wait(empty0 + 8 * stage, ((q / STAGES) & 1) ^ 1);  // round 0 finds it free
          const uint32_t full = full0 + 8 * stage;
          mbar_expect_tx(full, STAGE_BYTES);
          const uint32_t a_s = base + stage * STAGE_BYTES, b_s = a_s + A_BYTES;
          tma_load(a_s, tma_a, full, k * BK, tl.row0);
          if (B_MN) {
#pragma unroll
            for (int j = 0; j < BN / 64; ++j)
              tma_load(b_s + j * BK * 128, tma_b, full, tl.col0 + 64 * j, k * BK);
          } else {
            tma_load(b_s, tma_b, full, k * BK, tl.col0);
          }
        }
        if (EPI == EPI_DGELU) {
          // the tile's a, into its consumer's buffer once that has been stored
          const int cw = i & 1;
          mbar_wait(aux_empty0 + 8 * cw, ((i >> 1) & 1) ^ 1);
          const uint32_t full = aux_full0 + 8 * cw, buf = bufs + cw * TILE_BYTES;
          mbar_expect_tx(full, TILE_BYTES);
          tma_load(buf, out_d, full, tl.col0, tl.row0);
          tma_load(buf + BOX_BYTES, out_d, full, tl.col0 + 64, tl.row0);
        }
      }
    }
  } else {
    // consumer warpgroup cw: the block's tiles 2i + cw
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
    const int cw = threadIdx.x / 128;
    const bool lane0 = threadIdx.x % 32 == 0;
    const uint32_t buf = bufs + cw * TILE_BYTES;
    unsigned char* bufp = smem + STAGES * STAGE_BYTES + cw * TILE_BYTES;
    uint32_t q = 0;
    int i = 0;
    for (int t = blockIdx.x; t < tiles; t += gridDim.x, ++i) {
      const Tile tl = tile_at<ROWS_FIRST>(t, p);
      if ((i & 1) != cw) {  // the other warpgroup's tile: skip its slices
        q += tl.nk;
        continue;
      }
      // A parity wait is unambiguous only within one round of the ring, so a
      // warpgroup starts its main loop once the other has passed every wait
      // of the tile before (the ping-pong order: main loops in turn, each
      // epilogue beside the other warpgroup's main loop).
      if (i > 0) bar_sync(1 + cw, 256);
      RowIn in;
      if (EPI == EPI_STATS || EPI == EPI_DLOGITS) in = row_inputs<EPI>(p, tl);
      float acc[2][64];
#pragma unroll
      for (int j = 0; j < 64; ++j) acc[0][j] = acc[1][j] = 0.f;
      fence_acc(acc[0]);
      fence_acc(acc[1]);
      for (int it = 0; it < tl.nk; ++it, ++q) {
        const uint32_t stage = q % STAGES;
        mbar_wait(full0 + 8 * stage, (q / STAGES) & 1);
        const uint32_t a_s = base + stage * STAGE_BYTES;
        const uint32_t b_s = a_s + A_BYTES;
        asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk) {
          const uint64_t db = B_MN ? sw128_desc(b_s + 2048 * kk, BK * 128, 1024)
                                   : sw128_desc(b_s + 32 * kk, 16, 1024);
          wgmma_m64n128k16<B_MN ? 1 : 0>(acc[0], sw128_desc(a_s + 32 * kk, 16, 1024), db);
          wgmma_m64n128k16<B_MN ? 1 : 0>(acc[1], sw128_desc(a_s + 8192 + 32 * kk, 16, 1024),
                                         db);
        }
        asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
        // the slice before this one is read: hand its stage back to the producer
        asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
        if (it > 0 && lane0) mbar_arrive(empty0 + 8 * ((q - 1) % STAGES));
      }
      if (t + gridDim.x < tiles) bar_arrive(2 - cw, 256);  // the next tile, the other's, may go
      asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
      if (lane0) mbar_arrive(empty0 + 8 * ((q - 1) % STAGES));
      fence_acc(acc[0]);
      fence_acc(acc[1]);
      epilogue<EPI>(acc, in, p, tl, bufp, buf, aux_full0 + 8 * cw, aux_empty0 + 8 * cw,
                    (i >> 1) & 1, out_c, out_d);
    }
    if (threadIdx.x % 128 == 0) tma_store_wait_all();
  }
}


// sums the fp32 partials of a split K walk in split order (bias may be
// null): the body of each includer's finalize kernel
__device__ __forceinline__ void finalize_sum(const float* __restrict__ partial,
                                             const float* __restrict__ bias,
                                             bf16* __restrict__ out, int M, int Ncols,
                                             int nsplit) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  const size_t n = (size_t)M * Ncols;
  if (i >= n) return;
  float s = 0.f;
  for (int p = 0; p < nsplit; ++p) s += partial[p * n + i];
  out[i] = __float2bfloat16(bias != nullptr ? s + bias[i % Ncols] : s);
}

// ---------------------------------------------------------------------------
// host side

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, fetched through the runtime's entry-point query,
// so the library links no libcuda of its own
inline EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                             cudaEnableDefault, &q);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (err == cudaSuccess && q == cudaDriverEntryPointSuccess) fn = (EncodeTiledFn)p;
  }
  return fn;
}

// a bf16 row-major [outer, inner] tensor with a row pitch of ld elements
// (ld * 2 a multiple of 16 bytes), read or written in boxes of [box_outer,
// box_inner], 128-byte swizzled in shared memory; TMA zero-fills reads past
// [outer, inner] and clips writes there
inline cudaError_t make_map(CUtensorMap* map, const void* ptr, int inner, int outer, int ld,
                     int box_inner, int box_outer) {
  const EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return cudaErrorSymbolNotFound;
  const cuuint64_t dims[2] = {(cuuint64_t)inner, (cuuint64_t)outer};
  const cuuint64_t strides[1] = {(cuuint64_t)ld * sizeof(bf16)};
  const cuuint32_t box[2] = {(cuuint32_t)box_inner, (cuuint32_t)box_outer};
  const cuuint32_t elem_strides[2] = {1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr), dims,
                            strides, box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

typedef void (*GemmKernel)(const CUtensorMap, const CUtensorMap, const CUtensorMap,
                           const CUtensorMap, const GemmArgs);

// C = A @ B on `kernel`, an includer's __global__ wrapper of gemm_tiles<EPI,
// B_MN>; `configured` holds a bit per device whose kernel attributes are
// set. A [M, K] K-major with row pitch lda; B = W [Ncols, K] (K-major) or W
// [K, Ncols] (b_mn); C bf16 [M, ldc] (ldc 0: Ncols), or null when the
// epilogue stores nothing (EPI_STATS with store_c 0); D bf16 [M, Ncols]
// (D: F1's a out or B1's a in, or null). C's map spans its whole row, so an
// epilogue writes the columns [Ncols, ldc) of the last tile as well. p.splits
// > 1 walks K in parts of p.kper slices into p.partial.
inline cudaError_t gemm_launch(GemmKernel kernel, unsigned& configured, bool b_mn, const void* A,
                        int lda, const void* W, void* C, const void* D, GemmArgs p, int K,
                        int ctas, cudaStream_t s, int ldc = 0) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device >= 32 || !(configured >> device & 1)) {
    cudaFuncAttributes attr;
    err = cudaFuncGetAttributes(&attr, kernel);
    if (err != cudaSuccess) return err;
    // the registers the producer frees must cover what the consumers ask
    const int regs = attr.numRegs;
    if (regs < PRODUCER_REGS || regs > CONSUMER_REGS ||
        128 * (regs - PRODUCER_REGS) < 256 * (CONSUMER_REGS - regs))
      return cudaErrorInvalidConfiguration;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
    if (err != cudaSuccess) return err;
    if (device < 32) configured |= 1u << device;
  }
  CUtensorMap ta, tb, tc = {}, td = {};  // a null C or D gets no map: nothing reads it
  err = make_map(&ta, A, K, p.M, lda, BK, BM);
  if (err == cudaSuccess)
    err = b_mn ? make_map(&tb, W, p.Ncols, K, p.Ncols, 64, BK)
               : make_map(&tb, W, K, p.Ncols, K, BK, BN);
  if (ldc <= 0) ldc = p.Ncols;
  if (err == cudaSuccess && C != nullptr) err = make_map(&tc, C, ldc, p.M, ldc, 64, BM);
  if (err == cudaSuccess && D != nullptr) err = make_map(&td, D, p.Ncols, p.M, p.Ncols, 64, BM);
  if (err != cudaSuccess) return err;
  p.ksteps = (K + BK - 1) / BK;
  if (p.splits == 1) p.kper = p.ksteps;
  kernel<<<ctas, THREADS, SMEM_BYTES, s>>>(ta, tb, tc, td, p);
  return cudaGetLastError();
}

typedef void (*FinalizeKernel)(const float*, const float*, bf16*, int, int, int);

inline cudaError_t finalize_launch(FinalizeKernel kernel, const float* partial, const float* bias,
                            bf16* out, int M, int Ncols, int nsplit, cudaStream_t s) {
  const size_t n = (size_t)M * Ncols;
  kernel<<<(unsigned)((n + 255) / 256), 256, 0, s>>>(partial, bias, out, M, Ncols, nsplit);
  return cudaGetLastError();
}

}  // namespace kmb_wg
