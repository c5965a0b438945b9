// The persistent, warp-specialised wgmma + TMA GEMM main loop of K2, K2b
// (ffn.cu) and of the LM head's projection in K7, K9 and K10's first pass
// (lm_ce.cu), shared by the files that instantiate it under their own
// kernel names (a profile tells them apart), and the helpers (barriers,
// TMA, descriptors, maps, dlogit) of K8's own kernel (lm_ce_bwd.cu):
// C = A @ B with A [M, K] read K-major and B either K-major [Ncols, K] or
// MN-major [K, Ncols] (B_MN, through wgmma's transpose of 16-bit operands),
// bf16 operands, fp32 accumulation, and one of five epilogues: EPI_GELU and
// EPI_DGELU are K2's and K2b's (ffn.cu's source note), EPI_OUT rounds the
// sum (plus an optional fp32 bias) to bf16 (the second GEMMs of K2 and
// K2b), EPI_STATS is K7's and K9's (the LM
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
//
// A Layout picks the tiles and the depth walk (the default, Legacy, is all
// of the above). K2's inference forward (ffn.cu, ops/ffn.py infer_plan)
// adds other tiles, each consumer's share still m64n128k16 accumulators:
// 64 x 128 with one consumer a tile (H 1), and both consumers on one tile
// with ping-pong off, each with its own 64 rows of a 128 x 128 tile (COOP)
// or its own 128 columns of a 64 x 256 one (WIDE), which leaves each the
// registers for a second fp32 accumulator. And two ways to walk the second
// GEMM's depth in the partials' fixed parts without writing them out.
// MODE_SUM: one tile walks every part, each part in a fresh accumulator
// that is then added to a running fp32 sum. MODE_CLUSTER: the parts of one
// tile run on the CTAs of one thread-block cluster, one or two each (kept
// in registers); each CTA leaves its parts in its own shared memory, and
// after a cluster barrier each sums a band of the tile's rows from all of
// them (distributed shared memory), in part order. Both add exactly what
// finalize_sum adds, in its order: 0, then part 0, 1, ..., then the bias,
// then one rounding. Each part's accumulator is the same chain of wgmma
// instructions on the same slices, so the result is bit for bit the
// partials route's at every row count. The second GEMM is launched as a
// programmatic dependent of the first (DEPENDENT): its blocks start as the
// first's end and load their first weight slices before waiting for it.
// That is safe because the first GEMM is launched in stream order: it
// starts only after every earlier kernel (a cast that wrote the weight,
// say) has ended, and the second starts only after the first has. The
// first is not a dependent itself for that reason.
//
// K2's training forward and K2b (ffn.cu, ffn_bwd.cu; ops/ffn.py
// train_plan) run their first GEMM on FAST layouts: Legacy's tiles and
// ring, with fast_epilogue for EPI_GELU and EPI_DGELU, which reads and
// writes the tile buffer by shared-memory address, each pass loading what
// it reads before it stores. Legacy's epilogue goes through generic
// pointers; the compiler cannot tell its loads from the stores before them
// and ran the buffer one element pair or chunk at a time behind each load.
// Fast is B1's. Table (LUT, F1's) reads h = bf16(gelu(a)) from a 10 KB
// table of every bf16 a of magnitude in [2^-16, 16) (the formula for the
// other a), which consumer 1 fills while consumer 0 runs the first main
// loop, at one ring stage less. Both give Legacy's bits.
//
// K7, K9 and K10's first pass (lm_ce.cu) run on COOP layouts with 128 rows
// a consumer (H 2): both consumers on one 256 x 128 tile, each its own 128
// rows as Legacy's consumers take theirs, so each element's sum is the chain
// it had on Legacy's tiles, bit for bit. A slice then moves 48 KB for 2 M
// MACs (Legacy: 32 KB for 1 M), which the main loop's feed wanted more than
// it wanted the ping-pong's overlap: a clock64 timeline put Legacy's K9 at
// 945 cycles a 64-deep slice (512 of tensor work), its consumers waiting for
// data at every slice with the ring full of loads in flight, and seven
// stages in the buffers' room did not change that. The epilogues no longer
// hide under the other consumer's main loop. K9 (StatsCoop) stores nothing
// and keeps no tile buffers (NOBUF), four stages in their room (on
// DlogitsCoop's three it measured 3% slower on an H100); K7 (LogitsCoop)
// keeps four stages with half buffers (HALFBUF: 64 columns a consumer, the
// tile's logits leaving in two halves; on three stages with whole buffers
// its main loop waited for data a third of the time); K10's first pass
// (DlogitsCoop) keeps its two whole buffers and three stages, its dlogits
// epilogue in branch-free chunks written by shared address
// (dlogits_epilogue's note).
#pragma once

#include <cuda.h>  // CUtensorMap and its enums; the encoder is fetched at run time

#include <initializer_list>

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

// how a tile walks its depth: whole, or in p.splits parts of p.kper slices
// with fp32 partials out (EPI_OUT with p.partial); in parts summed in
// registers; or in parts on the CTAs of a cluster (the header note)
enum { MODE_PLAIN = 0, MODE_SUM = 1, MODE_CLUSTER = 2 };

// The LUT layout's epilogue table: EPI_GELU's bf16(gelu(a)) for every bf16
// a of magnitude in [2^(LUT_E0 - 127), 2^(LUT_E0 - 127 + LUT_NE)), each
// computed by the formula the other a take (lut_index)
constexpr int LUT_E0 = 127 - 16, LUT_NE = 20;
constexpr int LUT_HALF = LUT_NE * 128;  // entries a sign
constexpr int LUT_BYTES = 2 * LUT_HALF * 2;

// One instantiation's tiles and shared memory. H: m64 halves a consumer
// computes (its accumulator is H x 64 registers a thread); COOP: both
// consumers on one 128-row tile, consumer cw on its rows [64 cw, 64 cw +
// 64); WIDE: both on one 64 x 256 tile, consumer cw on its columns [128 cw,
// 128 cw + 128) (every consumer's share is an m64n128 accumulator, as in
// the other layouts). FAST, LUT: the training layouts' first-GEMM
// epilogues (the header note).
template <int H_, bool COOP_, int MODE_, int STAGES_, bool DEPENDENT_ = false,
          bool WIDE_ = false, bool FAST_ = false, bool LUT_ = false, bool NOBUF_ = false,
          bool HALFBUF_ = false>
struct Layout {
  static constexpr int H = H_;
  static constexpr bool COOP = COOP_;
  static constexpr bool WIDE = WIDE_;
  static constexpr bool SHARED = COOP || WIDE;  // both consumers on every tile
  static constexpr int MODE = MODE_;
  static constexpr int STAGES = STAGES_;
  // launched as a programmatic dependent of the kernel before it (its A is
  // that kernel's output): B's first slices load before the wait for it
  static constexpr bool DEPENDENT = DEPENDENT_;
  // FAST: fast_epilogue (EPI_GELU, EPI_DGELU); LUT: its gelu from a table (lut_index)
  static constexpr bool FAST = FAST_ || LUT_;
  static constexpr bool LUT = LUT_;
  static constexpr int WG_ROWS = 64 * H;                      // a consumer's rows of a tile
  static constexpr int TILE_ROWS = WG_ROWS * (COOP ? 2 : 1);  // rows a stage's A slice covers
  static constexpr int TILE_COLS = BN * (WIDE ? 2 : 1);       // columns its B slice covers
  static constexpr int A_BYTES = TILE_ROWS * BK * 2;
  static constexpr int STAGE_BYTES = A_BYTES + TILE_COLS * BK * 2;
  // a consumer's bf16 buffer: two 64-column boxes, or with HALFBUF one (the
  // tile leaves it in two halves, K7's)
  static constexpr bool HALFBUF = HALFBUF_;
  static constexpr int TILE_BYTES = WG_ROWS * BN * (HALFBUF ? 1 : 2);
  static constexpr int BOX_BYTES = HALFBUF ? TILE_BYTES : TILE_BYTES / 2;
  // NOBUF: the epilogue stores nothing (EPI_STATS without its store, K9), so
  // the consumers keep no tile buffers and the ring has their room
  static constexpr int BUFS = NOBUF_ ? 0 : 2;
  static constexpr int NBARS = 2 * STAGES + 4;
  static constexpr int SMEM_BYTES =
      STAGES * STAGE_BYTES + BUFS * TILE_BYTES + 8 * NBARS + (LUT ? LUT_BYTES : 0) + 1024;
  static constexpr int EMPTY_ARRIVES = SHARED ? 8 : 4;  // one arrive from each consumer warp
  static_assert(!LUT || (!SHARED && MODE == MODE_PLAIN), "consumer 1 builds the table");
  static_assert(BUFS || (!FAST && MODE == MODE_PLAIN), "only the statistics epilogue goes without");
  // MODE_CLUSTER: each CTA's fp32 parts of its tile (one or two, p.ppc),
  // each row-major with the rows padded to PART_PITCH bytes (a warp's
  // paired stores then take two wavefronts), PART_BYTES apart, over the
  // stage ring once the main loop is done
  static constexpr int PART_PITCH = (TILE_COLS + 8) * 4;
  static constexpr int PART_BYTES = TILE_ROWS * PART_PITCH;
  static_assert(MODE != MODE_SUM || H == 1, "a running sum needs a second accumulator's registers");
  static_assert(MODE != MODE_CLUSTER || H == 1, "a cluster's parts are kept in registers");
  static_assert(!SHARED || H == 1 || (COOP && MODE == MODE_PLAIN && !FAST),
                "a shared tile is two m64n128 shares, or two 128-row ones (the LM head's)");
  static_assert(!(COOP && WIDE), "one way to share a tile");
  static_assert(MODE != MODE_CLUSTER || 2 * PART_BYTES <= STAGES * STAGE_BYTES,
                "two parts over the ring");
  static_assert(SMEM_BYTES <= 232448, "over the 227 KB a block may use");
};
using Legacy = Layout<2, false, MODE_PLAIN, STAGES>;
static_assert(Legacy::SMEM_BYTES == SMEM_BYTES, "the Legacy layout is the constants above");
// K2's inference forward: its first GEMM at 64-row tiles, its second with
// the running sum or on a cluster (ops/ffn.py infer_plan picks them), as a
// programmatic dependent of the first
using Rows64 = Layout<1, false, MODE_PLAIN, 8>;
using CoopSum = Layout<1, true, MODE_SUM, 6, true>;
using Rows64Cluster = Layout<1, false, MODE_CLUSTER, 8, true>;  // consumer 0 alone
using WideCluster = Layout<1, false, MODE_CLUSTER, 4, true, true>;
// K2's training forward and K2b's first GEMMs (ops/ffn.py train_plan picks
// them): B1 on Legacy's tiles and ring with fast_epilogue (Fast), F1 the
// same with its GELU from a table, at one stage less (Table)
using Fast = Layout<2, false, MODE_PLAIN, STAGES, false, false, true>;
using Table = Layout<2, false, MODE_PLAIN, 4, false, false, true, true>;
// K7, K9 and K10's first pass: both consumers on one 256 x 128 tile, 128
// rows each (48 KB stages: a W slice feeds twice the rows it feeds in
// Legacy); K9 with no tile buffers and four stages, K10's first pass with
// its two buffers and three, K7 with two half buffers (16 KB, 64 columns
// each) and four
using StatsCoop = Layout<2, true, MODE_PLAIN, 4, false, false, false, false, true>;
using DlogitsCoop = Layout<2, true, MODE_PLAIN, 3>;
using LogitsCoop = Layout<2, true, MODE_PLAIN, 4, false, false, false, false, false, true>;
// the training layouts' codes (ops/ffn.py TRAIN_LAYOUTS): F1 takes Legacy
// or Table, B1 Legacy or Fast, the second GEMMs Legacy
enum { TRAIN_LEGACY = 0, TRAIN_FAST = 1, TRAIN_TABLE = 2 };
// The portable cluster size, and the most parts a MODE_CLUSTER tile may have
// (cluster_reduce reads that many at most): with two parts a block, clusters
// of up to MAX_CLUSTER / 2 blocks
constexpr int MAX_CLUSTER = 8;

// Fields past store_d are zero in an aggregate initialiser that stops there.
struct GemmArgs {
  const float* bias;  // added to the sum before the epilogue's rounding, or null (not EPI_STATS)
  float* partial;     // EPI_OUT with a split K walk: fp32 [splits, M, Ncols], else null
  int M, Ncols;
  int ksteps;         // 64-deep K slices in all
  int kper, splits;   // the K walk in `splits` parts of kper slices (the last may be short)
  int store_d;        // EPI_GELU: also store a through the second output map
  const int* labels;  // EPI_STATS, EPI_DLOGITS: each row's label column, [M]
  float* stats;       // EPI_STATS: fp32 [3, M, ceil(Ncols / BN)]: max, exp-sum, label logit
  const float* row_m;       // EPI_DLOGITS: each row's logit max, [M]
  const float* row_inv_se;  // EPI_DLOGITS: 1 / each row's exp-sum, [M]
  const float* row_scale;   // EPI_DLOGITS: each row's loss scale (0: an ignored label), [M]
  bf16* out;                // MODE_CLUSTER: the bf16 result [M, Ncols], stored without a map
  int ppc;                  // MODE_CLUSTER: parts a CTA (1 or 2): clusters of splits / ppc CTAs
};

__device__ __forceinline__ float gelu_exact(float z) {
  return z * 0.5f * (1.f + erff(z * 0.70710678118654752f));
}

__device__ __forceinline__ float dgelu_exact(float z) {
  // d/dz [z Phi(z)] = Phi(z) + z phi(z)
  return 0.5f * (1.f + erff(z * 0.70710678118654752f)) +
         z * 0.39894228040143268f * expf(-0.5f * z * z);
}

constexpr float LOG2E = 1.4426950408889634f;

// 2^x by the special function unit (ex2.approx: 2 ulps; 2^-inf = 0)
__device__ __forceinline__ float ex2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// one element of the LM loss's dlogits, scale (exp(logit - m) inv_se - [the
// label's column]), from the bf16-rounded logit: K8's transform and K10's
// EPI_DLOGITS both call it, and the _rn intrinsics keep the compiler from
// contracting either into an FMA, so the two agree bit for bit
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

// MODE_CLUSTER: this CTA's rank in its cluster; a barrier over every thread
// of the cluster (release: this CTA's shared-memory writes before it;
// acquire: the others' after it); a shared::cta address mapped into CTA
// `rank`'s shared memory, and a 16-byte load from there
__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

__device__ __forceinline__ void cluster_sync() {
  __syncwarp();
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

__device__ __forceinline__ uint32_t map_to_rank(uint32_t addr, uint32_t rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(r) : "r"(addr), "r"(rank));
  return r;
}

// programmatic dependent launch: let the next kernel's blocks start (they
// wait for this grid's end before reading what it writes), and wait for the
// kernel before this one to end, its writes visible
__device__ __forceinline__ void launch_dependents() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}

__device__ __forceinline__ void wait_prior_grid() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}

__device__ __forceinline__ float4 ld_cluster_f4(uint32_t addr) {
  float4 v;
  asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(addr));
  return v;
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
template <int N>
__device__ __forceinline__ void fence_acc(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Byte offset of (row, col) of a consumer's bf16 tile (128 columns) in its
// buffer: two [rows][64 columns] boxes BOX bytes apart, each row 128 bytes
// with its 16-byte chunks permuted by row % 8 (TMA's 128-byte swizzle).
template <int BOX = BOX_BYTES>
__device__ __forceinline__ uint32_t tile_offset(int row, int col) {
  return (col >> 6) * BOX + row * 128 + ((((col & 63) >> 3) ^ (row & 7)) << 4) +
         ((col & 7) << 1);
}

// Tile t of the block's share (t = blockIdx.x, + gridDim.x, ...; columns
// fastest, or rows fastest with ROWS_FIRST, then splits; MODE_CLUSTER:
// splits fastest, one tile a block) and its K slices [kb, kb + nk)
// (MODE_SUM: all of them, in parts of kper).
struct Tile {
  int row0, col0, split, kb, nk;
};

template <class L>
__device__ __forceinline__ int tile_count(const GemmArgs& p) {
  const int tiles_mn = ((p.Ncols + L::TILE_COLS - 1) / L::TILE_COLS) *
                       ((p.M + L::TILE_ROWS - 1) / L::TILE_ROWS);
  if constexpr (L::MODE == MODE_SUM) return tiles_mn;
  if constexpr (L::MODE == MODE_CLUSTER) return tiles_mn * (p.splits / p.ppc);
  return tiles_mn * p.splits;
}

template <bool ROWS_FIRST, class L>
__device__ __forceinline__ Tile tile_at(int t, const GemmArgs& p) {
  constexpr int TR = L::TILE_ROWS, TC = L::TILE_COLS;
  const int tiles_n = (p.Ncols + TC - 1) / TC, tiles_m = (p.M + TR - 1) / TR;
  const int tiles_mn = tiles_n * tiles_m;
  Tile r;
  int mn;
  if constexpr (L::MODE == MODE_CLUSTER) {
    r.split = t % (p.splits / p.ppc);  // the CTA's rank in its cluster: parts ppc r, ...
    mn = t / (p.splits / p.ppc);
  } else if constexpr (L::MODE == MODE_SUM) {
    r.split = 0;
    mn = t;
  } else {
    r.split = t / tiles_mn;
    mn = t % tiles_mn;
  }
  if constexpr (ROWS_FIRST) {
    r.row0 = mn % tiles_m * TR;
    r.col0 = mn / tiles_m * TC;
  } else {
    r.row0 = mn / tiles_n * TR;
    r.col0 = mn % tiles_n * TC;
  }
  if constexpr (L::MODE == MODE_SUM) {
    r.kb = 0;
    r.nk = p.ksteps;
  } else if constexpr (L::MODE == MODE_CLUSTER) {
    r.kb = r.split * p.ppc * p.kper;
    r.nk = min(p.ksteps, r.kb + p.ppc * p.kper) - r.kb;
  } else {
    r.kb = r.split * p.kper;
    r.nk = min(p.ksteps, r.kb + p.kper) - r.kb;
  }
  return r;
}

// The end of every epilogue that leaves through the consumer's tile buffer:
// its threads' writes are made visible to TMA and waited for, then the
// leader stores the buffer's two 64-column boxes (BOX bytes apart) through
// `map` at the tile's place and, when `wait`, waits until the store has read
// the buffer (else it calls tma_store_wait_read itself before the buffer is
// written again).
template <int BOX = BOX_BYTES>
__device__ __forceinline__ void store_tile(const CUtensorMap* map, uint32_t buf, const Tile& tl,
                                           bool wait = true) {
  fence_async_smem();
  bar_sync(3 + threadIdx.x / 128, 128);
  if (threadIdx.x % 128 == 0) {
    tma_store(map, buf, tl.col0, tl.row0);
    tma_store(map, buf + BOX, tl.col0 + 64, tl.row0);
    tma_store_commit();
    if (wait) tma_store_wait_read();
  }
}

// store_tile for a one-box buffer: its 64 columns at (c0, r0)
__device__ __forceinline__ void store_box(const CUtensorMap* map, uint32_t buf, int c0, int r0) {
  fence_async_smem();
  bar_sync(3 + threadIdx.x / 128, 128);
  if (threadIdx.x % 128 == 0) {
    tma_store(map, buf, c0, r0);
    tma_store_commit();
  }
}

// shared-memory loads and stores by address: volatile, so they keep their
// order among themselves (a load written before a store to the same place
// stays before it), and never taken for global ones (generic ld/st)
__device__ __forceinline__ uint32_t lds32(uint32_t addr) {
  uint32_t v;
  asm volatile("ld.shared.b32 %0, [%1];\n" : "=r"(v) : "r"(addr));
  return v;
}

__device__ __forceinline__ void sts32(uint32_t addr, uint32_t v) {
  asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(addr), "r"(v) : "memory");
}

__device__ __forceinline__ uint4 lds128(uint32_t addr) {
  uint4 v;
  asm volatile("ld.shared.v4.b32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "r"(addr));
  return v;
}

__device__ __forceinline__ void sts128(uint32_t addr, uint4 v) {
  asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(addr), "r"(v.x), "r"(v.y),
               "r"(v.z), "r"(v.w)
               : "memory");
}

// a table entry (the table is written once, before any read: plain asm,
// free to move)
__device__ __forceinline__ uint32_t lut_u16(uint32_t addr) {
  uint16_t v;
  asm("ld.shared.u16 %0, [%1];\n" : "=h"(v) : "r"(addr));
  return v;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 r = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&r);
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

// EPI_GELU's and EPI_OUT's bias pairs of the thread's columns of a 64-row
// share (H 1), loaded before the share's main loop so that their latency
// hides behind it (0 past Ncols or without a bias)
__device__ __forceinline__ RowIn bias_inputs(const GemmArgs& p, const Tile& tl) {
  const int c0 = 2 * (threadIdx.x % 4);
  RowIn in;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int col = tl.col0 + c0 + 8 * j;
    in.bias[j] = p.bias != nullptr && col < p.Ncols
                     ? *reinterpret_cast<const float2*>(p.bias + col)
                     : make_float2(0.f, 0.f);
  }
  return in;
}

// K7's epilogue on a consumer's tile (register layout as in epilogue below):
// logits = bf16(acc + bias), stored by TMA through out_c (STORE), and from
// the same rounded values, for each row r < M of the tile, the partial
// (max, exp-sum about that max, label logit or 0) over the tile's columns
// below Ncols, at stats[{0, 1, 2} M nvt + r nvt + col0 / BN]. A thread holds
// 32 values of each of its four rows; the four lanes t % 4 of a row reduce
// by shuffles. Columns past Ncols (W's rows there load as zero) count as
// -inf: exp gives them exactly 0, and the row max stays finite because
// col0 < Ncols. Each exponential is ex2.approx of one FFMA, (v - max) log2
// e, where expf took about ten instructions: the statistics' share of the
// epilogue, which a clock64 timeline on an H100 put at about 4,200 of its
// 9,200 cycles a tile, as long as the buffer's writes.
// That epilogue's work on one tile; MASK: some column lies past Ncols,
// LABEL: some lane of the warp may hold its row's label column (else ll is
// 0); STORE: the rounded pairs go out by TMA through the consumer's half
// buffer (at shared address buf, 64 columns), written by shared-memory
// address: the first 64 columns before the statistics are taken, so that
// their store runs beside them, the last 64 after, once that store has
// read the buffer; the next tile's writes wait for the second's read.
template <bool MASK, bool LABEL, bool STORE>
__device__ __forceinline__ void stats_tile(float (&acc)[2][64], const RowIn& in,
                                           const GemmArgs& p, const Tile& tl, uint32_t buf,
                                           const CUtensorMap* out_c) {
  const int t = threadIdx.x % 128, cw = threadIdx.x / 128;
  const int r0 = 16 * (t / 32) + (t % 32) / 4, c0 = 2 * (t % 4);
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const float b0 = in.bias[j].x, b1 = in.bias[j].y;
#pragma unroll
    for (int hf = 0; hf < 2; ++hf)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float& v0 = acc[hf][4 * j + 2 * h];
        float& v1 = acc[hf][4 * j + 2 * h + 1];
        const __nv_bfloat162 r = __floats2bfloat162_rn(v0 + b0, v1 + b1);
        if (STORE && j < BN / 16)
          sts32(buf + tile_offset(64 * hf + r0 + 8 * h, c0 + 8 * j),
                *reinterpret_cast<const uint32_t*>(&r));
        const float2 f = __bfloat1622float2(r);
        v0 = f.x;
        v1 = f.y;
      }
  }
  if constexpr (STORE) store_box(out_c, buf, tl.col0, tl.row0);  // read beside the statistics
  // the columns past Ncols count as -inf
  auto live = [&](int j, int e, float v) {
    return !MASK || tl.col0 + c0 + 8 * j + e < p.Ncols ? v : -INFINITY;
  };
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
        m = fmaxf(m, fmaxf(live(j, 0, acc[hf][4 * j + 2 * h]),
                           live(j, 1, acc[hf][4 * j + 2 * h + 1])));
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 2));
      const int label = in.label[2 * hf + h];
      const float ml = __fmul_rn(m, LOG2E);
      float se = 0.f, ll = 0.f;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const float v0 = live(j, 0, acc[hf][4 * j + 2 * h]);
        const float v1 = live(j, 1, acc[hf][4 * j + 2 * h + 1]);
        se += ex2_approx(fmaf(v0, LOG2E, -ml));
        se += ex2_approx(fmaf(v1, LOG2E, -ml));
        if (LABEL && label == 8 * j) ll = v0;
        if (LABEL && label == 8 * j + 1) ll = v1;
      }
#pragma unroll
      for (int o = 1; o <= 2; o <<= 1) {
        se += __shfl_xor_sync(0xffffffffu, se, o);
        if (LABEL) ll += __shfl_xor_sync(0xffffffffu, ll, o);
      }
      if (row < p.M && t % 4 == 0) {
        const size_t i = static_cast<size_t>(row) * nvt + tl.col0 / BN;
        p.stats[i] = m;
        p.stats[plane + i] = se;
        p.stats[2 * plane + i] = ll;
      }
    }
  if constexpr (STORE) {
    if (t == 0) tma_store_wait_read();  // the first half's store has read the buffer
    bar_sync(3 + cw, 128);
#pragma unroll
    for (int j = BN / 16; j < BN / 8; ++j)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          sts32(buf + tile_offset(64 * hf + r0 + 8 * h, c0 + 8 * j - BN / 2),
                pack_bf16(acc[hf][4 * j + 2 * h], acc[hf][4 * j + 2 * h + 1]));
    store_box(out_c, buf, tl.col0 + BN / 2, tl.row0);  // read while the next main loop runs
  }
}

// K7's and K9's epilogue on a consumer's tile: K7 (STORE: its layout keeps
// tile buffers) stores the logits, K9 (no buffer) only takes the
// statistics. Both run on 256-row cooperative tiles, where the epilogue no
// longer hides under the other consumer's main loop, so both drop the
// masks in the tiles that end before Ncols and the label compares in a
// warp whose rows' labels all lie outside the tile (393 of 394 column tiles
// at V 50320 and, for a warp's 16 rows, about 24 of 25 of them): the same
// values, fewer instructions. K7 waits for its last tile's store to have
// read the buffer before it writes the buffer again.
template <bool STORE>
__device__ __forceinline__ void stats_epilogue(float (&acc)[2][64], const RowIn& in,
                                               const GemmArgs& p, const Tile& tl, uint32_t buf,
                                               const CUtensorMap* out_c) {
  const int t = threadIdx.x % 128, cw = threadIdx.x / 128;
  if constexpr (STORE) {
    if (t == 0) tma_store_wait_read();  // the last tile's store has read the buffer
    bar_sync(3 + cw, 128);
  }
  const bool mask = tl.col0 + BN > p.Ncols;  // the same in every thread
  bool mine = false;  // one of the thread's rows has its label in the tile
#pragma unroll
  for (int r = 0; r < 4; ++r) mine |= static_cast<unsigned>(in.label[r] + 2 * (t % 4)) < BN;
  if (__any_sync(0xffffffffu, mine)) {
    if (mask) stats_tile<true, true, STORE>(acc, in, p, tl, buf, out_c);
    else stats_tile<false, true, STORE>(acc, in, p, tl, buf, out_c);
  } else {
    if (mask) stats_tile<true, false, STORE>(acc, in, p, tl, buf, out_c);
    else stats_tile<false, false, STORE>(acc, in, p, tl, buf, out_c);
  }
}

// K10's first pass on a consumer's tile (register layout as in epilogue
// below): the logits bf16(acc + bias) rounded as stats_epilogue rounds
// them, then dlogit of each with its row's statistics, 0 in the columns
// past Ncols, into the tile buffer and out by TMA through out_c, whose map
// spans the dlogits buffer's padded row, so its pad columns get zeros.
// On DlogitsCoop both consumers run it at once, after their main loop, so
// its length adds to the tile's. Each thread's 128 elements go in chunks
// of eight of one row (four column pairs), every dlogit of a chunk formed
// with no branch and then masked at Ncols, so that their exact expf chains
// overlap (with a branch around each element they ran one after another:
// a clock64 timeline on an H100 put that epilogue at 18,606 cycles a tile,
// this one at about 9,200); the buffer is written by shared-memory address
// (generic stores kept every access behind the store before it, as
// fast_epilogue's note says), and the tile's TMA store is waited for only
// before the next tile's writes. Only the last column tile masks at Ncols,
// and a warp whose rows' labels all lie outside the tile passes false for
// the label to every dlogit it forms (the same formula; the compiler drops
// the compares).
//
// That epilogue's chunks, on the sums with the bias already added; MASK:
// some column lies past Ncols, LABEL: some lane of the warp may hold its
// row's label column (else every dlogit takes dlogit's no-label branch)
template <bool MASK, bool LABEL>
__device__ __forceinline__ void dlogits_tile(float (&acc)[2][64], const RowIn& in,
                                             const GemmArgs& p, const Tile& tl, uint32_t buf) {
  const int t = threadIdx.x % 128;
  const int r0 = 16 * (t / 32) + (t % 32) / 4, c0 = 2 * (t % 4);
  const int lim = p.Ncols - tl.col0 - c0;  // the thread's columns 8j + {0, 1} below it are live
  constexpr int U = 4;                     // column pairs a chunk
#pragma unroll
  for (int hf = 0; hf < 2; ++hf)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = 2 * hf + h;
#pragma unroll
      for (int j0 = 0; j0 < BN / 8; j0 += U) {
        uint32_t d[U];
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int j = j0 + u;
          const float2 f = __bfloat1622float2(
              __floats2bfloat162_rn(acc[hf][4 * j + 2 * h], acc[hf][4 * j + 2 * h + 1]));
          const float v0 = dlogit(f.x, in.m[r], in.inv_se[r], in.scale[r],
                                  LABEL && in.label[r] == 8 * j);
          const float v1 = dlogit(f.y, in.m[r], in.inv_se[r], in.scale[r],
                                  LABEL && in.label[r] == 8 * j + 1);
          d[u] = pack_bf16(!MASK || 8 * j < lim ? v0 : 0.f, !MASK || 8 * j + 1 < lim ? v1 : 0.f);
        }
#pragma unroll
        for (int u = 0; u < U; ++u)
          sts32(buf + tile_offset(64 * hf + r0 + 8 * h, c0 + 8 * (j0 + u)), d[u]);
      }
    }
}

__device__ __forceinline__ void dlogits_epilogue(float (&acc)[2][64], const RowIn& in,
                                                 const GemmArgs& p, const Tile& tl, uint32_t buf,
                                                 const CUtensorMap* out_c) {
  const int t = threadIdx.x % 128, cw = threadIdx.x / 128;
  // the bias first (the same fp32 sum an element), so that its 32 registers
  // are free before the chunks' expf chains start (with them live, ptxas
  // spilled 120 bytes)
#pragma unroll
  for (int j = 0; j < BN / 8; ++j)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        acc[hf][4 * j + 2 * h] += in.bias[j].x;
        acc[hf][4 * j + 2 * h + 1] += in.bias[j].y;
      }
  if (t == 0) tma_store_wait_read();  // the last tile's store has read the buffer
  bar_sync(3 + cw, 128);
  bool mine = false;  // one of the thread's rows has its label in the tile
#pragma unroll
  for (int r = 0; r < 4; ++r) mine |= static_cast<unsigned>(in.label[r] + 2 * (t % 4)) < BN;
  if (tl.col0 + BN > p.Ncols)  // the last column tile (the same in every thread)
    dlogits_tile<true, true>(acc, in, p, tl, buf);
  else if (__any_sync(0xffffffffu, mine))
    dlogits_tile<false, true>(acc, in, p, tl, buf);
  else
    dlogits_tile<false, false>(acc, in, p, tl, buf);
  store_tile(out_c, buf, tl, false);  // read while the next main loop runs
}

// a bf16 a's entry in the LUT layouts' table (its bits u less LUT_E0 << 7,
// the sign's half after the other), or -1 outside the table's range (zero,
// tiny, huge, inf, nan: the formula)
__device__ __forceinline__ int lut_index(uint32_t u) {
  const int w = static_cast<int>(u & 0x7FFF) - (LUT_E0 << 7);
  return static_cast<unsigned>(w) < static_cast<unsigned>(LUT_HALF)
             ? w + static_cast<int>(u >> 15) * LUT_HALF
             : -1;
}

// consumer 1's thread t (of 128) fills its share of the table at `lut`
__device__ __forceinline__ void lut_build(unsigned char* lut, int t) {
  for (int i = t; i < 2 * LUT_HALF; i += 128) {
    const uint32_t u = (i >= LUT_HALF ? 0x8000u : 0u) | static_cast<uint32_t>(
                                                             i % LUT_HALF + (LUT_E0 << 7));
    reinterpret_cast<__nv_bfloat16*>(lut)[i] = __float2bfloat16_rn(gelu_exact(__uint_as_float(u << 16)));
  }
}

// EPI_GELU's pass 2, h = bf16(gelu(a)) in place over a tile buffer of bf16
// a: N 16-byte chunks a thread (chunks i, i + stride, ...; stride the
// threads taking part), eight erfs each
template <int N>
__device__ __forceinline__ void gelu_pass2(unsigned char* bufp, int i, int stride = 128) {
#pragma unroll 2
  for (int k = 0; k < N; ++k) {
    uint4* chunk = reinterpret_cast<uint4*>(bufp + 16 * (stride * k + i));
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

// the h pairs (bf16(gelu(a)), packed) of G pairs of bf16 a (u): by the
// formula, or from the table at shared address lut, all G read before any
// is used, and by the formula for the a the table does not hold, in a
// branch the whole warp takes or skips (a select would run the formula for
// every a)
template <int G, bool LUT>
__device__ __forceinline__ void gelu_group(const uint32_t (&u)[G], uint32_t (&h)[G],
                                           uint32_t lut) {
  bool out = false;
  int i0[G], i1[G];
  if constexpr (LUT) {
#pragma unroll
    for (int g = 0; g < G; ++g) {
      i0[g] = lut_index(u[g] & 0xFFFF);
      i1[g] = lut_index(u[g] >> 16);
      out |= (i0[g] | i1[g]) < 0;
      h[g] = lut_u16(lut + 2 * max(i0[g], 0)) | lut_u16(lut + 2 * max(i1[g], 0)) << 16;
    }
    if (!__any_sync(0xffffffffu, out)) return;
  }
#pragma unroll
  for (int g = 0; g < G; ++g) {
    const float lo = __uint_as_float(u[g] << 16), hi = __uint_as_float(u[g] & 0xFFFF0000u);
    const uint32_t f = pack_bf16(gelu_exact(lo), gelu_exact(hi));
    if constexpr (!LUT) {
      h[g] = f;
    } else {
      if (i0[g] < 0) h[g] = (h[g] & 0xFFFF0000u) | (f & 0xFFFF);
      if (i1[g] < 0) h[g] = (h[g] & 0xFFFF) | (f & 0xFFFF0000u);
    }
  }
}

// fast_epilogue's pass 2: gelu_pass2 over the buffer at shared address buf,
// four chunks loaded before any is computed or stored
template <int N, bool LUT>
__device__ __forceinline__ void gelu_pass2_fast(uint32_t buf, int i, int stride, uint32_t lut) {
  static_assert(N % 4 == 0, "chunks in fours");
#pragma unroll 1
  for (int k0 = 0; k0 < N; k0 += 4) {
    uint32_t a[16], h[16];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const uint4 v = lds128(buf + 16 * (stride * (k0 + u) + i));
      a[4 * u] = v.x;
      a[4 * u + 1] = v.y;
      a[4 * u + 2] = v.z;
      a[4 * u + 3] = v.w;
    }
    gelu_group<16, LUT>(a, h, lut);
#pragma unroll
    for (int u = 0; u < 4; ++u)
      sts128(buf + 16 * (stride * (k0 + u) + i),
             make_uint4(h[4 * u], h[4 * u + 1], h[4 * u + 2], h[4 * u + 3]));
  }
}

// The epilogue of consumer cw on its share of a tile (tl.row0 is its first
// row). Thread t holds, for half hf < L::H, j < 16 and h < 2, the pair
// acc[hf][4j + 2h], acc[hf][4j + 2h + 1] at row 64 hf + 16 (t / 32) +
// t % 32 / 4 + 8h of its share and columns 8j + 2 (t % 4) + {0, 1}.
// `bufp` is the consumer's tile buffer (`buf` its shared-memory address);
// out_c is the result's map, out_d F1's a (stored when store_d) or B1's a
// (loaded by the producer).
template <int EPI, class L>
__device__ __forceinline__ void epilogue(float (&acc)[L::H][64], const RowIn& in,
                                         const GemmArgs& p, const Tile& tl,
                                         unsigned char* bufp, uint32_t buf, uint32_t aux_full,
                                         uint32_t aux_empty, uint32_t aux_parity,
                                         const CUtensorMap* out_c, const CUtensorMap* out_d,
                                         bool lone = false) {
  const int t = threadIdx.x % 128, cw = threadIdx.x / 128;
  const bool leader = t == 0;
  const int r0 = 16 * (t / 32) + (t % 32) / 4, c0 = 2 * (t % 4);
  if constexpr (EPI == EPI_STATS) {
    static_assert(L::COOP && L::H == 2 && (L::BUFS == 0 || L::HALFBUF),
                  "K7 and K9 run on 256-row cooperative tiles, K7's with half buffers");
    stats_epilogue<L::BUFS != 0>(acc, in, p, tl, buf, out_c);
    return;
  } else if constexpr (EPI == EPI_DLOGITS) {
    dlogits_epilogue(acc, in, p, tl, buf, out_c);
    return;
  }
  if (EPI == EPI_OUT && p.partial != nullptr) {
    // a split K walk: fp32 partial sums straight to global memory
    const size_t part = static_cast<size_t>(tl.split) * p.M * p.Ncols;
#pragma unroll
    for (int hf = 0; hf < L::H; ++hf)
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
  // the bias pairs, all loaded before pass 1's first store (the stores
  // might alias them for all the compiler knows, which would hold each
  // load back behind the stores before it); H 1 had them loaded before its
  // main loop (bias_inputs)
  float2 bias[BN / 8];
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    if constexpr (L::H == 1 && (EPI == EPI_GELU || EPI == EPI_OUT)) {
      bias[j] = in.bias[j];
    } else {
      bias[j] = make_float2(0.f, 0.f);
      if (p.bias != nullptr && tl.col0 + c0 + 8 * j < p.Ncols)
        bias[j] = *reinterpret_cast<const float2*>(p.bias + tl.col0 + c0 + 8 * j);
    }
  }
  // pass 1, from the registers: a (F1), y or dx, or da (from a, in place)
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int col = c0 + 8 * j;
    const float2 b = bias[j];
#pragma unroll
    for (int hf = 0; hf < L::H; ++hf)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        __nv_bfloat162* pair = reinterpret_cast<__nv_bfloat162*>(
            bufp + tile_offset<L::BOX_BYTES>(64 * hf + r0 + 8 * h, col));
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
    if (p.store_d) store_tile<L::BOX_BYTES>(out_d, buf, tl);
    if (lone) {
      // the other consumer has no tile: it takes every other 128 chunks of
      // pass 2 (gemm_tiles), between these two barriers
      bar_sync(5, 256);  // pass 1 is in the buffer (and the store of a has read it)
      gelu_pass2<L::TILE_BYTES / 16 / 256>(bufp, t, 256);
      bar_sync(6, 256);
    } else {
      bar_sync(3 + cw, 128);  // pass 1 is in the buffer (and the store of a has read it)
      gelu_pass2<L::TILE_BYTES / 16 / 128>(bufp, t);
    }
  }
  store_tile<L::BOX_BYTES>(out_c, buf, tl);
  if (EPI == EPI_DGELU && leader) mbar_arrive(aux_empty);  // the buffer may take the next a tile
}

// The FAST layouts' epilogue of EPI_GELU and EPI_DGELU (epilogue's
// function, bit for bit). Every access to the tile buffer (at shared
// address buf) is a shared-space load or store by address, and each pass
// loads what it reads before it stores: with generic pointers the compiler
// cannot tell a load from the store before it, and ran the buffer one
// element pair (DGELU) or chunk (GELU's pass 2) at a time, each waiting on
// its load. DGELU loads eight a pairs, then computes and stores them;
// GELU's pass 2 goes in fours of 16-byte chunks.
template <int EPI, class L>
__device__ __forceinline__ void fast_epilogue(float (&acc)[L::H][64], const GemmArgs& p,
                                              const Tile& tl, uint32_t buf, uint32_t aux_full,
                                              uint32_t aux_empty, uint32_t aux_parity,
                                              const CUtensorMap* out_c, const CUtensorMap* out_d,
                                              bool lone, uint32_t lut) {
  static_assert(EPI == EPI_GELU || EPI == EPI_DGELU, "FAST: the first GEMMs' epilogues");
  static_assert(!L::LUT || EPI == EPI_GELU, "the table holds gelu");
  const int t = threadIdx.x % 128, cw = threadIdx.x / 128;
  const int r0 = 16 * (t / 32) + (t % 32) / 4, c0 = 2 * (t % 4);
  if constexpr (EPI == EPI_DGELU) {
    mbar_wait(aux_full, aux_parity);  // the a tile is in the buffer
    // eight pairs at a time: their a, their gelu'(a), then their stores
#pragma unroll
    for (int hf = 0; hf < L::H; ++hf)
#pragma unroll
      for (int j0 = 0; j0 < BN / 8; j0 += 4) {
        uint32_t u[8];
        float2 d[8];
#pragma unroll
        for (int g = 0; g < 8; ++g)
          u[g] = lds32(buf + tile_offset<L::BOX_BYTES>(64 * hf + r0 + 8 * (g % 2), c0 + 8 * (j0 + g / 2)));
#pragma unroll
        for (int g = 0; g < 8; ++g)
          d[g] = make_float2(dgelu_exact(__uint_as_float(u[g] << 16)),
                             dgelu_exact(__uint_as_float(u[g] & 0xFFFF0000u)));
#pragma unroll
        for (int g = 0; g < 8; ++g) {
          const int j = j0 + g / 2, h = g % 2;
          sts32(buf + tile_offset<L::BOX_BYTES>(64 * hf + r0 + 8 * h, c0 + 8 * j),
                pack_bf16(acc[hf][4 * j + 2 * h] * d[g].x, acc[hf][4 * j + 2 * h + 1] * d[g].y));
        }
      }
  } else {
    bar_sync(3 + cw, 128);  // the leader's last store has read the buffer
    float2 bias[BN / 8];
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      bias[j] = make_float2(0.f, 0.f);
      if (p.bias != nullptr && tl.col0 + c0 + 8 * j < p.Ncols)
        bias[j] = __ldg(reinterpret_cast<const float2*>(p.bias + tl.col0 + c0 + 8 * j));
    }
    // pass 1: a = bf16(acc + b1)
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int hf = 0; hf < L::H; ++hf)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          sts32(buf + tile_offset<L::BOX_BYTES>(64 * hf + r0 + 8 * h, c0 + 8 * j),
                pack_bf16(acc[hf][4 * j + 2 * h] + bias[j].x,
                          acc[hf][4 * j + 2 * h + 1] + bias[j].y));
    if (p.store_d) store_tile<L::BOX_BYTES>(out_d, buf, tl);
    if (lone) {
      bar_sync(5, 256);  // pass 1 is in the buffer (and the store of a has read it)
      gelu_pass2_fast<L::TILE_BYTES / 16 / 256, L::LUT>(buf, t, 256, lut);
      bar_sync(6, 256);
    } else {
      bar_sync(3 + cw, 128);  // pass 1 is in the buffer (and the store of a has read it)
      gelu_pass2_fast<L::TILE_BYTES / 16 / 128, L::LUT>(buf, t, 128, lut);
    }
  }
  store_tile<L::BOX_BYTES>(out_c, buf, tl);
  if (EPI == EPI_DGELU && t == 0) mbar_arrive(aux_empty);  // the buffer may take the next a tile
}

// MODE_CLUSTER, after the cluster barrier that follows every CTA's parts:
// CTA `rank` of the cluster sums the rows [rank band, (rank + 1) band) of
// the tile (band = ceil(TILE_ROWS / CTAs)) over the p.splits <= MAX_CLUSTER
// parts (gemm_launch refuses more) in the cluster's shared memories (part q
// in CTA q / ppc at `part` + (q % ppc) PART_BYTES, rows PART_PITCH bytes
// apart), in part order from 0, then adds the bias
// and rounds once, as finalize_sum does; 16 bytes of a row a thread, the
// 256 consumer threads together. (Pushing each part's rows to the CTA that
// sums them instead, by 8-byte remote stores from the registers, measured
// slower on an H100 than the local stores and this pull together.)
template <class L>
__device__ __forceinline__ void cluster_reduce(const GemmArgs& p, const Tile& tl, uint32_t part) {
  constexpr int Q = L::TILE_COLS / 4;  // 16-byte items a row
  const int S = p.splits;
  const int band = (L::TILE_ROWS + S / p.ppc - 1) / (S / p.ppc);
  const int r_lo = static_cast<int>(cluster_rank()) * band;
  const int items = max(0, min(L::TILE_ROWS, r_lo + band) - r_lo) * Q;
  // two items a thread at a time, every load of both issued before the
  // first sum needs one
  for (int i0 = threadIdx.x; i0 < items; i0 += 512) {
    float4 v[2][MAX_CLUSTER], b[2];
    int grow[2], gcol[2];
    bool live[2];
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int i = i0 + 256 * u;
      const int row = r_lo + i / Q, col = 4 * (i % Q);
      grow[u] = tl.row0 + row;
      gcol[u] = tl.col0 + col;
      // Ncols % 4 == 0: 4 columns are in or out whole
      live[u] = i < items && grow[u] < p.M && gcol[u] < p.Ncols;
      if (!live[u]) continue;
      const uint32_t off = part + row * L::PART_PITCH + col * 4;
#pragma unroll
      for (int r = 0; r < MAX_CLUSTER; ++r)
        if (r < S)
          v[u][r] = p.ppc == 2
                        ? ld_cluster_f4(map_to_rank(off + (r & 1) * L::PART_BYTES, r >> 1))
                        : ld_cluster_f4(map_to_rank(off, r));
      b[u] = p.bias != nullptr ? *reinterpret_cast<const float4*>(p.bias + gcol[u])
                               : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      if (!live[u]) continue;
      float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int r = 0; r < MAX_CLUSTER; ++r)
        if (r < S) {
          s.x += v[u][r].x;
          s.y += v[u][r].y;
          s.z += v[u][r].z;
          s.w += v[u][r].w;
        }
      if (p.bias != nullptr) {
        s.x += b[u].x;
        s.y += b[u].y;
        s.z += b[u].z;
        s.w += b[u].w;
      }
      const __nv_bfloat162 lo = __floats2bfloat162_rn(s.x, s.y);
      const __nv_bfloat162 hi = __floats2bfloat162_rn(s.z, s.w);
      uint2 packed;
      packed.x = *reinterpret_cast<const uint32_t*>(&lo);
      packed.y = *reinterpret_cast<const uint32_t*>(&hi);
      *reinterpret_cast<uint2*>(p.out + static_cast<size_t>(grow[u]) * p.Ncols + gcol[u]) =
          packed;
    }
  }
}

// out = A @ B over the block's tiles (A [M, K] K-major; B K-major [Ncols, K]
// or, B_MN, MN-major [K, Ncols]). q counts K slices through the ring, over
// all the block's tiles in order: slice q sits in stage q % STAGES, in that
// stage's (q / STAGES)-th round. ROWS_FIRST picks the tile order (tile_at),
// L the tiles and the depth walk (Layout).
template <int EPI, bool B_MN, bool ROWS_FIRST = false, class L = Legacy>
__device__ __forceinline__ void gemm_tiles(const CUtensorMap* tma_a, const CUtensorMap* tma_b,
                                           const CUtensorMap* out_c, const CUtensorMap* out_d,
                                           const GemmArgs& p) {
  constexpr int NST = L::STAGES;
  static_assert(!L::DEPENDENT || !B_MN, "a dependent's early B slices are K-major");
  extern __shared__ unsigned char smem_raw[];
  // 128-byte swizzled TMA boxes want 1024-byte aligned shared memory
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  const uint32_t base = smem_u32(smem);
  const uint32_t bufs = base + NST * L::STAGE_BYTES;   // consumer cw's buffer at bufs + cw*TILE
  const uint32_t full0 = bufs + L::BUFS * L::TILE_BYTES;  // full[s] at full0 + 8s
  const uint32_t empty0 = full0 + 8 * NST;             // empty[s] at empty0 + 8s
  const uint32_t aux_full0 = empty0 + 8 * NST;         // aux_full[cw] at aux_full0 + 8cw
  const uint32_t aux_empty0 = aux_full0 + 16;          // aux_empty[cw] at aux_empty0 + 8cw
  // LUT: the epilogue's table, after the barriers (16-byte aligned)
  const uint32_t lut = full0 + 8 * L::NBARS;
  const int tiles = tile_count<L>(p);

  if (threadIdx.x == 0) {
    for (int s = 0; s < NST; ++s) {
      mbar_init(full0 + 8 * s, 1);                   // the producer's arrive, plus the bytes
      mbar_init(empty0 + 8 * s, L::EMPTY_ARRIVES);   // one arrive from each consumer warp
    }
    for (int c = 0; c < 2; ++c) {
      mbar_init(aux_full0 + 8 * c, 1);
      mbar_init(aux_empty0 + 8 * c, 1);  // the consumer's leader
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    launch_dependents();  // a dependent's blocks wait for this grid's end before reading it
  }
  __syncthreads();
  // EPI_GELU with at most one tile a block: consumer 1 has none, and takes
  // half of consumer 0's pass 2
  const bool lone = EPI == EPI_GELU && !L::SHARED && tiles <= static_cast<int>(gridDim.x);

  if (threadIdx.x >= 256) {
    // producer warpgroup: one thread keeps the ring full
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    if (threadIdx.x == 256) {
      // DEPENDENT: the first tile's first B slices (a weight) load while the
      // kernel before this one still runs; A only after it has ended
      uint32_t early = 0;
      if constexpr (L::DEPENDENT) {
        if (static_cast<int>(blockIdx.x) < tiles) {
          const Tile tl = tile_at<ROWS_FIRST, L>(blockIdx.x, p);
          early = min(NST, tl.nk);
          for (uint32_t j = 0; j < early; ++j) {
            mbar_expect_tx(full0 + 8 * j, L::STAGE_BYTES);
#pragma unroll
            for (int c = 0; c < L::TILE_COLS / BN; ++c)
              tma_load(base + j * L::STAGE_BYTES + L::A_BYTES + c * B_BYTES, tma_b, full0 + 8 * j,
                       (tl.kb + j) * BK, tl.col0 + c * BN);
          }
        }
        wait_prior_grid();
      }
      uint32_t q = 0;
      int i = 0;
      for (int t = blockIdx.x; t < tiles; t += gridDim.x, ++i) {
        const Tile tl = tile_at<ROWS_FIRST, L>(t, p);
        for (int k = tl.kb; k < tl.kb + tl.nk; ++k, ++q) {
          const uint32_t stage = q % NST;
          const uint32_t full = full0 + 8 * stage;
          const uint32_t a_s = base + stage * L::STAGE_BYTES, b_s = a_s + L::A_BYTES;
          if (q < early) {  // its B is on the way, its bytes expected
            tma_load(a_s, tma_a, full, k * BK, tl.row0);
            continue;
          }
          mbar_wait(empty0 + 8 * stage, ((q / NST) & 1) ^ 1);  // round 0 finds it free
          mbar_expect_tx(full, L::STAGE_BYTES);
          tma_load(a_s, tma_a, full, k * BK, tl.row0);
          if (B_MN) {
#pragma unroll
            for (int j = 0; j < BN / 64; ++j)
              tma_load(b_s + j * BK * 128, tma_b, full, tl.col0 + 64 * j, k * BK);
          } else {
#pragma unroll
            for (int c = 0; c < L::TILE_COLS / BN; ++c)
              tma_load(b_s + c * B_BYTES, tma_b, full, k * BK, tl.col0 + c * BN);
          }
        }
        if (EPI == EPI_DGELU) {
          // the tile's a, into its consumer's buffer once that has been stored
          const int cw = i & 1;
          mbar_wait(aux_empty0 + 8 * cw, ((i >> 1) & 1) ^ 1);
          const uint32_t full = aux_full0 + 8 * cw, buf = bufs + cw * L::TILE_BYTES;
          mbar_expect_tx(full, L::TILE_BYTES);
          tma_load(buf, out_d, full, tl.col0, tl.row0);
          tma_load(buf + L::BOX_BYTES, out_d, full, tl.col0 + 64, tl.row0);
        }
      }
    }
    if constexpr (L::MODE == MODE_CLUSTER) {
      cluster_sync();  // the cluster's parts are in shared memory
      cluster_sync();  // and have been summed: no CTA leaves while another reads it
    }
  } else {
    // consumer warpgroup cw: the block's tiles 2i + cw, or with COOP or
    // WIDE its share of every tile
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
    const int cw = threadIdx.x / 128;
    const bool lane0 = threadIdx.x % 32 == 0;
    const uint32_t buf = bufs + cw * L::TILE_BYTES;
    unsigned char* bufp = smem + NST * L::STAGE_BYTES + cw * L::TILE_BYTES;
    const uint32_t a_share = L::COOP ? cw * L::WG_ROWS * 128 : 0;  // its rows of an A slice
    const uint32_t b_share = L::WIDE ? cw * B_BYTES : 0;            // its columns of a B slice
    uint32_t q = 0;
    int i = 0;
    Tile tl;
    // LUT: consumer 1 fills the table while consumer 0 runs the first main
    // loop, and lets it pass named barrier 7 before its first epilogue
    bool lut_ready = !L::LUT || cw == 1;
    if constexpr (L::LUT) {
      if (cw == 1) {
        lut_build(smem + (lut - base), threadIdx.x % 128);
        bar_sync(4, 128);  // the whole table, for consumer 1's own epilogues
        bar_arrive(7, 256);
      }
    }
    for (int t = blockIdx.x; t < tiles; t += gridDim.x, ++i) {
      tl = tile_at<ROWS_FIRST, L>(t, p);
      if (!L::SHARED && (i & 1) != cw) {  // the other warpgroup's tile: skip its slices
        q += tl.nk;
        continue;
      }
      // A parity wait is unambiguous only within one round of the ring, so a
      // warpgroup starts its main loop once the other has passed every wait
      // of the tile before (the ping-pong order: main loops in turn, each
      // epilogue beside the other warpgroup's main loop). With COOP or
      // WIDE both take every slice, and the empty barriers wait for both.
      if (!L::SHARED && i > 0) bar_sync(1 + cw, 256);
      Tile te = tl;  // the consumer's share of the tile
      te.row0 += L::COOP ? cw * L::WG_ROWS : 0;
      te.col0 += L::WIDE ? cw * BN : 0;
      RowIn in;
      if constexpr (EPI == EPI_STATS || EPI == EPI_DLOGITS) in = row_inputs<EPI>(p, te);
      if constexpr (L::H == 1 && L::MODE != MODE_CLUSTER && (EPI == EPI_GELU || EPI == EPI_OUT))
        in = bias_inputs(p, te);
      float acc[L::H][64];
      // MODE_SUM: the parts so far; MODE_CLUSTER with two parts: the first
      float sum[L::MODE == MODE_PLAIN ? 1 : L::H][64];
#pragma unroll
      for (int hf = 0; hf < L::H; ++hf)
#pragma unroll
        for (int j = 0; j < 64; ++j) acc[hf][j] = 0.f;
#pragma unroll
      for (int hf = 0; hf < L::H; ++hf) fence_acc(acc[hf]);
      if constexpr (L::MODE == MODE_SUM) {
#pragma unroll
        for (int j = 0; j < 64; ++j) sum[0][j] = 0.f;
      }
      for (int it = 0; it < tl.nk; ++it, ++q) {
        const uint32_t stage = q % NST;
        mbar_wait(full0 + 8 * stage, (q / NST) & 1);
        const uint32_t a_s = base + stage * L::STAGE_BYTES + a_share;
        const uint32_t b_s = base + stage * L::STAGE_BYTES + L::A_BYTES + b_share;
        asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk) {
          const uint64_t db = B_MN ? sw128_desc(b_s + 2048 * kk, BK * 128, 1024)
                                   : sw128_desc(b_s + 32 * kk, 16, 1024);
#pragma unroll
          for (int hf = 0; hf < L::H; ++hf)
            wgmma_m64n128k16<B_MN ? 1 : 0>(acc[hf],
                                           sw128_desc(a_s + 8192 * hf + 32 * kk, 16, 1024), db);
        }
        asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
        // the slice before this one is read: hand its stage back to the producer
        asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
        if (it > 0 && lane0) mbar_arrive(empty0 + 8 * ((q - 1) % NST));
        if constexpr (L::MODE != MODE_PLAIN) {
          if ((it + 1) % p.kper == 0 && it + 1 < tl.nk) {
            // a part ends: add it to the sum (or keep it), and start the
            // next from zero
            asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
            fence_acc(acc[0]);
#pragma unroll
            for (int j = 0; j < 64; ++j) {
              if constexpr (L::MODE == MODE_SUM) sum[0][j] += acc[0][j];
              else sum[0][j] = acc[0][j];
              acc[0][j] = 0.f;
            }
            fence_acc(acc[0]);
          }
        }
      }
      if (!L::SHARED && t + gridDim.x < tiles) bar_arrive(2 - cw, 256);  // the next tile, the other's, may go
      asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
      if (lane0) mbar_arrive(empty0 + 8 * ((q - 1) % NST));
#pragma unroll
      for (int hf = 0; hf < L::H; ++hf) fence_acc(acc[hf]);
      if constexpr (L::MODE == MODE_SUM) {
#pragma unroll
        for (int j = 0; j < 64; ++j) sum[0][j] += acc[0][j];
        epilogue<EPI, L>(sum, in, p, te, bufp, buf, aux_full0 + 8 * cw, aux_empty0 + 8 * cw,
                         (i >> 1) & 1, out_c, out_d);
      } else if constexpr (L::MODE == MODE_CLUSTER) {
        // the parts into this CTA's shared memory, over the ring once both
        // consumers are done reading it (unless SHARED consumer 1 has no
        // tile): the first (kept) and the last
        if constexpr (L::SHARED) bar_sync(1, 256);
        const int tt = threadIdx.x % 128;
        const int r0 = 16 * (tt / 32) + (tt % 32) / 4, c0 = 2 * (tt % 4);
        const bool two = tl.nk > p.kper;
#pragma unroll
        for (int j = 0; j < BN / 8; ++j)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            float2* at = reinterpret_cast<float2*>(
                smem + (te.row0 - tl.row0 + r0 + 8 * h) * L::PART_PITCH +
                (te.col0 - tl.col0 + c0 + 8 * j) * 4);
            const float2 last = make_float2(acc[0][4 * j + 2 * h], acc[0][4 * j + 2 * h + 1]);
            if (two) {
              *at = make_float2(sum[0][4 * j + 2 * h], sum[0][4 * j + 2 * h + 1]);
              at[L::PART_BYTES / 8] = last;
            } else {
              *at = last;
            }
          }
      } else {
        if (!lut_ready) {
          bar_sync(7, 256);
          lut_ready = true;
        }
        if constexpr (L::FAST)
          fast_epilogue<EPI, L>(acc, p, te, buf, aux_full0 + 8 * cw, aux_empty0 + 8 * cw,
                                (i >> 1) & 1, out_c, out_d, lone, lut);
        else
          epilogue<EPI, L>(acc, in, p, te, bufp, buf, aux_full0 + 8 * cw, aux_empty0 + 8 * cw,
                           (i >> 1) & 1, out_c, out_d, lone);
      }
    }
    if (!lut_ready) bar_sync(7, 256);  // consumer 0 had no tile
    if (lone && cw == 1 && static_cast<int>(blockIdx.x) < tiles) {
      // no tile of its own: half of consumer 0's pass 2 (epilogue)
      bar_sync(5, 256);
      if constexpr (L::FAST)
        gelu_pass2_fast<L::TILE_BYTES / 16 / 256, L::LUT>(bufs, 128 + threadIdx.x % 128, 256, lut);
      else
        gelu_pass2<L::TILE_BYTES / 16 / 256>(smem + NST * L::STAGE_BYTES,
                                             128 + threadIdx.x % 128, 256);
      fence_async_smem();  // its writes, before consumer 0's TMA store reads them
      bar_sync(6, 256);
    }
    if (threadIdx.x % 128 == 0) tma_store_wait_all();
    if constexpr (L::MODE == MODE_CLUSTER) {
      cluster_sync();
      cluster_reduce<L>(p, tl, base);
      cluster_sync();
    }
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

// A bf16 tensor map's shape: rank 2 or 3, the sizes innermost first, the
// byte pitches of dimensions 1 and 2, the box, and the swizzle of the box
// in shared memory. TMA zero-fills reads past the sizes and clips writes
// there.
struct MapShape {
  int rank;
  long long dims[3], pitch[2];
  int box[3], swizzle;
  bool operator==(const MapShape& o) const {
    return rank == o.rank && dims[0] == o.dims[0] && dims[1] == o.dims[1] &&
           dims[2] == o.dims[2] && pitch[0] == o.pitch[0] && pitch[1] == o.pitch[1] &&
           box[0] == o.box[0] && box[1] == o.box[1] && box[2] == o.box[2] &&
           swizzle == o.swizzle;
  }
};

// a bf16 row-major [outer, inner] tensor with a row pitch of ld elements
// (ld * 2 a multiple of 16 bytes), read or written in boxes of [box_outer,
// box_inner], swizzled in 128-byte rows unless `swizzle` says otherwise
inline MapShape rows_shape(int inner, int outer, int ld, int box_inner, int box_outer,
                           CUtensorMapSwizzle swizzle = CU_TENSOR_MAP_SWIZZLE_128B) {
  return {2, {inner, outer, 1}, {static_cast<long long>(ld) * 2, 0},
          {box_inner, box_outer, 1}, static_cast<int>(swizzle)};
}

inline cudaError_t make_map(CUtensorMap* map, const void* ptr, const MapShape& s) {
  const EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return cudaErrorSymbolNotFound;
  cuuint64_t dims[3], strides[2];
  cuuint32_t box[3];
  const cuuint32_t elem_strides[3] = {1, 1, 1};
  for (int i = 0; i < 3; ++i) {
    dims[i] = static_cast<cuuint64_t>(s.dims[i]);
    box[i] = static_cast<cuuint32_t>(s.box[i]);
  }
  for (int i = 0; i < 2; ++i) strides[i] = static_cast<cuuint64_t>(s.pitch[i]);
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, s.rank, const_cast<void*>(ptr),
                            dims, strides, box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            static_cast<CUtensorMapSwizzle>(s.swizzle),
                            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// The maps a launch needs, kept per host thread (no lock; ctypes calls
// may come from several threads) in a direct-mapped table. The key is every
// input of the encoding (address, shape) and the device; a map holds those
// and nothing of the memory's contents or owner, so a hit is exactly the
// map a fresh encoding would give. That is what keeps a freed or moved
// tensor from meeting a stale map: a moved weight has another address,
// hence another key, and a tensor allocated where a freed one was, with the
// same sizes and pitch, is described by the freed one's map correctly.
// Nothing is ever invalidated; a collision re-encodes.
constexpr int MAP_CACHE = 256;

inline cudaError_t cached_map(CUtensorMap* map, const void* ptr, const MapShape& shape,
                              int device) {
  struct Entry {
    CUtensorMap map;
    const void* ptr;
    MapShape shape;
    int device;
    bool used;
  };
  static thread_local Entry table[MAP_CACHE];
  uint64_t h = reinterpret_cast<uintptr_t>(ptr) >> 4;
  for (const long long v : {static_cast<long long>(shape.rank), shape.dims[0], shape.dims[1],
                            shape.dims[2], shape.pitch[0], shape.pitch[1],
                            static_cast<long long>(shape.box[0]),
                            static_cast<long long>(shape.box[1]),
                            static_cast<long long>(shape.box[2]),
                            static_cast<long long>(shape.swizzle),
                            static_cast<long long>(device)})
    h = (h ^ static_cast<uint64_t>(v)) * 0x100000001B3ull;
  Entry& e = table[(h ^ (h >> 29)) % MAP_CACHE];
  if (e.used && e.ptr == ptr && e.shape == shape && e.device == device) {
    *map = e.map;
    return cudaSuccess;
  }
  const cudaError_t err = make_map(map, ptr, shape);
  if (err == cudaSuccess) {
    e.map = *map;
    e.ptr = ptr;
    e.shape = shape;
    e.device = device;
    e.used = true;
  }
  return err;
}

// the map of a row-major [outer, inner] tensor (rows_shape)
inline cudaError_t cached_map(CUtensorMap* map, const void* ptr, int inner, int outer, int ld,
                              int box_inner, int box_outer, int device,
                              CUtensorMapSwizzle swizzle = CU_TENSOR_MAP_SWIZZLE_128B) {
  return cached_map(map, ptr, rows_shape(inner, outer, ld, box_inner, box_outer, swizzle),
                    device);
}

typedef void (*GemmKernel)(const CUtensorMap, const CUtensorMap, const CUtensorMap,
                           const CUtensorMap, const GemmArgs);

// C = A @ B on `kernel`, an includer's __global__ wrapper of gemm_tiles<EPI,
// B_MN, ROWS_FIRST, L>; `configured` holds a bit per device whose kernel
// attributes are set. A [M, K] K-major with row pitch lda; B = W [Ncols, K]
// (K-major) or W [K, Ncols] (b_mn); C bf16 [M, ldc] (ldc 0: Ncols), or null
// when the epilogue stores nothing (EPI_STATS on a layout without buffers, MODE_CLUSTER,
// which stores through p.out); D bf16 [M, Ncols] (D: F1's a out or B1's a
// in, or null). C's map spans its whole row, so an epilogue writes the
// columns [Ncols, ldc) of the last tile as well. p.splits > 1 walks K in
// parts of p.kper slices: into p.partial (MODE_PLAIN), summed in the tile
// (MODE_SUM), or on a cluster of p.splits / p.ppc CTAs a tile, p.ppc parts
// each (MODE_CLUSTER: ctas must be the tiles times the cluster's CTAs). A
// L::DEPENDENT kernel is launched as a programmatic dependent of the kernel
// before it on the stream.
template <class L = Legacy>
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
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               L::SMEM_BYTES);
    if (err != cudaSuccess) return err;
    if (device < 32) configured |= 1u << device;
  }
  CUtensorMap ta, tb, tc = {}, td = {};  // a null C or D gets no map: nothing reads it
  err = cached_map(&ta, A, K, p.M, lda, BK, L::TILE_ROWS, device);
  if (err == cudaSuccess)
    err = b_mn ? cached_map(&tb, W, p.Ncols, K, p.Ncols, 64, BK, device)
               : cached_map(&tb, W, K, p.Ncols, K, BK, BN, device);
  if (ldc <= 0) ldc = p.Ncols;
  if (err == cudaSuccess && C != nullptr)
    err = cached_map(&tc, C, ldc, p.M, ldc, 64, L::WG_ROWS, device);
  if (err == cudaSuccess && D != nullptr)
    err = cached_map(&td, D, p.Ncols, p.M, p.Ncols, 64, L::WG_ROWS, device);
  if (err != cudaSuccess) return err;
  p.ksteps = (K + BK - 1) / BK;
  if (p.splits == 1) p.kper = p.ksteps;
  cudaLaunchAttribute attr[2];
  unsigned nattr = 0;
  if constexpr (L::MODE == MODE_CLUSTER) {
    const int tiles = ((p.Ncols + L::TILE_COLS - 1) / L::TILE_COLS) *
                      ((p.M + L::TILE_ROWS - 1) / L::TILE_ROWS);
    if (p.ppc < 1 || p.ppc > 2 || p.splits % p.ppc != 0 || p.splits > MAX_CLUSTER ||
        ctas != tiles * (p.splits / p.ppc) || p.out == nullptr ||
        (p.splits - 1) * p.kper >= p.ksteps || p.splits * p.kper < p.ksteps)
      return cudaErrorInvalidValue;
    attr[nattr].id = cudaLaunchAttributeClusterDimension;
    attr[nattr].val.clusterDim.x = p.splits / p.ppc;
    attr[nattr].val.clusterDim.y = 1;
    attr[nattr].val.clusterDim.z = 1;
    ++nattr;
  }
  if constexpr (L::DEPENDENT) {
    attr[nattr].id = cudaLaunchAttributeProgrammaticStreamSerialization;
    attr[nattr].val.programmaticStreamSerializationAllowed = 1;
    ++nattr;
  }
  if (nattr == 0) {
    kernel<<<ctas, THREADS, L::SMEM_BYTES, s>>>(ta, tb, tc, td, p);
  } else {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(ctas);
    cfg.blockDim = dim3(THREADS);
    cfg.dynamicSmemBytes = L::SMEM_BYTES;
    cfg.stream = s;
    cfg.attrs = attr;
    cfg.numAttrs = nattr;
    err = cudaLaunchKernelEx(&cfg, kernel, ta, tb, tc, td, p);
    if (err != cudaSuccess) return err;
  }
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
