// K1 and K1b at head_dim 64 in bf16 on Hopper's own machinery: persistent
// blocks, a producer warp that keeps the next (b, h) pairs' head slices in
// flight by TMA, and consumer warpgroups that run the products on wgmma.
// Shared by train_attention_wg.cu (the forward) and train_attention_wg_bwd.cu
// (the backward), each built by its own nvcc; what they compute, what bounds
// them and why they are built so: train_attention_wg.cu's source note.
#pragma once

#include <cuda.h>

#include "train_attention_tc.cuh"
#include "wgmma_gemm.cuh"

namespace kmb_taw {

using kmb_ta::bf16;
using kmb_wg::smem_u32;
using kmb_wg::sw128_desc;

constexpr int kHd = 64;                      // head_dim the kernels take
constexpr int kMaxLen = 128;                 // Tq, Tk they take
constexpr int kStages = 2;                   // the ring of pairs in shared memory
constexpr int kRowBytes = kHd * 2;           // one head row: one 128-byte swizzle row
constexpr int kTileBytes = 64 * kRowBytes;   // a 64-row tile, 8 KB
constexpr int kSmemMax = 232448;             // what a block may use on an H100

__host__ __device__ constexpr int round_up(int n, int m) { return (n + m - 1) / m * m; }

// The carve-up of a block's shared memory, in bytes from its 1024-aligned
// base (ops/train_attention.py _geometry mirrors it; the launch refuses a
// plan whose bytes differ). A stage holds one pair's tiles, 128 bytes a
// row, rows past Tq and Tk TMA's zero fill; the key biases of the stages
// follow the stages, then the backward's P and dS tiles, then its output
// staging tiles (one a consumer), then the barriers.
// - Forward: Q at Tq rounded to 16 rows, K and V at Tk rounded to 16. A
//   64-row wgmma A tile of Q reads past those rows on into K and V: rows
//   whose output is not stored, each output row depending on its own A row
//   only; the stage is at least 64-row tiles long, so those reads stay in
//   it. A query tile's output is staged in its own Q rows once its
//   products have read them (the stage returns to the producer after the
//   stores have read it).
// - Backward: Q and G at Tq rounded to 64 rows (the zero rows past Tq are
//   the depth of dK = dS^T Q and dV = P^T G), K and V as the forward's; P
//   and dS at Tq rounded to 64 rows by Tk rounded to 64 columns, in blocks
//   of 64 columns; an 8 KB dQ staging tile a consumer.
struct Geometry {
  int rq, rk, rk64, cw;
  int q_off, g_off, k_off, v_off, stage_bytes, bias_off;
  int pblk, p_off, ds_off, out_off, bar_off, total;
};

__host__ __device__ inline Geometry geometry(int Tq, int Tk, bool backward) {
  Geometry g{};
  g.rq = round_up(Tq, backward ? 64 : 16);
  g.rk = round_up(Tk, 16);
  g.rk64 = round_up(Tk, 64);
  // the backward splits a pair's query tiles, then its key tiles, between
  // two consumers when there are two of either
  g.cw = backward && (g.rq > 64 || g.rk64 > 64) ? 2 : 1;
  g.q_off = 0;
  g.g_off = g.rq * kRowBytes;
  g.k_off = (backward ? 2 : 1) * g.rq * kRowBytes;
  g.v_off = g.k_off + g.rk * kRowBytes;
  g.stage_bytes = g.v_off + g.rk * kRowBytes;
  if (g.stage_bytes < round_up(Tq, 64) * kRowBytes) g.stage_bytes = round_up(Tq, 64) * kRowBytes;
  int off = kStages * g.stage_bytes;
  g.bias_off = off;
  off += kStages * g.rk * 4;
  off = round_up(off, 1024);
  g.pblk = g.rq * kRowBytes;
  g.p_off = off;
  if (backward) off += (g.rk64 / 64) * g.pblk;
  g.ds_off = off;
  if (backward) off += (g.rk64 / 64) * g.pblk;
  g.out_off = off;
  if (backward) off += g.cw * kTileBytes;
  g.bar_off = off;
  off += 2 * kStages * 8;
  g.total = off + 1024;  // room to align the base to 1024 bytes
  return g;
}

// the launch's scalars; the pair p is (b, h) = (p / H, p % H)
struct Args {
  const int64_t* mask;
  int Tq, Tk, H, causal, pairs;
  float scale, scale_dq;
};

// ---------------------------------------------------------------------------
// TMA over a [B, T, D] bf16 tensor whose rows lie ld elements apart: boxes
// of one head (64 columns, one 128-byte swizzle row) by `rows` rows of one
// batch row, so reads past T are zero and writes past T are clipped

__device__ __forceinline__ void tma_load3(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                          int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

__device__ __forceinline__ void tma_store3(const CUtensorMap* map, uint32_t src, int c0, int c1,
                                           int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group [%0, {%2, %3, %4}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

inline cudaError_t make_map3(CUtensorMap* map, const void* ptr, int D, int T, int B, int ld,
                             int rows) {
  const kmb_wg::EncodeTiledFn encode = kmb_wg::encode_tiled();
  if (encode == nullptr) return cudaErrorSymbolNotFound;
  const cuuint64_t dims[3] = {(cuuint64_t)D, (cuuint64_t)T, (cuuint64_t)B};
  const cuuint64_t strides[2] = {(cuuint64_t)ld * 2, (cuuint64_t)T * ld * 2};
  const cuuint32_t box[3] = {(cuuint32_t)kHd, (cuuint32_t)rows, 1};
  const cuuint32_t elem_strides[3] = {1, 1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr),
                            dims, strides, box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// make_map3 through a per-host-thread table keyed by every input of the
// encoding, as kmb_wg::cached_map keeps its 2-D maps (a hit is exactly the
// map a fresh encoding would give; a collision re-encodes)
inline cudaError_t cached_map3(CUtensorMap* map, const void* ptr, int D, int T, int B, int ld,
                               int rows, int device) {
  struct Entry {
    CUtensorMap map;
    const void* ptr;
    int key[6];
    bool used;
  };
  constexpr int kEntries = 128;
  static thread_local Entry table[kEntries];
  const int key[6] = {D, T, B, ld, rows, device};
  uint64_t h = reinterpret_cast<uintptr_t>(ptr) >> 4;
  for (const int v : key) h = (h ^ static_cast<uint64_t>(v)) * 0x100000001B3ull;
  Entry& e = table[(h ^ (h >> 29)) % kEntries];
  bool hit = e.used && e.ptr == ptr;
  for (int i = 0; i < 6 && hit; ++i) hit = e.key[i] == key[i];
  if (hit) {
    *map = e.map;
    return cudaSuccess;
  }
  const cudaError_t err = make_map3(map, ptr, D, T, B, ld, rows);
  if (err == cudaSuccess) {
    e.map = *map;
    e.ptr = ptr;
    for (int i = 0; i < 6; ++i) e.key[i] = key[i];
    e.used = true;
  }
  return err;
}

// ---------------------------------------------------------------------------
// wgmma. Every accumulator is float d[N8][4]: a warp's 16 rows of the 64,
// n8 tile n in d[n], laid out as an mma.sync m16n8 accumulator fragment.

#define KMB_F4(d, n) "+f"(d[n][0]), "+f"(d[n][1]), "+f"(d[n][2]), "+f"(d[n][3])

// d[:, 8 N0 .. 8 N0 + 16) += A[64 x 16] B[16 x 16], both K-major in shared memory
template <int N0, int N8>
__device__ __forceinline__ void wg_ss16(float (&d)[N8][4], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p, 1, 1, 0, 0;\n}\n"
      : KMB_F4(d, N0), KMB_F4(d, N0 + 1)
      : "l"(da), "l"(db), "r"(1));
}

template <int N0, int N8>
__device__ __forceinline__ void wg_ss32(float (&d)[N8][4], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, 0, 0;\n}\n"
      : KMB_F4(d, N0), KMB_F4(d, N0 + 1), KMB_F4(d, N0 + 2), KMB_F4(d, N0 + 3)
      : "l"(da), "l"(db), "r"(1));
}

// N 64; TA, TB: A, B MN-major (the transposed operands of dK and dV)
template <int N0, int TA, int TB, int N8>
__device__ __forceinline__ void wg_ss64(float (&d)[N8][4], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, %35, %36;\n}\n"
      : KMB_F4(d, N0), KMB_F4(d, N0 + 1), KMB_F4(d, N0 + 2), KMB_F4(d, N0 + 3),
        KMB_F4(d, N0 + 4), KMB_F4(d, N0 + 5), KMB_F4(d, N0 + 6), KMB_F4(d, N0 + 7)
      : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
}

// d[64 x 64] += A[64 x 16] B[16 x 64]: A from registers (a warp's 16 rows as
// an mma.sync m16n8k16 A fragment), B MN-major in shared memory
__device__ __forceinline__ void wg_rs64(float (&d)[8][4], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : KMB_F4(d, 0), KMB_F4(d, 1), KMB_F4(d, 2), KMB_F4(d, 3), KMB_F4(d, 4), KMB_F4(d, 5),
        KMB_F4(d, 6), KMB_F4(d, 7)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

#undef KMB_F4

// S[:, 8 N0 ..) += A[64 x 16 at depth step kk] B^T over the keys from 8 N0
// on, in wgmma pieces of 64, 32 and 16 keys (N8 = 2 KC, so the pieces end
// exactly): a is the A tile's address, b the key rows' (K-major, 128-byte
// swizzled; 8 key rows are 1024 bytes)
template <int N0, int N8>
__device__ __forceinline__ void wg_rows(float (&d)[N8][4], uint32_t a, uint32_t b, int kk) {
  const uint64_t da = sw128_desc(a + 32 * kk, 16, 1024);
  const uint64_t db = sw128_desc(b + N0 * 1024 + 32 * kk, 16, 1024);
  if constexpr (N8 - N0 >= 8) {
    wg_ss64<N0, 0, 0>(d, da, db);
    if constexpr (N8 - N0 > 8) wg_rows<N0 + 8>(d, a, b, kk);
  } else if constexpr (N8 - N0 >= 4) {
    wg_ss32<N0>(d, da, db);
    if constexpr (N8 - N0 > 4) wg_rows<N0 + 4>(d, a, b, kk);
  } else {
    wg_ss16<N0>(d, da, db);
  }
}

template <int N8>
__device__ __forceinline__ void fence_acc(float (&d)[N8][4]) {
#pragma unroll
  for (int n = 0; n < N8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+f"(d[n][e])::"memory");
}

template <int N8>
__device__ __forceinline__ void zero_acc(float (&d)[N8][4]) {
#pragma unroll
  for (int n = 0; n < N8; ++n) d[n][0] = d[n][1] = d[n][2] = d[n][3] = 0.f;
}

__device__ __forceinline__ void wg_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>  // at most N committed groups still running
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
__device__ __forceinline__ void wg_commit_wait() {
  wg_commit();
  wg_wait<0>();
}

// byte offset of (row r, column c) in a 128-byte swizzled tile of 64-column
// rows (TMA's and wgmma's layout: 16-byte chunks permuted by r % 8)
__device__ __forceinline__ uint32_t sw_off(int r, int c) {
  return r * kRowBytes + ((((c >> 3) ^ r) & 7) << 4) + ((c & 7) << 1);
}

// a consumer warp's 16 rows of a 64 x 64 fp32 accumulator, times `scale`,
// rounded to bf16 into the swizzled tile at `tile` (rows 16 w ..)
__device__ __forceinline__ void put_tile(unsigned char* tile, const float (&d)[8][4], float scale,
                                         int w, int lane) {
  const int g = lane >> 2, t = lane & 3, r0 = 16 * w + g;
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    *reinterpret_cast<uint32_t*>(tile + sw_off(r0, 8 * n + 2 * t)) =
        kmb_ta::pack_bf16(d[n][0] * scale, d[n][1] * scale);
    *reinterpret_cast<uint32_t*>(tile + sw_off(r0 + 8, 8 * n + 2 * t)) =
        kmb_ta::pack_bf16(d[n][2] * scale, d[n][3] * scale);
  }
}

// ---------------------------------------------------------------------------
// the common frame: barriers, the producer warp, the pair schedule

__device__ __forceinline__ unsigned char* aligned_base(unsigned char* raw) {
  return reinterpret_cast<unsigned char*>((reinterpret_cast<uintptr_t>(raw) + 1023) &
                                          ~static_cast<uintptr_t>(1023));
}

// full[s] takes the producer's expect_tx arrive plus one arrive of each of
// its 32 lanes (after each wrote its share of the key bias); empty[s]
// `releases` arrives
__device__ __forceinline__ void init_barriers(uint32_t full0, uint32_t empty0, int releases) {
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      kmb_wg::mbar_init(full0 + 8 * s, 33);
      kmb_wg::mbar_init(empty0 + 8 * s, releases);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
}

// The producer warp: the block's pairs blockIdx.x, + gridDim.x, ... in
// order, pair n into stage n % kStages once the consumers have released the
// pair before it there. Lane 0 issues the copies (Q [and G] at rq rows, K
// and V at rk rows); every lane writes part of the pair's key bias.
template <bool BWD>
__device__ __forceinline__ void produce(const Geometry& geo, const Args& a, unsigned char* smem,
                                        uint32_t full0, uint32_t empty0, const CUtensorMap* mq,
                                        const CUtensorMap* mk, const CUtensorMap* mv,
                                        const CUtensorMap* mg) {
  const int lane = threadIdx.x % 32;
  const uint32_t base = smem_u32(smem);
  const uint32_t tx = (BWD ? 2 * geo.rq + 2 * geo.rk : geo.rq + 2 * geo.rk) * kRowBytes;
  int n = 0;
  for (int pr = blockIdx.x; pr < a.pairs; pr += gridDim.x, ++n) {
    const int s = n % kStages;
    if (n >= kStages) kmb_wg::mbar_wait(empty0 + 8 * s, (n / kStages - 1) & 1);
    const int b = pr / a.H, c = (pr % a.H) * kHd;
    const uint32_t st = base + s * geo.stage_bytes, full = full0 + 8 * s;
    if (lane == 0) {
      kmb_wg::mbar_expect_tx(full, tx);
      tma_load3(st + geo.q_off, mq, full, c, 0, b);
      tma_load3(st + geo.k_off, mk, full, c, 0, b);
      tma_load3(st + geo.v_off, mv, full, c, 0, b);
      if constexpr (BWD) tma_load3(st + geo.g_off, mg, full, c, 0, b);
    }
    float* bias = reinterpret_cast<float*>(smem + geo.bias_off) + s * geo.rk;
    for (int j = lane; j < geo.rk; j += 32)
      bias[j] = j < a.Tk ? kmb_ta::key_bias(a.mask, b, a.Tk, j) : 0.f;
    kmb_wg::mbar_arrive(full);
  }
}

// ---------------------------------------------------------------------------
// the row softmax on a warp's 16 rows of S in registers (rows i0 and i0 + 8
// of the pair): scale, key bias and masks, then p = exp(s - m) / l in
// place. As PR 4's kernels: the same masks
// (masked()), the same order of the row sums, the same division.
template <int N8>
__device__ __forceinline__ void softmax_rows(float (&s)[N8][4], const Args& a, const float* bias,
                                             int i0, int t) {
  const int i1 = i0 + 8;
  float m0 = -INFINITY, m1 = -INFINITY;
#pragma unroll
  for (int n = 0; n < N8; ++n) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int j = 8 * n + 2 * t + e;
      s[n][e] = kmb_ta::masked(s[n][e] * a.scale, i0, j, a.Tk, a.causal, bias);
      s[n][2 + e] = kmb_ta::masked(s[n][2 + e] * a.scale, i1, j, a.Tk, a.causal, bias);
      m0 = fmaxf(m0, s[n][e]);
      m1 = fmaxf(m1, s[n][2 + e]);
    }
  }
  m0 = kmb_ta::quad_max(m0);
  m1 = kmb_ta::quad_max(m1);
  float l0 = 0.f, l1 = 0.f;
#pragma unroll
  for (int n = 0; n < N8; ++n) {
    s[n][0] = expf(s[n][0] - m0);
    s[n][1] = expf(s[n][1] - m0);
    s[n][2] = expf(s[n][2] - m1);
    s[n][3] = expf(s[n][3] - m1);
    l0 += s[n][0] + s[n][1];
    l1 += s[n][2] + s[n][3];
  }
  l0 = kmb_ta::quad_sum(l0);
  l1 = kmb_ta::quad_sum(l1);
  const float y0 = __frcp_rn(l0), y1 = __frcp_rn(l1);
#pragma unroll
  for (int n = 0; n < N8; ++n) {
    s[n][0] = kmb_ta::div_by_sum(s[n][0], l0, y0);
    s[n][1] = kmb_ta::div_by_sum(s[n][1], l0, y0);
    s[n][2] = kmb_ta::div_by_sum(s[n][2], l1, y1);
    s[n][3] = kmb_ta::div_by_sum(s[n][3], l1, y1);
  }
}

// ---------------------------------------------------------------------------
// the forward: one consumer warpgroup (threads 0-127) walks the pair's
// 64-row query tiles; warp 4 produces. At most 128 registers a thread (the
// bound's 256 x 2), so that three blocks of five warps share an SM.

template <int KC>  // Tk <= 16 KC
__global__ void __launch_bounds__(256, 2)
attn_fwd_wg(const __grid_constant__ CUtensorMap mq, const __grid_constant__ CUtensorMap mk,
            const __grid_constant__ CUtensorMap mv, const __grid_constant__ CUtensorMap mo,
            const Args a) {
  constexpr int N8 = 2 * KC;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = aligned_base(smem_raw);
  const Geometry geo = geometry(a.Tq, a.Tk, false);
  const uint32_t base = smem_u32(smem);
  const uint32_t full0 = base + geo.bar_off, empty0 = full0 + 8 * kStages;
  init_barriers(full0, empty0, 1);  // thread 0, once the pair's stores have read the stage
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (warp == 4) {
    produce<false>(geo, a, smem, full0, empty0, &mq, &mk, &mv, nullptr);
    return;
  }
  const int g = lane >> 2, t = lane & 3;
  int n = 0;
  for (int pr = blockIdx.x; pr < a.pairs; pr += gridDim.x, ++n) {
    const int s = n % kStages;
    kmb_wg::mbar_wait(full0 + 8 * s, (n / kStages) & 1);
    const int b = pr / a.H, c = (pr % a.H) * kHd;
    const uint32_t st = base + s * geo.stage_bytes;
    const float* bias = reinterpret_cast<const float*>(smem + geo.bias_off) + s * geo.rk;
    for (int qt = 0; qt * 64 < a.Tq; ++qt) {
      const uint32_t tile = st + geo.q_off + qt * kTileBytes;
      // S = Q K^T over head_dim in four depth steps
      float sc[N8][4];
      zero_acc(sc);
      fence_acc(sc);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < kHd / 16; ++kk) wg_rows<0>(sc, tile, st + geo.k_off, kk);
      wg_commit_wait();
      fence_acc(sc);
      // a warp whose 16 rows all lie past Tq (the tail of a 64-row tile)
      // skips their softmax and stores: it only takes part in the products
      const bool live = qt * 64 + 16 * warp < a.Tq;
      // O = round(P) V, 16 keys a step; V MN-major, 16 key rows = 2048 bytes
      uint32_t pa[KC][4];
      if (live) {
        softmax_rows(sc, a, bias, qt * 64 + 16 * warp + g, t);
#pragma unroll
        for (int kc = 0; kc < KC; ++kc) {
          pa[kc][0] = kmb_ta::pack_bf16(sc[2 * kc][0], sc[2 * kc][1]);
          pa[kc][1] = kmb_ta::pack_bf16(sc[2 * kc][2], sc[2 * kc][3]);
          pa[kc][2] = kmb_ta::pack_bf16(sc[2 * kc + 1][0], sc[2 * kc + 1][1]);
          pa[kc][3] = kmb_ta::pack_bf16(sc[2 * kc + 1][2], sc[2 * kc + 1][3]);
        }
      } else {
#pragma unroll
        for (int kc = 0; kc < KC; ++kc) pa[kc][0] = pa[kc][1] = pa[kc][2] = pa[kc][3] = 0u;
      }
      float o[8][4];
      zero_acc(o);
      fence_acc(o);
      wg_fence();
#pragma unroll
      for (int kc = 0; kc < KC; ++kc)
        wg_rs64(o, pa[kc], sw128_desc(st + geo.v_off + 2048 * kc, kTileBytes, 1024));
      wg_commit_wait();
      fence_acc(o);
      // out through this tile's own Q rows, which nothing reads again
      if (live) put_tile(smem + (tile - base), o, 1.f, warp, lane);
      kmb_wg::fence_async_smem();
      kmb_wg::bar_sync(1, 128);
      if (threadIdx.x == 0) {
        tma_store3(&mo, tile, c, qt * 64, b);
        kmb_wg::tma_store_commit();
      }
    }
    if (threadIdx.x == 0) {
      kmb_wg::tma_store_wait_read();
      kmb_wg::mbar_arrive(empty0 + 8 * s);
    }
  }
  if (threadIdx.x == 0) kmb_wg::tma_store_wait_all();
}

// ---------------------------------------------------------------------------
// the backward: cw consumer warpgroups (threads 0 .. 128 cw - 1) split the
// pair's query tiles (S, dP, P, dS, dQ), meet, then split its key tiles (dK,
// dV from the P and dS tiles in shared memory); warp 4 cw produces

template <int KC>
__global__ void __launch_bounds__(288, 1)
attn_bwd_wg(const __grid_constant__ CUtensorMap mq, const __grid_constant__ CUtensorMap mk,
            const __grid_constant__ CUtensorMap mv, const __grid_constant__ CUtensorMap mg,
            const __grid_constant__ CUtensorMap mdq, const __grid_constant__ CUtensorMap mdk,
            const __grid_constant__ CUtensorMap mdv, const Args a) {
  constexpr int N8 = 2 * KC;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = aligned_base(smem_raw);
  const Geometry geo = geometry(a.Tq, a.Tk, true);
  const int cw = geo.cw;
  const uint32_t base = smem_u32(smem);
  const uint32_t full0 = base + geo.bar_off, empty0 = full0 + 8 * kStages;
  init_barriers(full0, empty0, 4 * cw);  // one arrive a consumer warp
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (warp == 4 * cw) {
    produce<true>(geo, a, smem, full0, empty0, &mq, &mk, &mv, &mg);
    return;
  }
  const int wg = warp / 4, w = warp % 4, tid = threadIdx.x % 128;
  const int g = lane >> 2, t = lane & 3;
  unsigned char* dq_s = smem + geo.out_off + wg * kTileBytes;
  const uint32_t p_a = base + geo.p_off, ds_a = base + geo.ds_off;
  const int kq = round_up(a.Tq, 16) / 16;  // 16-row steps of dK's and dV's depth
  int n = 0;
  for (int pr = blockIdx.x; pr < a.pairs; pr += gridDim.x, ++n) {
    const int s = n % kStages;
    kmb_wg::mbar_wait(full0 + 8 * s, (n / kStages) & 1);
    const int b = pr / a.H, c = (pr % a.H) * kHd;
    const uint32_t st = base + s * geo.stage_bytes;
    const float* bias = reinterpret_cast<const float*>(smem + geo.bias_off) + s * geo.rk;

    for (int qt = wg; qt * 64 < a.Tq; qt += cw) {
      // S = Q K^T and dP = G V^T for this query tile, two groups: the
      // softmax on S runs while dP's products do
      float sc[N8][4], dp[N8][4];
      zero_acc(sc);
      zero_acc(dp);
      fence_acc(sc);
      fence_acc(dp);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < kHd / 16; ++kk)
        wg_rows<0>(sc, st + geo.q_off + qt * kTileBytes, st + geo.k_off, kk);
      wg_commit();
#pragma unroll
      for (int kk = 0; kk < kHd / 16; ++kk)
        wg_rows<0>(dp, st + geo.g_off + qt * kTileBytes, st + geo.v_off, kk);
      wg_commit();
      wg_wait<1>();
      fence_acc(sc);
      const int i0 = qt * 64 + 16 * w + g;
      // a warp whose 16 rows all lie past Tq (and so past Tq rounded to 16,
      // the depth of dK and dV) skips their softmax, dS and stores: it
      // only takes part in the products
      const bool live = qt * 64 + 16 * w < a.Tq;
      if (live) softmax_rows(sc, a, bias, i0, t);  // sc holds P, unrounded
      wg_wait<0>();
      fence_acc(dp);
      // r = sum_j p dp (PR 4's order), then dS = round(P (dP - r)) in
      // registers, as dQ's A operand
      uint32_t da[KC][4];
      if (live) {
        float r0 = 0.f, r1 = 0.f;
#pragma unroll
        for (int nn = 0; nn < N8; ++nn) {
          r0 += sc[nn][0] * dp[nn][0] + sc[nn][1] * dp[nn][1];
          r1 += sc[nn][2] * dp[nn][2] + sc[nn][3] * dp[nn][3];
        }
        r0 = kmb_ta::quad_sum(r0);
        r1 = kmb_ta::quad_sum(r1);
#pragma unroll
        for (int nn = 0; nn < N8; ++nn) {
          da[nn / 2][(nn % 2) * 2] = kmb_ta::pack_bf16(sc[nn][0] * (dp[nn][0] - r0),
                                                       sc[nn][1] * (dp[nn][1] - r0));
          da[nn / 2][(nn % 2) * 2 + 1] = kmb_ta::pack_bf16(sc[nn][2] * (dp[nn][2] - r1),
                                                           sc[nn][3] * (dp[nn][3] - r1));
        }
      } else {
#pragma unroll
        for (int kc = 0; kc < KC; ++kc) da[kc][0] = da[kc][1] = da[kc][2] = da[kc][3] = 0u;
      }
      // dQ = dS K (K MN-major) runs while round(P) and dS go to their
      // shared tiles (rows i0, i0 + 8; key j in 64-column block j / 64)
      float o[8][4];
      zero_acc(o);
      fence_acc(o);
      wg_fence();
#pragma unroll
      for (int kc = 0; kc < KC; ++kc)
        wg_rs64(o, da[kc], sw128_desc(st + geo.k_off + 2048 * kc, kTileBytes, 1024));
      wg_commit();
      // the P and dS tiles are free once every consumer is past the last
      // pair's dK and dV products and their stores have read the tiles
      if (tid == 0) kmb_wg::tma_store_wait_read();
      kmb_wg::bar_sync(3, 128 * cw);
      if (live) {
#pragma unroll
        for (int nn = 0; nn < N8; ++nn) {
          const int blk = (nn / 8) * geo.pblk, col = 8 * (nn % 8) + 2 * t;
          *reinterpret_cast<uint32_t*>(smem + geo.p_off + blk + sw_off(i0, col)) =
              kmb_ta::pack_bf16(sc[nn][0], sc[nn][1]);
          *reinterpret_cast<uint32_t*>(smem + geo.p_off + blk + sw_off(i0 + 8, col)) =
              kmb_ta::pack_bf16(sc[nn][2], sc[nn][3]);
          *reinterpret_cast<uint32_t*>(smem + geo.ds_off + blk + sw_off(i0, col)) =
              da[nn / 2][(nn % 2) * 2];
          *reinterpret_cast<uint32_t*>(smem + geo.ds_off + blk + sw_off(i0 + 8, col)) =
              da[nn / 2][(nn % 2) * 2 + 1];
        }
      }
      wg_wait<0>();
      fence_acc(o);
      kmb_wg::bar_sync(1 + wg, 128);
      if (live) put_tile(dq_s, o, a.scale_dq, w, lane);
      kmb_wg::fence_async_smem();
      kmb_wg::bar_sync(1 + wg, 128);
      if (tid == 0) {
        tma_store3(&mdq, smem_u32(dq_s), c, qt * 64, b);
        kmb_wg::tma_store_commit();
      }
    }
    if (wg * 64 >= a.Tq) {  // no query tile here: meet the others at their P and dS stores
      if (tid == 0) kmb_wg::tma_store_wait_read();
      kmb_wg::bar_sync(3, 128 * cw);
    }
    // every query tile's P and dS written, visible to wgmma
    kmb_wg::fence_async_smem();
    kmb_wg::bar_sync(3, 128 * cw);

    for (int kt = wg; kt * 64 < a.Tk; kt += cw) {
      // dV = round(P)^T G and dK = dS^T Q over the query rows, 16 a step;
      // the P and dS tiles of key block kt are this consumer's alone
      const uint32_t pk = p_a + kt * geo.pblk, dk_a = ds_a + kt * geo.pblk;
      float dv[8][4], dk[8][4];
      zero_acc(dv);
      zero_acc(dk);
      fence_acc(dv);
      fence_acc(dk);
      wg_fence();
      for (int kc = 0; kc < kq; ++kc)
        wg_ss64<0, 1, 1>(dv, sw128_desc(pk + 2048 * kc, kTileBytes, 1024),
                         sw128_desc(st + geo.g_off + 2048 * kc, kTileBytes, 1024));
      wg_commit();
      for (int kc = 0; kc < kq; ++kc)
        wg_ss64<0, 1, 1>(dk, sw128_desc(dk_a + 2048 * kc, kTileBytes, 1024),
                         sw128_desc(st + geo.q_off + 2048 * kc, kTileBytes, 1024));
      wg_commit();
      // out through the consumer's own P and dS tiles once each is read:
      // dV staged while dK's products run
      wg_wait<1>();
      fence_acc(dv);
      put_tile(smem + geo.p_off + kt * geo.pblk, dv, 1.f, w, lane);
      wg_wait<0>();
      fence_acc(dk);
      put_tile(smem + geo.ds_off + kt * geo.pblk, dk, a.scale, w, lane);
      kmb_wg::fence_async_smem();
      kmb_wg::bar_sync(1 + wg, 128);
      if (tid == 0) {
        tma_store3(&mdv, pk, c, kt * 64, b);
        tma_store3(&mdk, dk_a, c, kt * 64, b);
        kmb_wg::tma_store_commit();
      }
    }
    // the stage is read (the P and dS tiles are freed in the next pair)
    __syncwarp();
    if (lane == 0) kmb_wg::mbar_arrive(empty0 + 8 * s);
  }
  if (tid == 0) kmb_wg::tma_store_wait_all();
}

// ---------------------------------------------------------------------------
// host side

#define KMB_TAW_KC_CASES(X) X(1) X(2) X(3) X(4) X(5) X(6) X(7) X(8)

typedef void (*FwdKernel)(const CUtensorMap, const CUtensorMap, const CUtensorMap,
                          const CUtensorMap, const Args);
typedef void (*BwdKernel)(const CUtensorMap, const CUtensorMap, const CUtensorMap,
                          const CUtensorMap, const CUtensorMap, const CUtensorMap,
                          const CUtensorMap, const Args);

// the kernels take head_dim 64, Tq, Tk in [1, 128], and causal only square
inline bool takes(int Tq, int Tk, int D, int H, int causal) {
  return H > 0 && D == H * kHd && Tq >= 1 && Tk >= 1 && Tq <= kMaxLen && Tk <= kMaxLen &&
         (!causal || Tq == Tk);
}

inline int threads(const Geometry& geo) { return 128 * geo.cw + 32; }

// Sets a kernel's shared-memory limit once per device (a bit per device in
// `configured`, one word per kernel), before its first launch or query
template <typename K>
inline cudaError_t configure(K kernel, unsigned& configured) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess || (device < 32 && (configured >> device & 1))) return err;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemMax);
  if (err == cudaSuccess && device < 32) configured |= 1u << device;
  return err;
}

// blocks of `kernel` an SM holds at this geometry (negative: a CUDA error)
template <typename K>
inline int resident(K kernel, unsigned& configured, const Geometry& geo) {
  cudaError_t err = configure(kernel, configured);
  int blocks = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, threads(geo), geo.total);
  return err == cudaSuccess ? blocks : -(int)err;
}

// the backward's blocks an SM (train_attention_wg_bwd.cu)
int bwd_resident(int Tq, int Tk);

}  // namespace kmb_taw
