// The bf16 tensor-core kernels of K1 and its backward, shared by the files
// that instantiate them (each built by its own nvcc, all at once):
// train_attention.cu (the forward, head_dim <= 64), train_attention_bwd.cu
// (the backward, head_dim <= 64) and train_attention_wide.cu (both, wider
// heads). What they compute and why they are built so: train_attention.cu's
// source note. The main path's shapes run train_attention_wg.cu's kernels;
// these take the rest (ops/train_attention.py plan).
#pragma once

#include "common.cuh"

namespace kmb_ta {

typedef __nv_bfloat16 bf16;

// ---------------------------------------------------------------------------
// bf16 tensor-core path

// head_dim % 8 == 0. A warp's output tiles hold 64 head_dim columns (a
// slab; every BART size has head_dim 64): a wider head loops over slabs,
// the products that feed a slab recomputed for each.
constexpr int kSlab = 64;
constexpr int kSlabC = kSlab / 16;  // 16-column chunks a slab
constexpr int kWarpsMax = 8;   // warps a block, one 16-row tile each at a time
// Two blocks of kWarpsMax warps an SM: at most 128 registers a thread. The
// kernels are latency-bound at these lengths, and the third resident block
// of 5-6 warps this allows (instead of two at 176 registers) made the
// backward faster, spills included (NVIDIA H100 80GB HBM3).
constexpr int kMinBlocks = 2;
// The forward's block shape by key bucket KC: up to 96 keys its score row
// takes at most 48 registers, so 112 a thread suffice (next to no spills)
// and three blocks of six warps share an SM, where 128 registers would
// allow two. That made the forward faster at the fine-tune and
// pretraining shapes (the generation encoder's stayed about even); longer
// rows, which need more registers, keep two blocks of eight warps.
__host__ __device__ constexpr int fwd_warps(int kc) { return kc <= 6 ? 6 : kWarpsMax; }
__host__ __device__ constexpr int fwd_blocks(int kc) { return kc <= 6 ? 3 : kMinBlocks; }

__host__ __device__ constexpr int round16(int n) { return (n + 15) / 16 * 16; }
__host__ __device__ constexpr int smem_ld(int hd) { return round16(hd) + 8; }
// head_dim columns of the slab that starts at 16-column chunk c0
__host__ __device__ constexpr int slab_width(int hd, int c0) {
  return hd - c0 * 16 < kSlab ? hd - c0 * 16 : kSlab;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)), "l"(src));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// four 8x8 b16 matrices; lane l gives the address of row l % 8 of matrix l / 8
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// c += a (16x16, row) * b (16x8, col), bf16 in, fp32 accumulate
__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // round to nearest even
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t scale_bf16x2(uint32_t x, float s) {
  const float2 f = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&x));
  return pack_bf16(f.x * s, f.y * s);
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// p = e / l rounded to nearest, the division's result, by Markstein's
// correction from y = 1/l rounded to nearest. With e in [0, 1] and l in
// [1, Tk] no step overflows; only a quotient already below the normal range
// could round otherwise. The division itself would leave its fast path (its
// range check) for each masked key's e = 0.
__device__ __forceinline__ float div_by_sum(float e, float l, float y) {
  const float q = e * y;
  return fmaf(fmaf(-l, q, e), y, q);
}

// the additive key bias of row b, key j from the 1-keep/0-pad key mask
// (none: every key kept)
__device__ __forceinline__ float key_bias(const int64_t* mask, int b, int Tk, int j) {
  return mask == nullptr || mask[(size_t)b * Tk + j] != 0 ? 0.f : KMB_NEG_INF;
}

// Fragment addresses inside a row-major shared tile with pitch ld, for the
// 16x16 block at (row0, col0):
// - A operand, or the B operand of a [k][n] tile through ldsm_x4_t (regs
//   {0, 1} are n-tile col0..+7, {2, 3} n-tile col0+8..+15);
__device__ __forceinline__ const bf16* frag_a(const bf16* s, int ld, int row0, int col0,
                                              int lane) {
  return s + (row0 + (lane & 15)) * ld + col0 + (lane >> 4) * 8;
}
// - B operand of an [n][k] tile (rows n, columns k) through ldsm_x4 (regs
//   {0, 1} are n-tile row0..+7, {2, 3} n-tile row0+8..+15).
__device__ __forceinline__ const bf16* frag_bt(const bf16* s, int ld, int row0, int col0,
                                               int lane) {
  return s + (row0 + (lane & 7) + (lane >> 4) * 8) * ld + col0 + ((lane >> 3) & 1) * 8;
}

// rows [0, rows) of a head's [rows, hd] slice at stride ldg into a shared
// [rows_p, ld] tile; pad rows and columns zero
__device__ __forceinline__ void stage_rows(bf16* dst, const bf16* src, int rows, int rows_p,
                                           int hd, int ld, int ldg) {
  const int chunks = round16(hd) / 8;  // 16-byte units a shared row
  for (int i = threadIdx.x; i < rows_p * chunks; i += blockDim.x) {
    const int r = i / chunks, c = i % chunks;
    bf16* d = dst + r * ld + c * 8;
    if (r < rows && c * 8 < hd)
      cp_async16(d, src + (size_t)r * ldg + c * 8);
    else
      *reinterpret_cast<uint4*>(d) = make_uint4(0, 0, 0, 0);
  }
}

// a warp's 16-row fp32 accumulator tile of one slab (its first hd columns
// valid) -> bf16 rows [row0, row0 + 16) of out (row pitch D, rows < rows
// only), through its shared staging tile
__device__ __forceinline__ void store_tile(const float (&acc)[kSlab / 8][4], float scale,
                                           bf16* stage, int ld, bf16* out, int row0, int rows,
                                           int D, int hd, int lane) {
  const int g = lane >> 2, t = lane & 3;
  __syncwarp();  // every lane is done reading the staging rows
#pragma unroll
  for (int n = 0; n < kSlab / 8; ++n) {
    if (n * 8 < hd) {
      *reinterpret_cast<uint32_t*>(stage + g * ld + n * 8 + 2 * t) =
          pack_bf16(acc[n][0] * scale, acc[n][1] * scale);
      *reinterpret_cast<uint32_t*>(stage + (g + 8) * ld + n * 8 + 2 * t) =
          pack_bf16(acc[n][2] * scale, acc[n][3] * scale);
    }
  }
  __syncwarp();
  const int chunks = hd / 8;
  for (int i = lane; i < 16 * chunks; i += 32) {
    const int r = i / chunks, c = i % chunks;
    if (row0 + r < rows)
      *reinterpret_cast<uint4*>(out + (size_t)(row0 + r) * D + c * 8) =
          *reinterpret_cast<const uint4*>(stage + r * ld + c * 8);
  }
  __syncwarp();
}

// the score of query i, key j: no such key (ragged tile) -> -inf; causal
// mask -> -1e9 (the reference's value, so a fully masked row stays what the
// reference gives); else the product plus the key bias
__device__ __forceinline__ float masked(float s, int i, int j, int Tk, int causal,
                                        const float* bias_s) {
  if (j >= Tk) return -INFINITY;
  if (causal && j > i) return KMB_NEG_INF;
  return s + bias_s[j];
}

// the score row in registers: Tk <= 16 * KC; WIDE: head_dim > 64, several
// slabs (else one, and the slab loops fold away at compile time)
template <int KC, bool WIDE>
__global__ void __launch_bounds__(fwd_warps(KC) * 32, fwd_blocks(KC))
attn_fwd_tc(const bf16* __restrict__ q, const bf16* __restrict__ k,
            const bf16* __restrict__ v, const int64_t* __restrict__ mask,
            bf16* __restrict__ out, int Tq, int Tk, int H, int hd, int ldq, int ldk, int ldv,
            int causal, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int h = blockIdx.x, b = blockIdx.y;
  const int D = H * hd, ld = smem_ld(hd);
  const int tqp = round16(Tq), tkp = round16(Tk);
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);  // [tqp][ld]; also the output staging
  bf16* k_s = q_s + tqp * ld;                      // [tkp][ld]
  bf16* v_s = k_s + tkp * ld;                      // [tkp][ld]
  float* bias_s = reinterpret_cast<float*>(v_s + tkp * ld);  // [tkp]

  stage_rows(q_s, q + (size_t)b * Tq * ldq + h * hd, Tq, tqp, hd, ld, ldq);
  stage_rows(k_s, k + (size_t)b * Tk * ldk + h * hd, Tk, tkp, hd, ld, ldk);
  stage_rows(v_s, v + (size_t)b * Tk * ldv + h * hd, Tk, tkp, hd, ld, ldv);
  for (int j = threadIdx.x; j < tkp; j += blockDim.x)
    bias_s[j] = j < Tk ? key_bias(mask, b, Tk, j) : -INFINITY;
  cp_async_wait_all();
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int nkc = tkp / 16, nhc = round16(hd) / 16;
  const int c_end = WIDE ? nhc : 1;  // slab loops: c0 = 0, kSlabC, ... < c_end
  bf16* out_bh = out + (size_t)b * Tq * D + h * hd;

  for (int r0 = warp * 16; r0 < tqp; r0 += (blockDim.x / 32) * 16) {
    // S = qs K^T: rows r0 + g (regs 0, 1) and r0 + g + 8 (regs 2, 3)
    float s[KC][2][4];
#pragma unroll
    for (int kc = 0; kc < KC; ++kc)
#pragma unroll
      for (int e = 0; e < 8; ++e) s[kc][e / 4][e % 4] = 0.f;
    for (int c0 = 0; c0 < c_end; c0 += kSlabC) {
      uint32_t qa[kSlabC][4];  // the slab's qs fragments, held across the keys
#pragma unroll
      for (int c = 0; c < kSlabC; ++c) {
        if (c0 + c < nhc) {
          ldsm_x4(qa[c], frag_a(q_s, ld, r0, (c0 + c) * 16, lane));
#pragma unroll
          for (int e = 0; e < 4; ++e) qa[c][e] = scale_bf16x2(qa[c][e], scale);
        }
      }
#pragma unroll
      for (int kc = 0; kc < KC; ++kc) {
        if (kc < nkc) {
#pragma unroll
          for (int c = 0; c < kSlabC; ++c) {
            if (c0 + c < nhc) {
              uint32_t kb[4];
              ldsm_x4(kb, frag_bt(k_s, ld, kc * 16, (c0 + c) * 16, lane));
              mma16816(s[kc][0], qa[c], kb[0], kb[1]);
              mma16816(s[kc][1], qa[c], kb[2], kb[3]);
            }
          }
        }
      }
    }

    const int i0 = r0 + g, i1 = r0 + g + 8;
    float m0 = -INFINITY, m1 = -INFINITY;
#pragma unroll
    for (int kc = 0; kc < KC; ++kc) {
      if (kc < nkc) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int j = kc * 16 + (e / 2) * 8 + 2 * t + (e % 2);
          s[kc][e / 2][e % 2] = masked(s[kc][e / 2][e % 2], i0, j, Tk, causal, bias_s);
          s[kc][e / 2][2 + e % 2] = masked(s[kc][e / 2][2 + e % 2], i1, j, Tk, causal, bias_s);
          m0 = fmaxf(m0, s[kc][e / 2][e % 2]);
          m1 = fmaxf(m1, s[kc][e / 2][2 + e % 2]);
        }
      }
    }
    m0 = quad_max(m0);
    m1 = quad_max(m1);
    float l0 = 0.f, l1 = 0.f;
#pragma unroll
    for (int kc = 0; kc < KC; ++kc) {
      if (kc < nkc) {
#pragma unroll
        for (int n = 0; n < 2; ++n) {
          s[kc][n][0] = expf(s[kc][n][0] - m0);
          s[kc][n][1] = expf(s[kc][n][1] - m0);
          s[kc][n][2] = expf(s[kc][n][2] - m1);
          s[kc][n][3] = expf(s[kc][n][3] - m1);
          l0 += s[kc][n][0] + s[kc][n][1];
          l1 += s[kc][n][2] + s[kc][n][3];
        }
      }
    }
    l0 = quad_sum(l0);
    l1 = quad_sum(l1);
    const float y0 = __frcp_rn(l0), y1 = __frcp_rn(l1);

    // O = round(P) V, a slab at a time: the score accumulators of a 16-key
    // chunk are the A fragment of that chunk
    for (int c0 = 0; c0 < c_end; c0 += kSlabC) {
      float o[kSlab / 8][4];
#pragma unroll
      for (int n = 0; n < kSlab / 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
#pragma unroll
      for (int kc = 0; kc < KC; ++kc) {
        if (kc < nkc) {
          const uint32_t pa[4] = {
              pack_bf16(div_by_sum(s[kc][0][0], l0, y0), div_by_sum(s[kc][0][1], l0, y0)),
              pack_bf16(div_by_sum(s[kc][0][2], l1, y1), div_by_sum(s[kc][0][3], l1, y1)),
              pack_bf16(div_by_sum(s[kc][1][0], l0, y0), div_by_sum(s[kc][1][1], l0, y0)),
              pack_bf16(div_by_sum(s[kc][1][2], l1, y1), div_by_sum(s[kc][1][3], l1, y1))};
#pragma unroll
          for (int c = 0; c < kSlabC; ++c) {
            if (c0 + c < nhc) {
              uint32_t vb[4];
              ldsm_x4_t(vb, frag_a(v_s, ld, kc * 16, (c0 + c) * 16, lane));
              mma16816(o[2 * c], pa, vb[0], vb[1]);
              mma16816(o[2 * c + 1], pa, vb[2], vb[3]);
            }
          }
        }
      }
      // this warp's q rows are no longer read: stage the output there
      store_tile(o, 1.f, q_s + r0 * ld + c0 * 16, ld, out_bh + c0 * 16, r0, Tq, D,
                 slab_width(hd, c0), lane);
    }
  }
}

// shared memory of the bf16 forward: q, k, v tiles and the key bias
inline size_t fwd_tc_smem_bytes(int Tq, int Tk, int hd) {
  const size_t ld = smem_ld(hd), tqp = round16(Tq), tkp = round16(Tk);
  return sizeof(bf16) * ld * (tqp + 2 * tkp) + sizeof(float) * tkp;
}

// shared memory of the bf16 backward: q (scaled), g, k, v tiles, a staging
// tile a warp, then m, l, 1/l, r a query row and the key bias
inline size_t bwd_tc_smem_bytes(int Tq, int Tk, int hd, int warps) {
  const size_t ld = smem_ld(hd), tqp = round16(Tq), tkp = round16(Tk);
  return sizeof(bf16) * ld * (2 * tqp + 2 * tkp + 16 * (size_t)warps) +
         sizeof(float) * (4 * tqp + tkp);
}

// warps a block: one a 16-row tile, at most cap (the others loop)
inline int tc_warps(int rows_p, int cap = kWarpsMax) {
  const int tiles = rows_p / 16;
  return tiles < cap ? tiles : cap;
}

template <int KC, bool WIDE>  // as attn_fwd_tc's
__global__ void __launch_bounds__(kWarpsMax * 32, kMinBlocks)
attn_bwd_tc(const bf16* __restrict__ q, const bf16* __restrict__ k,
            const bf16* __restrict__ v, const int64_t* __restrict__ mask,
            const bf16* __restrict__ gr, bf16* __restrict__ dq, bf16* __restrict__ dk,
            bf16* __restrict__ dv, int Tq, int Tk, int H, int hd, int ldq, int ldk, int ldv,
            int causal, float scale_q, float scale_dq) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int h = blockIdx.x, b = blockIdx.y;
  const int D = H * hd, ld = smem_ld(hd);
  const int tqp = round16(Tq), tkp = round16(Tk);
  const int warps = blockDim.x / 32;
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);  // [tqp][ld], q * scale_q rounded
  bf16* g_s = q_s + tqp * ld;                      // [tqp][ld]
  bf16* k_s = g_s + tqp * ld;                      // [tkp][ld]
  bf16* v_s = k_s + tkp * ld;                      // [tkp][ld]
  bf16* st_s = v_s + tkp * ld;                     // [warps][16][ld] output staging
  float* m_s = reinterpret_cast<float*>(st_s + warps * 16 * ld);  // [tqp]
  float* l_s = m_s + tqp;
  float* y_s = l_s + tqp;                          // 1/l rounded to nearest
  float* r_s = y_s + tqp;
  float* bias_s = r_s + tqp;                       // [tkp]

  stage_rows(q_s, q + (size_t)b * Tq * ldq + h * hd, Tq, tqp, hd, ld, ldq);
  stage_rows(g_s, gr + (size_t)b * Tq * D + h * hd, Tq, tqp, hd, ld, D);
  stage_rows(k_s, k + (size_t)b * Tk * ldk + h * hd, Tk, tkp, hd, ld, ldk);
  stage_rows(v_s, v + (size_t)b * Tk * ldv + h * hd, Tk, tkp, hd, ld, ldv);
  for (int j = threadIdx.x; j < tkp; j += blockDim.x)
    bias_s[j] = j < Tk ? key_bias(mask, b, Tk, j) : -INFINITY;
  cp_async_wait_all();
  __syncthreads();
  const int hdp = round16(hd);
  for (int i = threadIdx.x; i < tqp * hdp / 2; i += blockDim.x) {
    uint32_t* p = reinterpret_cast<uint32_t*>(q_s + (i / (hdp / 2)) * ld) + i % (hdp / 2);
    *p = scale_bf16x2(*p, scale_q);
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int nkc = tkp / 16, nqc = tqp / 16, nhc = hdp / 16;
  const int c_end = WIDE ? nhc : 1;
  bf16* stage = st_s + warp * 16 * ld;

  // pass 1: a warp per 16 query rows -> m, l, r and dq
  for (int r0 = warp * 16; r0 < tqp; r0 += warps * 16) {
    float p[KC][2][4];
#pragma unroll
    for (int kc = 0; kc < KC; ++kc) {
#pragma unroll
      for (int e = 0; e < 8; ++e) p[kc][e / 4][e % 4] = 0.f;
      if (kc < nkc) {
        for (int c0 = 0; c0 < c_end; c0 += kSlabC) {
#pragma unroll
          for (int cc = 0; cc < kSlabC; ++cc) {
            const int c = c0 + cc;
            if (c < nhc) {
              uint32_t kb[4], a[4];
              ldsm_x4(a, frag_a(q_s, ld, r0, c * 16, lane));
              ldsm_x4(kb, frag_bt(k_s, ld, kc * 16, c * 16, lane));
              mma16816(p[kc][0], a, kb[0], kb[1]);
              mma16816(p[kc][1], a, kb[2], kb[3]);
            }
          }
        }
      }
    }
    const int i0 = r0 + g, i1 = r0 + g + 8;
    float m0 = -INFINITY, m1 = -INFINITY;
#pragma unroll
    for (int kc = 0; kc < KC; ++kc) {
      if (kc < nkc) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int j = kc * 16 + (e / 2) * 8 + 2 * t + (e % 2);
          p[kc][e / 2][e % 2] = masked(p[kc][e / 2][e % 2], i0, j, Tk, causal, bias_s);
          p[kc][e / 2][2 + e % 2] = masked(p[kc][e / 2][2 + e % 2], i1, j, Tk, causal, bias_s);
          m0 = fmaxf(m0, p[kc][e / 2][e % 2]);
          m1 = fmaxf(m1, p[kc][e / 2][2 + e % 2]);
        }
      }
    }
    m0 = quad_max(m0);
    m1 = quad_max(m1);
    float l0 = 0.f, l1 = 0.f;
#pragma unroll
    for (int kc = 0; kc < KC; ++kc) {
      if (kc < nkc) {
#pragma unroll
        for (int n = 0; n < 2; ++n) {
          p[kc][n][0] = expf(p[kc][n][0] - m0);
          p[kc][n][1] = expf(p[kc][n][1] - m0);
          p[kc][n][2] = expf(p[kc][n][2] - m1);
          p[kc][n][3] = expf(p[kc][n][3] - m1);
          l0 += p[kc][n][0] + p[kc][n][1];
          l1 += p[kc][n][2] + p[kc][n][3];
        }
      }
    }
    l0 = quad_sum(l0);
    l1 = quad_sum(l1);
    const float y0 = __frcp_rn(l0), y1 = __frcp_rn(l1);
#pragma unroll
    for (int kc = 0; kc < KC; ++kc) {
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        p[kc][n][0] = div_by_sum(p[kc][n][0], l0, y0);
        p[kc][n][1] = div_by_sum(p[kc][n][1], l0, y0);
        p[kc][n][2] = div_by_sum(p[kc][n][2], l1, y1);
        p[kc][n][3] = div_by_sum(p[kc][n][3], l1, y1);
      }
    }

    // dP = G V^T for one 16-key chunk (recomputed by both sweeps below: the
    // same instructions, so the same bits)
    auto dp_chunk = [&](int kc, float (&dp)[2][4]) {
#pragma unroll
      for (int e = 0; e < 8; ++e) dp[e / 4][e % 4] = 0.f;
      for (int c0 = 0; c0 < c_end; c0 += kSlabC) {
#pragma unroll
        for (int cc = 0; cc < kSlabC; ++cc) {
          const int c = c0 + cc;
          if (c < nhc) {
            uint32_t vb[4], a[4];
            ldsm_x4(a, frag_a(g_s, ld, r0, c * 16, lane));
            ldsm_x4(vb, frag_bt(v_s, ld, kc * 16, c * 16, lane));
            mma16816(dp[0], a, vb[0], vb[1]);
            mma16816(dp[1], a, vb[2], vb[3]);
          }
        }
      }
    };
    float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
    for (int kc = 0; kc < KC; ++kc) {
      if (kc < nkc) {
        float dp[2][4];
        dp_chunk(kc, dp);
#pragma unroll
        for (int n = 0; n < 2; ++n) {
          rs0 += p[kc][n][0] * dp[n][0] + p[kc][n][1] * dp[n][1];
          rs1 += p[kc][n][2] * dp[n][2] + p[kc][n][3] * dp[n][3];
        }
      }
    }
    rs0 = quad_sum(rs0);
    rs1 = quad_sum(rs1);

    if (t == 0) {
      m_s[i0] = m0, l_s[i0] = l0, y_s[i0] = y0, r_s[i0] = rs0;
      m_s[i1] = m1, l_s[i1] = l1, y_s[i1] = y1, r_s[i1] = rs1;
    }
    for (int c0 = 0; c0 < c_end; c0 += kSlabC) {
      float acc[kSlab / 8][4];
#pragma unroll
      for (int n = 0; n < kSlab / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
#pragma unroll
      for (int kc = 0; kc < KC; ++kc) {
        if (kc < nkc) {
          float dp[2][4];
          dp_chunk(kc, dp);
          const uint32_t da[4] = {
              pack_bf16(p[kc][0][0] * (dp[0][0] - rs0), p[kc][0][1] * (dp[0][1] - rs0)),
              pack_bf16(p[kc][0][2] * (dp[0][2] - rs1), p[kc][0][3] * (dp[0][3] - rs1)),
              pack_bf16(p[kc][1][0] * (dp[1][0] - rs0), p[kc][1][1] * (dp[1][1] - rs0)),
              pack_bf16(p[kc][1][2] * (dp[1][2] - rs1), p[kc][1][3] * (dp[1][3] - rs1))};
#pragma unroll
          for (int c = 0; c < kSlabC; ++c) {
            if (c0 + c < nhc) {
              uint32_t kb[4];
              ldsm_x4_t(kb, frag_a(k_s, ld, kc * 16, (c0 + c) * 16, lane));
              mma16816(acc[2 * c], da, kb[0], kb[1]);
              mma16816(acc[2 * c + 1], da, kb[2], kb[3]);
            }
          }
        }
      }
      store_tile(acc, scale_dq, stage + c0 * 16, ld,
                 dq + (size_t)b * Tq * D + h * hd + c0 * 16, r0, Tq, D, slab_width(hd, c0),
                 lane);
    }
  }
  __syncthreads();

  // pass 2: a warp per 16 key rows -> dk, dv a slab at a time, walking 16
  // queries at a time
  for (int j0 = warp * 16; j0 < tkp; j0 += warps * 16) {
    const int j_lo = j0 + g, j_hi = j0 + g + 8;  // key rows of regs {0, 1} and {2, 3}
    for (int c0 = 0; c0 < c_end; c0 += kSlabC) {
      float dka[kSlab / 8][4], dva[kSlab / 8][4];
#pragma unroll
      for (int n = 0; n < kSlab / 8; ++n) {
        dka[n][0] = dka[n][1] = dka[n][2] = dka[n][3] = 0.f;
        dva[n][0] = dva[n][1] = dva[n][2] = dva[n][3] = 0.f;
      }
      for (int qc = 0; qc < nqc; ++qc) {
        float sT[2][4], dpT[2][4];
#pragma unroll
        for (int e = 0; e < 8; ++e) sT[e / 4][e % 4] = dpT[e / 4][e % 4] = 0.f;
        for (int c1 = 0; c1 < c_end; c1 += kSlabC) {
#pragma unroll
          for (int cc = 0; cc < kSlabC; ++cc) {
            const int c = c1 + cc;
            if (c < nhc) {
              uint32_t qb[4], gb[4], a[4], b[4];
              ldsm_x4(a, frag_a(k_s, ld, j0, c * 16, lane));
              ldsm_x4(b, frag_a(v_s, ld, j0, c * 16, lane));
              ldsm_x4(qb, frag_bt(q_s, ld, qc * 16, c * 16, lane));
              ldsm_x4(gb, frag_bt(g_s, ld, qc * 16, c * 16, lane));
              mma16816(sT[0], a, qb[0], qb[1]);
              mma16816(sT[1], a, qb[2], qb[3]);
              mma16816(dpT[0], b, gb[0], gb[1]);
              mma16816(dpT[1], b, gb[2], gb[3]);
            }
          }
        }
        float ds[2][4], pr[2][4];
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const int n = e / 4, x = e % 4;
          const int i = qc * 16 + n * 8 + 2 * t + (x % 2);
          const int j = x < 2 ? j_lo : j_hi;
          const float pij = div_by_sum(
              expf(masked(sT[n][x], i, j, Tk, causal, bias_s) - m_s[i]), l_s[i], y_s[i]);
          ds[n][x] = pij * (dpT[n][x] - r_s[i]);
          pr[n][x] = pij;
        }
        const uint32_t da[4] = {pack_bf16(ds[0][0], ds[0][1]), pack_bf16(ds[0][2], ds[0][3]),
                                pack_bf16(ds[1][0], ds[1][1]), pack_bf16(ds[1][2], ds[1][3])};
        const uint32_t pa[4] = {pack_bf16(pr[0][0], pr[0][1]), pack_bf16(pr[0][2], pr[0][3]),
                                pack_bf16(pr[1][0], pr[1][1]), pack_bf16(pr[1][2], pr[1][3])};
#pragma unroll
        for (int c = 0; c < kSlabC; ++c) {
          if (c0 + c < nhc) {
            uint32_t qb[4], gb[4];
            ldsm_x4_t(qb, frag_a(q_s, ld, qc * 16, (c0 + c) * 16, lane));
            ldsm_x4_t(gb, frag_a(g_s, ld, qc * 16, (c0 + c) * 16, lane));
            mma16816(dka[2 * c], da, qb[0], qb[1]);
            mma16816(dka[2 * c + 1], da, qb[2], qb[3]);
            mma16816(dva[2 * c], pa, gb[0], gb[1]);
            mma16816(dva[2 * c + 1], pa, gb[2], gb[3]);
          }
        }
      }
      const int w = slab_width(hd, c0);
      store_tile(dka, 1.f, stage + c0 * 16, ld, dk + (size_t)b * Tk * D + h * hd + c0 * 16, j0,
                 Tk, D, w, lane);
      store_tile(dva, 1.f, stage + c0 * 16, ld, dv + (size_t)b * Tk * D + h * hd + c0 * 16, j0,
                 Tk, D, w, lane);
    }
  }
}

// the register bound KC of a key length: the smallest of these >= Tk / 16
constexpr int kKcBuckets[] = {2, 3, 4, 5, 6, 8, 12, 16};

inline int kc_bucket(int Tk) {
  const int need = (Tk + 15) / 16;
  for (int kc : kKcBuckets)
    if (need <= kc) return kc;
  return -1;
}

#define KMB_KC_CASES(LAUNCH) \
  LAUNCH(2) LAUNCH(3) LAUNCH(4) LAUNCH(5) LAUNCH(6) LAUNCH(8) LAUNCH(12) LAUNCH(16)

// A head wider than one slab (off the main path) takes one instantiation,
// KC 16 for every key length, so the build does not double for it.
constexpr int kKcWide = 16;

// the operands of a launch (strides in elements)
struct FwdArgs {
  const bf16 *q, *k, *v;
  const int64_t* mask;
  bf16* out;
  int B, Tq, Tk, H, hd, ldq, ldk, ldv, causal;
  float scale;
};

struct BwdArgs {
  const bf16 *q, *k, *v;
  const int64_t* mask;
  const bf16* g;
  bf16 *dq, *dk, *dv;
  int B, Tq, Tk, H, hd, ldq, ldk, ldv, causal;
  float scale_q, scale_dq;
};

template <int KC, bool WIDE>
cudaError_t launch_fwd_kc(const FwdArgs& a, cudaStream_t stream) {
  const size_t smem = fwd_tc_smem_bytes(a.Tq, a.Tk, a.hd);
  const cudaError_t err = kmb_allow_smem(attn_fwd_tc<KC, WIDE>, smem);
  if (err != cudaSuccess) return err;
  attn_fwd_tc<KC, WIDE><<<dim3(a.H, a.B), 32 * tc_warps(round16(a.Tq), fwd_warps(KC)), smem,
                          stream>>>(a.q, a.k, a.v, a.mask, a.out, a.Tq, a.Tk, a.H, a.hd, a.ldq,
                                    a.ldk, a.ldv, a.causal, a.scale);
  return cudaGetLastError();
}

inline int bwd_warps(int Tq, int Tk) { return tc_warps(round16(Tq > Tk ? Tq : Tk)); }

template <int KC, bool WIDE>
cudaError_t launch_bwd_kc(const BwdArgs& a, cudaStream_t stream) {
  const int warps = bwd_warps(a.Tq, a.Tk);
  const size_t smem = bwd_tc_smem_bytes(a.Tq, a.Tk, a.hd, warps);
  const cudaError_t err = kmb_allow_smem(attn_bwd_tc<KC, WIDE>, smem);
  if (err != cudaSuccess) return err;
  attn_bwd_tc<KC, WIDE><<<dim3(a.H, a.B), 32 * warps, smem, stream>>>(
      a.q, a.k, a.v, a.mask, a.g, a.dq, a.dk, a.dv, a.Tq, a.Tk, a.H, a.hd, a.ldq, a.ldk, a.ldv,
      a.causal, a.scale_q, a.scale_dq);
  return cudaGetLastError();
}

// head_dim <= 64 by key bucket, else the wide instantiation
cudaError_t launch_fwd_tc(const FwdArgs& a, cudaStream_t stream);  // train_attention.cu
cudaError_t launch_bwd_tc(const BwdArgs& a, cudaStream_t stream);  // train_attention_bwd.cu
cudaError_t launch_fwd_tc_wide(const FwdArgs& a, cudaStream_t stream);  // train_attention_wide.cu
cudaError_t launch_bwd_tc_wide(const BwdArgs& a, cudaStream_t stream);

}  // namespace kmb_ta
