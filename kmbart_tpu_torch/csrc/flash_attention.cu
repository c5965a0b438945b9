// K11: blockwise (flash) attention forward for sequences too long for K1.
//
// Replaces kmbart_tpu/ops/pallas_attention.py:62 flash_attention (body
// _flash_kernel :24). Per batch b, head h, query i (hd = D / H), from the
// [B, T, H * hd] projections read by row stride (the fused QKV chunks
// without a copy):
//   s_j  = float(q[b, i, h]) * scale . float(k[b, j, h]) + bias[b, j]
//                                                     bias 0 or -1e9 (key mask 1 or 0);
//                                                     s_j = -1e9 where j > i if causal
//   online over key tiles, from m = -1e9, l = 0, acc = 0:
//     m' = max(m, max_j s_j);  p_j = exp(s_j - m');  alpha = exp(m - m')
//     acc = acc * alpha + sum_j p_j float(v[b, j, h]);  l = l * alpha + sum_j p_j
//   out  = acc / max(l, 1e-30)                        fp32 output
//
// What bounds it on an H100: at the long-caption pretraining shapes (B 32,
// H 12, hd 64, T 296 / 272) the work is 2 x 33.6 M (query, key) pairs x 64 x
// 2 FLOP, 8.6 GFLOP a call (0.0087 ms at 989 TFLOP/s in bf16), on 72.7 MB
// of q, k, v, key mask and fp32 output (0.0217 ms at 3.35 TB/s): bytes. A
// first version kept p in fp32 and so ran both products on the fp32 CUDA
// cores, at about 10 TFLOP/s and 9x SDPA's time. This one runs both on the
// tensor cores (bf16 operands, fp32 accumulators) and keeps the TPU
// kernel's fp32 p to about 16 significant bits:
//   - Q K^T is exact in its products: q, k and v arrive in bf16, and the
//     scale multiplies the fp32 sum afterwards. At head_dim 64 the scale is
//     1/8, so that is the reference's q * scale to the bit; at other widths
//     a score differs from it by a rounding.
//   - p = exp(s - m) is taken as 2^(s log2(e) - m log2(e)): the scores enter
//     the log2 domain by one fused multiply-add with the key bias, whose
//     rounding moves p by about |s - m| 2^-24 relatively (under 1e-6 at
//     these shapes), and weights below 2^-126 are flushed to zero; a fully
//     masked row's scores still all equal its maximum, so it still averages
//     over every key.
//   - P V takes p as two bf16 terms, p_hi = bf16(p) and p_lo = bf16(p -
//     p_hi), in two products into the same fp32 accumulators: p_hi + p_lo is
//     within 2^-16 p of p, so the output, a convex combination of v rows,
//     is within 2^-16 max|v| of the fp32 product (chip_smoke.py FLASH_RTOL).
//     l sums the fp32 p, as the reference does.
// Layout (FlashAttention-2's): one block of four warps for each (64-query
// tile, b * h); a warp owns 16 query rows and keeps their scores, running
// (m, l) and output rows in registers, the scores' accumulator fragments
// doubling as P's A fragments. K and V tiles of 64 keys stream through
// shared memory by cp.async, double-buffered, so the next tile's copy
// overlaps this tile's math. At these lengths no one unit bounds the
// kernel: in diagnostic builds of a first mma.sync version (NVIDIA H100
// 80GB HBM3), leaving out the masks, the p_lo products or the exact exp
// each saved a small share, and the Q K^T products alone took a third of
// the time. What set their pace was shared memory: with mma.sync each warp
// reads the whole K and V tile for its 16 rows. So at
// head_dim 64 (every BART size) the four warps issue the products together
// as one warpgroup's wgmma (flash_attention_wg), which reads each tile once
// for all 64 rows, from the 128-byte swizzled layout the copies write,
// with P passed in registers as the A operand of the P V products; its 96
// registers a thread leave five blocks resident an SM. Other widths take
// the mma.sync kernel (flash_attention_tc, the fragment code of K1 in
// train_attention_tc.cuh). In both, only tiles with keys past Tk or above a
// row's diagonal run the full mask (the others add the key bias, staged
// with the tile, in the multiply-add that scales the score). Any Tq, Tk is
// taken: rows past Tk load as zero and score -inf, rows past Tq are not
// written, so the ragged last tiles need no padding. A causal query tile
// skips the key tiles wholly above its diagonal only where its batch row
// keeps key 0 (mask[b, 0] != 0): every query row then has a finite score,
// so a skipped term would be exp(-1e9 - m) = 0 in fp32 and the result is
// the same bits. A row whose every key is masked averages over all Tk
// keys, as the TPU kernel does, so there no tile is skipped
// (tests/test_torch_flash_tc.py emulates the rule on the CPU).
//
// fp32 inputs are off the bf16 main path and keep that first kernel on the
// fp32 CUDA cores (flash_attention_f32 below: no tile skipped, q staged scaled
// and transposed in shared memory, a lane per two keys for the scores and
// per head_dim columns for P V).
#include "train_attention_tc.cuh"
#include "wgmma_gemm.cuh"

namespace {

using kmb_ta::bf16;

constexpr int kBQ = 64;             // query rows per block
constexpr int kBK = 64;             // keys per shared-memory tile
constexpr int kWarps = 4;           // warps a block
constexpr int kRows = kBQ / kWarps;  // query rows a warp

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>  // at most N committed groups still pending
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// p as two bf16 pairs: hi = bf16(p), lo = bf16(p - hi)
__device__ __forceinline__ void split_bf16x2(float p0, float p1, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(p0, p1);
  const float2 hf = __bfloat1622float2(h);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = kmb_ta::pack_bf16(p0 - hf.x, p1 - hf.y);
}

// keys [0, keys_read) of a query tile starting at q0 (see the note above)
__device__ __forceinline__ int keys_read(const int64_t* mask, int b, int q0, int Tk,
                                         int causal) {
  const bool keeps_key0 = mask == nullptr || mask[(size_t)b * Tk] != 0;
  return causal && keeps_key0 ? min(Tk, q0 + kBQ) : Tk;
}

// ---------------------------------------------------------------------------
// bf16: the tensor cores

constexpr float kLog2e = 1.4426950408889634f;

// 2^x, results below 2^-126 flushed to zero: a weight that small moves no
// output (l >= 1), and the flush spares the denormal fix-up of exp2f
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// the shared-memory row pitch of a head of NT n8 tiles: 16 bytes past the
// row, so the eight rows an ldmatrix reads fall in distinct banks
template <int NT>
__host__ __device__ constexpr int tc_ld() { return 8 * NT + 8; }

template <int NT>
size_t tc_smem_bytes() {  // q, then K and V twice, then the two tiles' key bias
  return sizeof(bf16) * tc_ld<NT>() * (kBQ + 2 * 2 * kBK) + sizeof(float) * 2 * kBK;
}

// rows [0, rows) of a head's [rows, hd] slice at stride ldg into a shared
// [64][tc_ld<NT>()] tile by cp.async; pad rows and columns zero
template <int NT>
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* src, int rows, int hd,
                                          int ldg) {
#pragma unroll
  for (int i = threadIdx.x; i < 64 * NT; i += kWarps * 32) {
    const int r = i / NT, c = i % NT;  // NT 16-byte chunks a row
    bf16* d = dst + r * tc_ld<NT>() + c * 8;
    if (r < rows && c * 8 < hd)
      kmb_ta::cp_async16(d, src + (size_t)r * ldg + c * 8);
    else
      *reinterpret_cast<uint4*>(d) = make_uint4(0, 0, 0, 0);
  }
}

// NT: n8 tiles of head_dim (hd <= 8 NT). Four blocks an SM up to head_dim
// 64: the kernel is bound by latency, and 128 registers a thread keep four
// resident, which ran faster than the three the unbounded 158 allowed
// (NVIDIA H100 80GB HBM3).
template <int NT>
__global__ void __launch_bounds__(kWarps * 32, NT > 8 ? 2 : 4)
flash_attention_tc(const bf16* __restrict__ q, const bf16* __restrict__ k,
                   const bf16* __restrict__ v, const int64_t* __restrict__ mask,
                   float* __restrict__ out, int Tq, int Tk, int H, int hd, int ldq, int ldk,
                   int ldv, int causal, float scale) {
  constexpr int KC = NT / 2;  // 16-column chunks of head_dim
  constexpr int LD = tc_ld<NT>();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);  // [kBQ][LD]
  bf16* kv_s = q_s + kBQ * LD;                     // [2 buffers][K, V][kBK][LD]
  float* bias_s = reinterpret_cast<float*>(kv_s + 2 * 2 * kBK * LD);  // [2 buffers][kBK]
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int q0 = blockIdx.x * kBQ;
  const int ntiles = (keys_read(mask, b, q0, Tk, causal) + kBK - 1) / kBK;

  auto stage_kv = [&](int t) {
    bf16* ks = kv_s + (t & 1) * 2 * kBK * LD;
    const int k0 = t * kBK, rows = min(kBK, Tk - k0);
    load_rows<NT>(ks, k + ((size_t)b * Tk + k0) * ldk + h * hd, rows, hd, ldk);
    load_rows<NT>(ks + kBK * LD, v + ((size_t)b * Tk + k0) * ldv + h * hd, rows, hd, ldv);
    if (threadIdx.x < kBK)
      bias_s[(t & 1) * kBK + threadIdx.x] =
          threadIdx.x < rows ? kmb_ta::key_bias(mask, b, Tk, k0 + threadIdx.x) : 0.f;
  };
  load_rows<NT>(q_s, q + ((size_t)b * Tq + q0) * ldq + h * hd, min(kBQ, Tq - q0), hd, ldq);
  stage_kv(0);
  cp_async_commit();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t4 = lane & 3;
  const int r0 = warp * kRows;
  const int i0 = q0 + r0 + g, i1 = i0 + 8;  // the thread's two query rows
  const bool live = q0 + r0 < Tq;           // the warp has a row to compute
  uint32_t qa[KC][4];
  float o[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  // running maxima in the log2 domain; l: the sums over this thread's keys
  float m0 = KMB_NEG_INF * kLog2e, m1 = KMB_NEG_INF * kLog2e, l0 = 0.f, l1 = 0.f;

  for (int t = 0; t < ntiles; ++t) {
    if (t + 1 < ntiles) {
      stage_kv(t + 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (!live) {
      __syncthreads();
      continue;
    }
    if (t == 0) {
#pragma unroll
      for (int c = 0; c < KC; ++c)
        kmb_ta::ldsm_x4(qa[c], kmb_ta::frag_a(q_s, LD, r0, c * 16, lane));
    }
    const bf16* ks = kv_s + (t & 1) * 2 * kBK * LD;
    const bf16* vs = ks + kBK * LD;
    const int k0 = t * kBK;
    const float* bias_t = bias_s + (t & 1) * kBK - k0;  // indexed by key

    // S = Q K^T: n8 tile n holds keys 8n..8n+7 of the tile, rows g (regs 0,
    // 1) and g + 8 (regs 2, 3)
    float s[kBK / 8][4];
#pragma unroll
    for (int n = 0; n < kBK / 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int kc = 0; kc < kBK / 16; ++kc) {
#pragma unroll
      for (int c = 0; c < KC; ++c) {
        uint32_t kb[4];
        kmb_ta::ldsm_x4(kb, kmb_ta::frag_bt(ks, LD, kc * 16, c * 16, lane));
        kmb_ta::mma16816(s[2 * kc], qa[c], kb[0], kb[1]);
        kmb_ta::mma16816(s[2 * kc + 1], qa[c], kb[2], kb[3]);
      }
    }

    // scale and masks, into the log2 domain: a tile with keys past Tk, or
    // with keys above the diagonal of one of the warp's rows, takes the full
    // mask; any other tile only its key bias
    const bool edge = k0 + kBK > Tk || (causal && k0 + kBK - 1 > q0 + r0);
#pragma unroll
    for (int n = 0; n < kBK / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int j = k0 + n * 8 + 2 * t4 + e;
        if (edge) {
          s[n][e] = kLog2e * kmb_ta::masked(s[n][e] * scale, i0, j, Tk, causal, bias_t);
          s[n][2 + e] = kLog2e * kmb_ta::masked(s[n][2 + e] * scale, i1, j, Tk, causal, bias_t);
        } else {
          const float bj = bias_t[j] * kLog2e;
          s[n][e] = fmaf(s[n][e], scale * kLog2e, bj);
          s[n][2 + e] = fmaf(s[n][2 + e], scale * kLog2e, bj);
        }
      }
    }

    // the online softmax update of the two rows
    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int n = 0; n < kBK / 8; ++n) {
      mx0 = fmaxf(mx0, fmaxf(s[n][0], s[n][1]));
      mx1 = fmaxf(mx1, fmaxf(s[n][2], s[n][3]));
    }
    mx0 = kmb_ta::quad_max(mx0);
    mx1 = kmb_ta::quad_max(mx1);
    const float a0 = exp2_ftz(m0 - mx0), a1 = exp2_ftz(m1 - mx1);
    m0 = mx0;
    m1 = mx1;
    float ls0 = 0.f, ls1 = 0.f;
#pragma unroll
    for (int n = 0; n < kBK / 8; ++n) {
      s[n][0] = exp2_ftz(s[n][0] - mx0);
      s[n][1] = exp2_ftz(s[n][1] - mx0);
      s[n][2] = exp2_ftz(s[n][2] - mx1);
      s[n][3] = exp2_ftz(s[n][3] - mx1);
      ls0 += s[n][0] + s[n][1];
      ls1 += s[n][2] + s[n][3];
    }
    l0 = l0 * a0 + ls0;
    l1 = l1 * a1 + ls1;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      o[n][0] *= a0;
      o[n][1] *= a0;
      o[n][2] *= a1;
      o[n][3] *= a1;
    }

    // O += P_hi V + P_lo V, 16 keys at a time: the score tiles 2kc and
    // 2kc + 1 are the A fragment of that chunk
#pragma unroll
    for (int kc = 0; kc < kBK / 16; ++kc) {
      uint32_t hi[4], lo[4];
      split_bf16x2(s[2 * kc][0], s[2 * kc][1], hi[0], lo[0]);
      split_bf16x2(s[2 * kc][2], s[2 * kc][3], hi[1], lo[1]);
      split_bf16x2(s[2 * kc + 1][0], s[2 * kc + 1][1], hi[2], lo[2]);
      split_bf16x2(s[2 * kc + 1][2], s[2 * kc + 1][3], hi[3], lo[3]);
#pragma unroll
      for (int c = 0; c < KC; ++c) {
        uint32_t vb[4];
        kmb_ta::ldsm_x4_t(vb, kmb_ta::frag_a(vs, LD, kc * 16, c * 16, lane));
        kmb_ta::mma16816(o[2 * c], hi, vb[0], vb[1]);
        kmb_ta::mma16816(o[2 * c + 1], hi, vb[2], vb[3]);
        kmb_ta::mma16816(o[2 * c], lo, vb[0], vb[1]);
        kmb_ta::mma16816(o[2 * c + 1], lo, vb[2], vb[3]);
      }
    }
    __syncthreads();  // this buffer is read: the copy of tile t + 2 may overwrite it
  }

  const float d0 = fmaxf(kmb_ta::quad_sum(l0), 1e-30f);
  const float d1 = fmaxf(kmb_ta::quad_sum(l1), 1e-30f);
  const int D = H * hd;
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    const int col = n * 8 + 2 * t4;
    if (col < hd) {
      if (i0 < Tq)
        *reinterpret_cast<float2*>(out + ((size_t)b * Tq + i0) * D + h * hd + col) =
            make_float2(o[n][0] / d0, o[n][1] / d0);
      if (i1 < Tq)
        *reinterpret_cast<float2*>(out + ((size_t)b * Tq + i1) * D + h * hd + col) =
            make_float2(o[n][2] / d1, o[n][3] / d1);
    }
  }
}

template <int NT>
cudaError_t launch_tc(const void* q, const void* k, const void* v, const int64_t* mask, float* out,
                      int B, int Tq, int Tk, int H, int hd, int ldq, int ldk, int ldv, int causal,
                      float scale, cudaStream_t stream) {
  const size_t smem = tc_smem_bytes<NT>();
  const cudaError_t err = kmb_allow_smem(flash_attention_tc<NT>, smem);
  if (err != cudaSuccess) return err;
  flash_attention_tc<NT><<<dim3((Tq + kBQ - 1) / kBQ, B * H), kWarps * 32, smem, stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, mask, out, Tq, Tk, H, hd, ldq, ldk, ldv,
      causal, scale);
  return cudaGetLastError();
}

// d[64 x 64] += A[64 x 16] * B[16 x 64], both from shared memory (K-major
// 128-byte swizzled tiles); each warp holds 16 rows of d as an mma.sync
// m16n8 accumulator fragment, n8 tile n in d[n]
__device__ __forceinline__ void wgmma_ss(float (&d)[8][4], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]),
        "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]), "+f"(d[2][0]), "+f"(d[2][1]),
        "+f"(d[2][2]), "+f"(d[2][3]), "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]),
        "+f"(d[3][3]), "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]), "+f"(d[6][0]),
        "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]), "+f"(d[7][0]), "+f"(d[7][1]),
        "+f"(d[7][2]), "+f"(d[7][3])
      : "l"(da), "l"(db), "r"(1));
}

// d[64 x 64] += A[64 x 16] * B[16 x 64]: A from registers (each warp's 16
// rows as an mma.sync m16n8k16 A fragment), B MN-major in shared memory
__device__ __forceinline__ void wgmma_rs(float (&d)[8][4], const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]),
        "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]), "+f"(d[2][0]), "+f"(d[2][1]),
        "+f"(d[2][2]), "+f"(d[2][3]), "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]),
        "+f"(d[3][3]), "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]), "+f"(d[6][0]),
        "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]), "+f"(d[7][0]), "+f"(d[7][1]),
        "+f"(d[7][2]), "+f"(d[7][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// keeps the compiler from moving accumulator reads or writes across an
// asynchronous wgmma
__device__ __forceinline__ void fence_acc(float (&d)[8][4]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i / 4][i % 4])::"memory");
}

// byte offset of 16-byte chunk c of row r in a [64][64] bf16 tile laid out
// as TMA's and wgmma's 128-byte swizzle (rows of 128 bytes, chunks permuted
// by r % 8)
__device__ __forceinline__ uint32_t sw128_offset(int r, int c) {
  return r * 128 + ((c ^ (r & 7)) << 4);
}

// rows [0, rows) of a head_dim-64 head slice at stride ldg into a swizzled
// [64][64] tile by cp.async; pad rows zero
__device__ __forceinline__ void load_rows_sw(unsigned char* dst, const bf16* src, int rows,
                                             int ldg) {
#pragma unroll
  for (int i = threadIdx.x; i < 64 * 8; i += kWarps * 32) {
    const int r = i / 8, c = i % 8;
    unsigned char* d = dst + sw128_offset(r, c);
    if (r < rows)
      kmb_ta::cp_async16(d, src + (size_t)r * ldg + c * 8);
    else
      *reinterpret_cast<uint4*>(d) = make_uint4(0, 0, 0, 0);
  }
}

constexpr int kTile = 64 * 64 * 2;  // bytes of a swizzled [64][64] bf16 tile
constexpr size_t kWgSmem = 1024 + 5 * kTile + 2 * kBK * sizeof(float);  // + 1024-byte alignment

// head_dim 64: the products on wgmma, a warpgroup per 64 query rows (see the
// note above). Five blocks an SM (96 registers a thread, no spills): the
// kernel is bound by latency, and the fifth block ran faster than four at
// 128 registers (NVIDIA H100 80GB HBM3).
__global__ void __launch_bounds__(kWarps * 32, 5)
flash_attention_wg(const bf16* __restrict__ q, const bf16* __restrict__ k,
                   const bf16* __restrict__ v, const int64_t* __restrict__ mask,
                   float* __restrict__ out, int Tq, int Tk, int H, int ldq, int ldk, int ldv,
                   int causal, float scale) {
  constexpr int hd = 64;
  extern __shared__ unsigned char smem_raw[];
  // 128-byte swizzled tiles want 1024-byte aligned shared memory
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  unsigned char* q_s = smem;               // [64][64]
  unsigned char* kv_s = smem + kTile;      // [2 buffers][K, V] tiles
  float* bias_s = reinterpret_cast<float*>(smem + 5 * kTile);  // [2 buffers][kBK]
  const uint32_t q_a = kmb_ta::smem_u32(q_s), kv_a = kmb_ta::smem_u32(kv_s);
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int q0 = blockIdx.x * kBQ;
  const int ntiles = (keys_read(mask, b, q0, Tk, causal) + kBK - 1) / kBK;

  auto stage_kv = [&](int t) {
    unsigned char* ks = kv_s + (t & 1) * 2 * kTile;
    const int k0 = t * kBK, rows = min(kBK, Tk - k0);
    load_rows_sw(ks, k + ((size_t)b * Tk + k0) * ldk + h * hd, rows, ldk);
    load_rows_sw(ks + kTile, v + ((size_t)b * Tk + k0) * ldv + h * hd, rows, ldv);
    if (threadIdx.x < kBK)
      bias_s[(t & 1) * kBK + threadIdx.x] =
          threadIdx.x < rows ? kmb_ta::key_bias(mask, b, Tk, k0 + threadIdx.x) : 0.f;
  };
  load_rows_sw(q_s, q + ((size_t)b * Tq + q0) * ldq + h * hd, min(kBQ, Tq - q0), ldq);
  stage_kv(0);
  cp_async_commit();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t4 = lane & 3;
  const int r0 = warp * kRows;
  const int i0 = q0 + r0 + g, i1 = i0 + 8;  // the thread's two query rows
  float o[8][4];
#pragma unroll
  for (int n = 0; n < 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  // running maxima in the log2 domain; l: the sums over this thread's keys
  float m0 = KMB_NEG_INF * kLog2e, m1 = KMB_NEG_INF * kLog2e, l0 = 0.f, l1 = 0.f;

  for (int t = 0; t < ntiles; ++t) {
    if (t + 1 < ntiles) {
      stage_kv(t + 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    kmb_wg::fence_async_smem();  // this thread's copies, visible to wgmma
    __syncthreads();
    const uint32_t k_a = kv_a + (t & 1) * 2 * kTile, v_a = k_a + kTile;
    const int k0 = t * kBK;
    const float* bias_t = bias_s + (t & 1) * kBK - k0;  // indexed by key

    // S = Q K^T over head_dim in four k16 steps
    float s[kBK / 8][4];
#pragma unroll
    for (int n = 0; n < kBK / 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
    fence_acc(s);
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int kk = 0; kk < hd / 16; ++kk)
      wgmma_ss(s, kmb_wg::sw128_desc(q_a + 32 * kk, 16, 1024),
               kmb_wg::sw128_desc(k_a + 32 * kk, 16, 1024));
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    fence_acc(s);

    // scale and masks, into the log2 domain (as flash_attention_tc)
    const bool edge = k0 + kBK > Tk || (causal && k0 + kBK - 1 > q0 + r0);
#pragma unroll
    for (int n = 0; n < kBK / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int j = k0 + n * 8 + 2 * t4 + e;
        if (edge) {
          s[n][e] = kLog2e * kmb_ta::masked(s[n][e] * scale, i0, j, Tk, causal, bias_t);
          s[n][2 + e] = kLog2e * kmb_ta::masked(s[n][2 + e] * scale, i1, j, Tk, causal, bias_t);
        } else {
          const float bj = bias_t[j] * kLog2e;
          s[n][e] = fmaf(s[n][e], scale * kLog2e, bj);
          s[n][2 + e] = fmaf(s[n][2 + e], scale * kLog2e, bj);
        }
      }
    }
    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int n = 0; n < kBK / 8; ++n) {
      mx0 = fmaxf(mx0, fmaxf(s[n][0], s[n][1]));
      mx1 = fmaxf(mx1, fmaxf(s[n][2], s[n][3]));
    }
    mx0 = kmb_ta::quad_max(mx0);
    mx1 = kmb_ta::quad_max(mx1);
    const float a0 = exp2_ftz(m0 - mx0), a1 = exp2_ftz(m1 - mx1);
    m0 = mx0;
    m1 = mx1;
    float ls0 = 0.f, ls1 = 0.f;
#pragma unroll
    for (int n = 0; n < kBK / 8; ++n) {
      s[n][0] = exp2_ftz(s[n][0] - mx0);
      s[n][1] = exp2_ftz(s[n][1] - mx0);
      s[n][2] = exp2_ftz(s[n][2] - mx1);
      s[n][3] = exp2_ftz(s[n][3] - mx1);
      ls0 += s[n][0] + s[n][1];
      ls1 += s[n][2] + s[n][3];
    }
    l0 = l0 * a0 + ls0;
    l1 = l1 * a1 + ls1;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      o[n][0] *= a0;
      o[n][1] *= a0;
      o[n][2] *= a1;
      o[n][3] *= a1;
    }

    // O += P_hi V + P_lo V, 16 keys a step; V read MN-major (head_dim
    // contiguous), k16 step kc 16 rows = 2048 bytes into the tile
    uint32_t hi[kBK / 16][4], lo[kBK / 16][4];
#pragma unroll
    for (int kc = 0; kc < kBK / 16; ++kc) {
      split_bf16x2(s[2 * kc][0], s[2 * kc][1], hi[kc][0], lo[kc][0]);
      split_bf16x2(s[2 * kc][2], s[2 * kc][3], hi[kc][1], lo[kc][1]);
      split_bf16x2(s[2 * kc + 1][0], s[2 * kc + 1][1], hi[kc][2], lo[kc][2]);
      split_bf16x2(s[2 * kc + 1][2], s[2 * kc + 1][3], hi[kc][3], lo[kc][3]);
    }
    fence_acc(o);
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int kc = 0; kc < kBK / 16; ++kc) {
      const uint64_t db = kmb_wg::sw128_desc(v_a + 2048 * kc, 64 * 128, 1024);
      wgmma_rs(o, hi[kc], db);
      wgmma_rs(o, lo[kc], db);
    }
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    fence_acc(o);
    __syncthreads();  // this buffer is read: the copy of tile t + 2 may overwrite it
  }

  const float d0 = fmaxf(kmb_ta::quad_sum(l0), 1e-30f);
  const float d1 = fmaxf(kmb_ta::quad_sum(l1), 1e-30f);
  const int D = H * hd;
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    const int col = n * 8 + 2 * t4;
    if (i0 < Tq)
      *reinterpret_cast<float2*>(out + ((size_t)b * Tq + i0) * D + h * hd + col) =
          make_float2(o[n][0] / d0, o[n][1] / d0);
    if (i1 < Tq)
      *reinterpret_cast<float2*>(out + ((size_t)b * Tq + i1) * D + h * hd + col) =
          make_float2(o[n][2] / d1, o[n][3] / d1);
  }
}

cudaError_t launch_wg(const void* q, const void* k, const void* v, const int64_t* mask,
                      float* out, int B, int Tq, int Tk, int H, int ldq, int ldk, int ldv,
                      int causal, float scale, cudaStream_t stream) {
  const cudaError_t err = kmb_allow_smem(flash_attention_wg, kWgSmem);
  if (err != cudaSuccess) return err;
  flash_attention_wg<<<dim3((Tq + kBQ - 1) / kBQ, B * H), kWarps * 32, kWgSmem, stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, mask, out, Tq, Tk, H, ldq, ldk, ldv,
      causal, scale);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// fp32: the first version's kernel on the CUDA cores

constexpr int kLdQ = kBQ + 4;  // q^T row stride: float4-aligned, fewer conflicts

size_t f32_smem_bytes(int hd) {
  return sizeof(float) * ((size_t)hd * kLdQ + (size_t)kBK * (hd + 1) + (size_t)kBK * hd +
                          (size_t)kWarps * kBK * kRows);
}

// NPL: head_dim columns per lane (hd <= 32 * NPL)
template <int NPL>
__global__ void __launch_bounds__(kWarps * 32)
flash_attention_f32(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, const int64_t* __restrict__ mask,
                    float* __restrict__ out, int Tq, int Tk, int H, int hd, int ldq, int ldk,
                    int ldv, int causal, float scale) {
  extern __shared__ __align__(16) float smem[];
  float* q_t = smem;                         // [hd][kLdQ]   q * scale, transposed
  float* k_s = q_t + (size_t)hd * kLdQ;      // [kBK][hd + 1]
  float* v_s = k_s + (size_t)kBK * (hd + 1); // [kBK][hd]
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* p_t = v_s + (size_t)kBK * hd + (size_t)warp * kBK * kRows;  // [kBK][kRows]
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int q0 = blockIdx.x * kBQ;
  const int ldks = hd + 1;
  const size_t head = (size_t)h * hd;

  for (int i = threadIdx.x; i < kBQ * hd; i += blockDim.x) {
    const int r = i / hd, d = i % hd, qi = q0 + r;
    q_t[d * kLdQ + r] = qi < Tq ? q[((size_t)b * Tq + qi) * ldq + head + d] * scale : 0.f;
  }

  float m[kRows], l[kRows], acc[kRows][NPL];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    m[r] = KMB_NEG_INF;
    l[r] = 0.f;
#pragma unroll
    for (int e = 0; e < NPL; ++e) acc[r][e] = 0.f;
  }
  const int row0 = q0 + warp * kRows;  // this warp's first query row

  for (int k0 = 0; k0 < Tk; k0 += kBK) {
    __syncthreads();  // the previous tile is consumed (and q_t is written)
    for (int i = threadIdx.x; i < kBK * hd; i += blockDim.x) {
      const int j = i / hd, d = i % hd, kj = k0 + j;
      float kv = 0.f, vv = 0.f;
      if (kj < Tk) {
        kv = k[((size_t)b * Tk + kj) * ldk + head + d];
        vv = v[((size_t)b * Tk + kj) * ldv + head + d];
      }
      k_s[j * ldks + d] = kv;
      v_s[j * hd + d] = vv;
    }
    __syncthreads();

    // scores of the warp's 16 rows against keys lane and lane + 32
    float s[kRows][2];
#pragma unroll
    for (int r = 0; r < kRows; ++r) s[r][0] = s[r][1] = 0.f;
    const float* k0_row = k_s + lane * ldks;
    const float* k1_row = k_s + (lane + 32) * ldks;
    for (int d = 0; d < hd; ++d) {
      const float ka = k0_row[d], kb = k1_row[d];
      const float4* qd = reinterpret_cast<const float4*>(q_t + d * kLdQ + warp * kRows);
#pragma unroll
      for (int r4 = 0; r4 < kRows / 4; ++r4) {
        const float4 qv = qd[r4];
        const float qs[4] = {qv.x, qv.y, qv.z, qv.w};
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          s[r4 * 4 + t][0] = fmaf(qs[t], ka, s[r4 * 4 + t][0]);
          s[r4 * 4 + t][1] = fmaf(qs[t], kb, s[r4 * 4 + t][1]);
        }
      }
    }

    // masks, then the online softmax update of each row
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int kj = k0 + lane + 32 * c;
      const bool valid = kj < Tk;
      const float bj = valid ? kmb_ta::key_bias(mask, b, Tk, kj) : 0.f;
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        float x = s[r][c] + bj;
        if (causal && kj > row0 + r) x = KMB_NEG_INF;
        s[r][c] = valid ? x : -INFINITY;  // keys past Tk take no weight
      }
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const float m_new = fmaxf(m[r], warp_max(fmaxf(s[r][0], s[r][1])));
      const float p0 = expf(s[r][0] - m_new), p1 = expf(s[r][1] - m_new);
      const float alpha = expf(m[r] - m_new);
      l[r] = l[r] * alpha + warp_sum(p0 + p1);
      m[r] = m_new;
#pragma unroll
      for (int e = 0; e < NPL; ++e) acc[r][e] *= alpha;
      s[r][0] = p0;
      s[r][1] = p1;
    }
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      float4* pj = reinterpret_cast<float4*>(p_t + (lane + 32 * c) * kRows);
#pragma unroll
      for (int r4 = 0; r4 < kRows / 4; ++r4)
        pj[r4] = make_float4(s[r4 * 4][c], s[r4 * 4 + 1][c], s[r4 * 4 + 2][c],
                             s[r4 * 4 + 3][c]);
    }
    __syncwarp();

    // acc += P V over the tile's keys (past Tk: p = 0 and v = 0)
    const int nk = min(kBK, Tk - k0);
    for (int j = 0; j < nk; ++j) {
      float vv[NPL];
#pragma unroll
      for (int e = 0; e < NPL; ++e) {
        const int d = lane + 32 * e;
        vv[e] = d < hd ? v_s[j * hd + d] : 0.f;
      }
      const float4* pj = reinterpret_cast<const float4*>(p_t + j * kRows);
#pragma unroll
      for (int r4 = 0; r4 < kRows / 4; ++r4) {
        const float4 pv = pj[r4];
        const float ps[4] = {pv.x, pv.y, pv.z, pv.w};
#pragma unroll
        for (int t = 0; t < 4; ++t)
#pragma unroll
          for (int e = 0; e < NPL; ++e)
            acc[r4 * 4 + t][e] = fmaf(ps[t], vv[e], acc[r4 * 4 + t][e]);
      }
    }
    __syncwarp();
  }

  const int D = H * hd;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int qi = row0 + r;
    if (qi >= Tq) break;
    const float inv = 1.f / fmaxf(l[r], 1e-30f);
    float* o_row = out + ((size_t)b * Tq + qi) * D + head;
#pragma unroll
    for (int e = 0; e < NPL; ++e) {
      const int d = lane + 32 * e;
      if (d < hd) o_row[d] = acc[r][e] * inv;
    }
  }
}

template <int NPL>
cudaError_t launch_f32(const void* q, const void* k, const void* v, const int64_t* mask,
                       float* out, int B, int Tq, int Tk, int H, int hd, int ldq, int ldk,
                       int ldv, int causal, float scale, cudaStream_t stream) {
  const size_t smem = f32_smem_bytes(hd);
  const cudaError_t err = kmb_allow_smem(flash_attention_f32<NPL>, smem);
  if (err != cudaSuccess) return err;
  flash_attention_f32<NPL><<<dim3((Tq + kBQ - 1) / kBQ, B * H), kWarps * 32, smem, stream>>>(
      (const float*)q, (const float*)k, (const float*)v, mask, out, Tq, Tk, H, hd, ldq, ldk,
      ldv, causal, scale);
  return cudaGetLastError();
}

}  // namespace

// q [B, Tq, D], k, v [B, Tk, D] (D = H * hd, hd <= 128) of type ``dtype``,
// rows ldq, ldk, ldv elements apart (bf16: 16-byte aligned rows, hd % 8 ==
// 0); mask int64 [B, Tk] 1-keep/0-pad, or null; out fp32 [B, Tq, D].
KMB_EXPORT int kmb_flash_attention(const void* q, const void* k, const void* v,
                                   const void* mask, void* out, int B, int Tq, int Tk, int D,
                                   int H, int ldq, int ldk, int ldv, int causal, float scale,
                                   int dtype, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  const int64_t* kb = (const int64_t*)mask;
  float* o = (float*)out;
  const int hd = D / H;
  if (dtype == KMB_BF16) {
    if (hd % 8) return cudaErrorInvalidValue;
    if (hd <= 32)
      return launch_tc<4>(q, k, v, kb, o, B, Tq, Tk, H, hd, ldq, ldk, ldv, causal, scale, s);
    if (hd == 64)
      return launch_wg(q, k, v, kb, o, B, Tq, Tk, H, ldq, ldk, ldv, causal, scale, s);
    if (hd <= 64)
      return launch_tc<8>(q, k, v, kb, o, B, Tq, Tk, H, hd, ldq, ldk, ldv, causal, scale, s);
    if (hd <= 128)
      return launch_tc<16>(q, k, v, kb, o, B, Tq, Tk, H, hd, ldq, ldk, ldv, causal, scale, s);
  } else if (dtype == KMB_F32) {
    if (hd <= 32)
      return launch_f32<1>(q, k, v, kb, o, B, Tq, Tk, H, hd, ldq, ldk, ldv, causal, scale, s);
    if (hd <= 64)
      return launch_f32<2>(q, k, v, kb, o, B, Tq, Tk, H, hd, ldq, ldk, ldv, causal, scale, s);
    if (hd <= 128)
      return launch_f32<4>(q, k, v, kb, o, B, Tq, Tk, H, hd, ldq, ldk, ldv, causal, scale, s);
  }
  return cudaErrorInvalidValue;
}
