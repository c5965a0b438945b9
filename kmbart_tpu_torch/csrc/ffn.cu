// K2: fused FFN forward, y = gelu(x @ W1^T + b1) @ W2^T + b2.
//
// Replaces kmbart_tpu/ops/pallas_ffn.py:160 _fwd_call (body _fwd_kernel
// :95), the FFN of every encoder layer and of every decoder step.
//
// What it computes (x, W1, W2 bf16; b1, b2 fp32; fp32 accumulation):
//   a   = bf16(x @ W1^T + b1)
//   h   = bf16(gelu(a))          exact erf in fp32 (the TPU kernel used the
//                                Abramowitz-Stegun polynomial: Mosaic has no erf)
//   y   = bf16(h @ W2^T + b2)
// W1 is fc1.weight [F, D] and W2 is fc2.weight [D, F], as PyTorch stores them.
// The [N, F] intermediate h never reaches device memory. The bf16
// pre-activation `a` is written out only when the caller passes a buffer
// for it (training: the backward's residual, as pallas_ffn.py:102-103
// writes it); generation passes none and does not pay for it.
//
// What bounds it on an H100: tensor-core FLOPs at the encoder's N = 4608
// rows (43 GFLOP per layer), weight bytes at a decode step's N = 320 rows
// (9.4 MB of bf16 weights read for 3 GFLOP). The TPU kernel kept a [tn, D]
// fp32 accumulator in VMEM; here a block owns BM = 32 rows and keeps their
// [32, D] fp32 accumulator in registers (16 wmma fragments a warp at most,
// D <= 1024), walking F in steps of BF = 64: GEMM1 writes one [32, 64] tile
// to shared memory, the GELU epilogue rounds it to bf16 there, and GEMM2
// folds it into the accumulator. Weights are read through L2 (9.4 MB fits
// its 50 MB). When there are too few row tiles to fill the card, the F walk
// is split over blockIdx.y into fp32 partial sums that a second pass adds
// in a fixed order before b2 and the one rounding to bf16.
// This first version uses wmma (mma.sync) tiles without a TMA/wgmma
// pipeline; making it fast is later work.
#include <mma.h>

#include "common.cuh"

using namespace nvcuda;

namespace {

typedef __nv_bfloat16 bf16;
constexpr int BM = 32;    // rows per block
constexpr int BF = 64;    // F columns per step of the walk
constexpr int NW = 8;     // warps per block
constexpr int MAXJ = 8;   // column fragments per warp: D / 16 <= NW * MAXJ

__device__ __forceinline__ float gelu_exact(float z) {
  return z * 0.5f * (1.f + erff(z * 0.70710678118654752f));
}

inline size_t smem_bytes(int D) {
  return sizeof(bf16) * BM * (D + 8) + sizeof(float) * BM * (BF + 4) +
         sizeof(bf16) * BM * (BF + 8);
}

__global__ void __launch_bounds__(NW * 32, 1)
ffn_fwd_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w1,
               const float* __restrict__ b1, const bf16* __restrict__ w2,
               const float* __restrict__ b2, bf16* __restrict__ y,
               float* __restrict__ partial, bf16* __restrict__ a_out, int N, int D, int F,
               int tiles_per_split) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int ldx = D + 8, lda = BF + 4, ldh = BF + 8;
  bf16* x_s = reinterpret_cast<bf16*>(smem);                                   // [BM][ldx]
  float* a_s = reinterpret_cast<float*>(smem + sizeof(bf16) * BM * ldx);       // [BM][lda]
  bf16* h_s = reinterpret_cast<bf16*>(smem + sizeof(bf16) * BM * ldx +
                                      sizeof(float) * BM * lda);               // [BM][ldh]
  const int row0 = blockIdx.x * BM;
  const int split = blockIdx.y;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int nd = D / 16;

  for (int i = tid; i < BM * D; i += NW * 32) {
    const int r = i / D, c = i % D;
    x_s[r * ldx + c] = (row0 + r < N) ? x[(size_t)(row0 + r) * D + c] : __float2bfloat16(0.f);
  }
  __syncthreads();

  // acc[2j + mi]: rows mi*16.., columns (warp + NW*j)*16.. of the [BM, D] output
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2 * MAXJ];
#pragma unroll
  for (int i = 0; i < 2 * MAXJ; ++i) wmma::fill_fragment(acc[i], 0.f);

  const int nt = F / BF;
  const int t0 = split * tiles_per_split;
  const int t1 = min(nt, t0 + tiles_per_split);
  const int gm = warp / 4, gn = warp % 4;  // this warp's GEMM1 fragment of [BM, BF]
  for (int t = t0; t < t1; ++t) {
    const int f0 = t * BF;
    {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> c;
      wmma::fill_fragment(c, 0.f);
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> bw;
      const bf16* w1_cols = w1 + (size_t)(f0 + gn * 16) * D;  // W1^T columns f0 + gn*16 ..
#pragma unroll 4
      for (int kk = 0; kk < D; kk += 16) {
        wmma::load_matrix_sync(a, x_s + gm * 16 * ldx + kk, ldx);
        wmma::load_matrix_sync(bw, w1_cols + kk, D);
        wmma::mma_sync(c, a, bw, c);
      }
      wmma::store_matrix_sync(a_s + gm * 16 * lda + gn * 16, c, lda, wmma::mem_row_major);
    }
    __syncthreads();
    for (int i = tid; i < BM * BF; i += NW * 32) {
      const int r = i / BF, cc = i % BF;
      const float a16 = round_bf16(a_s[r * lda + cc] + b1[f0 + cc]);
      h_s[r * ldh + cc] = __float2bfloat16(gelu_exact(a16));
      if (a_out != nullptr && row0 + r < N)
        a_out[(size_t)(row0 + r) * F + f0 + cc] = __float2bfloat16(a16);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BF; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> h0, h1;
      wmma::load_matrix_sync(h0, h_s + kk, ldh);
      wmma::load_matrix_sync(h1, h_s + 16 * ldh + kk, ldh);
#pragma unroll
      for (int j = 0; j < MAXJ; ++j) {
        const int ni = warp + NW * j;
        if (ni < nd) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> bw;
          wmma::load_matrix_sync(bw, w2 + (size_t)ni * 16 * F + f0 + kk, F);  // W2^T tile
          wmma::mma_sync(acc[2 * j], h0, bw, acc[2 * j]);
          wmma::mma_sync(acc[2 * j + 1], h1, bw, acc[2 * j + 1]);
        }
      }
    }
    __syncthreads();
  }

  float* stage = a_s + warp * 256;  // one 16x16 fp32 tile per warp
#pragma unroll
  for (int j = 0; j < MAXJ; ++j) {
    const int ni = warp + NW * j;
    if (ni < nd) {
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        wmma::store_matrix_sync(stage, acc[2 * j + mi], 16, wmma::mem_row_major);
        __syncwarp();
        for (int e = lane; e < 256; e += 32) {
          const int row = row0 + mi * 16 + e / 16, col = ni * 16 + e % 16;
          if (row < N) {
            if (partial != nullptr)
              partial[((size_t)split * N + row) * D + col] = stage[e];
            else
              y[(size_t)row * D + col] = __float2bfloat16(stage[e] + b2[col]);
          }
        }
        __syncwarp();
      }
    }
  }
}

// sums the fp32 partials of the split F walk in a fixed order (b2 may be null)
__global__ void ffn_finalize_kernel(const float* __restrict__ partial,
                                    const float* __restrict__ b2, bf16* __restrict__ y,
                                    int N, int D, int nsplit) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  const size_t n = (size_t)N * D;
  if (i >= n) return;
  float s = 0.f;
  for (int p = 0; p < nsplit; ++p) s += partial[p * n + i];
  y[i] = __float2bfloat16(b2 != nullptr ? s + b2[i % D] : s);
}

// ---------------------------------------------------------------------------
// K2 backward: dh = g @ W2, da = bf16(dh * gelu'(a)), dx = bf16(da @ W1).
//
// Replaces kmbart_tpu/ops/pallas_ffn.py:190 _bwd_call (body _bwd_kernel
// :123). g [N, D], a [N, F] (the forward's bf16 pre-activation), W1 =
// fc1.weight [F, D], W2 = fc2.weight [D, F], all bf16; gelu' uses exact erf,
// as the port's forward does (the TPU kernel used the A-S polynomial). The
// [N, F] dh never reaches device memory; da is written (bf16) because the
// weight gradients dW1 = da^T x and db1 = sum(da) are library products and
// reductions outside the kernel, as pallas_ffn.py:292-303 leaves them to XLA.
//
// What bounds it on an H100: the same two GEMMs as the forward (2 x 2 x N x
// D x F = 87 GFLOP per encoder layer at the fine-tune's N 9216 rows), so
// tensor-core FLOPs, plus the a read and da write (2 x N x F bf16, 113 MB). Design: the forward's
// structure with the roles swapped. A block owns BM = 32 rows of g in
// shared memory and their [32, D] fp32 dx accumulator in wmma fragments; it
// walks F in steps of BF = 64: GEMM1 makes a [32, 64] dh tile, the epilogue
// forms da in shared memory and writes it out, GEMM2 folds da @ W1 into dx.
// The TPU kernel walked F sequentially per row tile; here, when the row
// tiles alone cannot fill the card, the F walk is split over blockIdx.y
// into fp32 partials that ffn_finalize_kernel adds in a fixed order, so the
// result is deterministic.
__device__ __forceinline__ float dgelu_exact(float z) {
  // d/dz [z Phi(z)] = Phi(z) + z phi(z)
  return 0.5f * (1.f + erff(z * 0.70710678118654752f)) +
         z * 0.39894228040143268f * expf(-0.5f * z * z);
}

__global__ void __launch_bounds__(NW * 32, 1)
ffn_bwd_kernel(const bf16* __restrict__ g, const bf16* __restrict__ a,
               const bf16* __restrict__ w1, const bf16* __restrict__ w2,
               bf16* __restrict__ da, bf16* __restrict__ dx, float* __restrict__ partial,
               int N, int D, int F, int tiles_per_split) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int ldx = D + 8, lda = BF + 4, ldh = BF + 8;
  bf16* g_s = reinterpret_cast<bf16*>(smem);                                   // [BM][ldx]
  float* c_s = reinterpret_cast<float*>(smem + sizeof(bf16) * BM * ldx);       // [BM][lda]
  bf16* d_s = reinterpret_cast<bf16*>(smem + sizeof(bf16) * BM * ldx +
                                      sizeof(float) * BM * lda);               // [BM][ldh]
  const int row0 = blockIdx.x * BM;
  const int split = blockIdx.y;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int nd = D / 16;

  for (int i = tid; i < BM * D; i += NW * 32) {
    const int r = i / D, c = i % D;
    g_s[r * ldx + c] = (row0 + r < N) ? g[(size_t)(row0 + r) * D + c] : __float2bfloat16(0.f);
  }
  __syncthreads();

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2 * MAXJ];
#pragma unroll
  for (int i = 0; i < 2 * MAXJ; ++i) wmma::fill_fragment(acc[i], 0.f);

  const int nt = F / BF;
  const int t0 = split * tiles_per_split;
  const int t1 = min(nt, t0 + tiles_per_split);
  const int gm = warp / 4, gn = warp % 4;
  for (int t = t0; t < t1; ++t) {
    const int f0 = t * BF;
    {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> c;
      wmma::fill_fragment(c, 0.f);
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> ga;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bw;
#pragma unroll 4
      for (int kk = 0; kk < D; kk += 16) {
        wmma::load_matrix_sync(ga, g_s + gm * 16 * ldx + kk, ldx);
        wmma::load_matrix_sync(bw, w2 + (size_t)kk * F + f0 + gn * 16, F);  // W2[kk.., f0..]
        wmma::mma_sync(c, ga, bw, c);
      }
      wmma::store_matrix_sync(c_s + gm * 16 * lda + gn * 16, c, lda, wmma::mem_row_major);
    }
    __syncthreads();
    for (int i = tid; i < BM * BF; i += NW * 32) {
      const int r = i / BF, cc = i % BF;
      const bool live = row0 + r < N;
      const size_t ai = (size_t)(row0 + r) * F + f0 + cc;
      const float a16 = live ? __bfloat162float(a[ai]) : 0.f;
      const bf16 d16 = __float2bfloat16(c_s[r * lda + cc] * dgelu_exact(a16));
      d_s[r * ldh + cc] = d16;
      if (live) da[ai] = d16;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BF; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> d0, d1;
      wmma::load_matrix_sync(d0, d_s + kk, ldh);
      wmma::load_matrix_sync(d1, d_s + 16 * ldh + kk, ldh);
#pragma unroll
      for (int j = 0; j < MAXJ; ++j) {
        const int ni = warp + NW * j;
        if (ni < nd) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bw;
          wmma::load_matrix_sync(bw, w1 + (size_t)(f0 + kk) * D + ni * 16, D);  // W1[f0+kk.., ni*16..]
          wmma::mma_sync(acc[2 * j], d0, bw, acc[2 * j]);
          wmma::mma_sync(acc[2 * j + 1], d1, bw, acc[2 * j + 1]);
        }
      }
    }
    __syncthreads();
  }

  float* stage = c_s + warp * 256;
#pragma unroll
  for (int j = 0; j < MAXJ; ++j) {
    const int ni = warp + NW * j;
    if (ni < nd) {
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        wmma::store_matrix_sync(stage, acc[2 * j + mi], 16, wmma::mem_row_major);
        __syncwarp();
        for (int e = lane; e < 256; e += 32) {
          const int row = row0 + mi * 16 + e / 16, col = ni * 16 + e % 16;
          if (row < N) {
            if (partial != nullptr)
              partial[((size_t)split * N + row) * D + col] = stage[e];
            else
              dx[(size_t)row * D + col] = __float2bfloat16(stage[e]);
          }
        }
        __syncwarp();
      }
    }
  }
}

}  // namespace

// partial: fp32 [nsplit, N, D] scratch when nsplit > 1, else unused.
// a_out: bf16 [N, F] pre-activations, or null to skip writing them.
KMB_EXPORT int kmb_ffn_fwd(const void* x, const void* w1, const void* b1, const void* w2,
                           const void* b2, void* y, void* partial, void* a_out, int N,
                           int D, int F, int nsplit, int tiles_per_split, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  const size_t smem = smem_bytes(D);
  cudaError_t err = kmb_allow_smem(ffn_fwd_kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((N + BM - 1) / BM, nsplit);
  float* part = nsplit > 1 ? (float*)partial : nullptr;
  ffn_fwd_kernel<<<grid, NW * 32, smem, s>>>((const bf16*)x, (const bf16*)w1,
                                              (const float*)b1, (const bf16*)w2,
                                              (const float*)b2, (bf16*)y, part,
                                              (bf16*)a_out, N, D, F, tiles_per_split);
  err = cudaGetLastError();
  if (err != cudaSuccess || nsplit == 1) return err;
  const size_t n = (size_t)N * D;
  ffn_finalize_kernel<<<(unsigned)((n + 255) / 256), 256, 0, s>>>(
      part, (const float*)b2, (bf16*)y, N, D, nsplit);
  return cudaGetLastError();
}

// partial: fp32 [nsplit, N, D] scratch when nsplit > 1, else unused.
KMB_EXPORT int kmb_ffn_bwd(const void* g, const void* a, const void* w1, const void* w2,
                           void* da, void* dx, void* partial, int N, int D, int F,
                           int nsplit, int tiles_per_split, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  const size_t smem = smem_bytes(D);
  cudaError_t err = kmb_allow_smem(ffn_bwd_kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((N + BM - 1) / BM, nsplit);
  float* part = nsplit > 1 ? (float*)partial : nullptr;
  ffn_bwd_kernel<<<grid, NW * 32, smem, s>>>((const bf16*)g, (const bf16*)a, (const bf16*)w1,
                                              (const bf16*)w2, (bf16*)da, (bf16*)dx, part, N, D,
                                              F, tiles_per_split);
  err = cudaGetLastError();
  if (err != cudaSuccess || nsplit == 1) return err;
  const size_t n = (size_t)N * D;
  ffn_finalize_kernel<<<(unsigned)((n + 255) / 256), 256, 0, s>>>(part, nullptr, (bf16*)dx,
                                                                   N, D, nsplit);
  return cudaGetLastError();
}
