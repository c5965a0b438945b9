// K4: per-chunk vocab statistics for the beam candidate step.
//
// Replaces kmbart_tpu/ops/pallas_vocab_stats.py:60 chunk_stats (body
// _stats_kernel :44), run on the [B*K, V] logits at every beam step.
//
// What it computes, for row r and chunk c of `chunk` columns:
//   cm[r, c] = max(x[r, c*chunk : (c+1)*chunk])
//   es[r, c] = sum(exp(x - max(cm[r, c], FINITE_MIN)))
// Columns past V (the ragged tail chunk) count as -inf: they never win the
// max and add exp(-inf) = 0. A chunk that is entirely -inf (the forced
// BOS/EOS steps) gives (-inf, 0) instead of NaN, thanks to the finite shift.
//
// What bounds it on an H100: bytes. One pass reads the fp32 logits once,
// 320 x 50320 x 4 B = 64 MB at the main path's shape, about 19 us at the
// card's 3.35 TB/s. Design: the logits are read in place (no padded copy as
// pad_to_chunks makes on the TPU); one block of 256 threads per
// (chunk, row) reads its chunk coalesced, then block-reduces the max and
// the exp-sum.
#include "common.cuh"

namespace {

constexpr float kFiniteMin = -3.0e38f;  // pallas_vocab_stats.FINITE_MIN
constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
vocab_stats_kernel(const float* __restrict__ x, float* __restrict__ cm,
                   float* __restrict__ es, int V, int C, int chunk) {
  __shared__ float red[kThreads / 32];
  const int c = blockIdx.x;
  const int r = blockIdx.y;
  const float* row = x + (size_t)r * V;
  const int lo = c * chunk;
  const int hi = min(lo + chunk, V);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  float m = -INFINITY;
  for (int i = lo + threadIdx.x; i < hi; i += kThreads) m = fmaxf(m, row[i]);
  m = warp_max(m);
  if (lane == 0) red[warp] = m;
  __syncthreads();
  m = red[0];
  for (int w = 1; w < kThreads / 32; ++w) m = fmaxf(m, red[w]);
  __syncthreads();

  const float shift = fmaxf(m, kFiniteMin);
  float s = 0.f;
  for (int i = lo + threadIdx.x; i < hi; i += kThreads) s += expf(row[i] - shift);
  s = warp_sum(s);
  if (lane == 0) red[warp] = s;
  __syncthreads();
  if (threadIdx.x == 0) {
    float total = 0.f;
    for (int w = 0; w < kThreads / 32; ++w) total += red[w];
    cm[(size_t)r * C + c] = m;
    es[(size_t)r * C + c] = total;
  }
}

}  // namespace

KMB_EXPORT int kmb_vocab_stats(const void* logits, void* cm, void* es, int R, int V,
                               int chunk, void* stream) {
  const int C = (V + chunk - 1) / chunk;
  vocab_stats_kernel<<<dim3(C, R), kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)logits, (float*)cm, (float*)es, V, C, chunk);
  return cudaGetLastError();
}
