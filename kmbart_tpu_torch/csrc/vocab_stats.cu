// K4: per-chunk vocab statistics and each row's exact top-k, in one pass
// over the logits.
//
// Replaces kmbart_tpu/ops/pallas_vocab_stats.py:60 chunk_stats (body
// _stats_kernel :44) together with the selections the JAX package runs on
// its output or beside it: topk_from_chunk_stats (the beam step,
// kmbart_tpu/ops/topk.py:108), radix_top_k (fast sampling, :189) and
// exact_top_k's chunk-max route over long rows (:35, :47).
//
// What it computes, for row r of x [R, N] fp32 and chunk c of `chunk`
// columns:
//   cm[r, c] = max(x[r, c*chunk : (c+1)*chunk])
//   es[r, c] = sum(exp(x - max(cm[r, c], FINITE_MIN)))
//   values[r, :k], indices[r, :k] = the k largest entries of row r, values
//     descending, equal values lowest column first (lax.top_k's order, the
//     stable descending sort's), -0.0 equal to +0.0; values are x's own bits.
// Columns past N (the ragged tail chunk) count as -inf for the statistics
// and are never selected. A chunk that is entirely -inf (the forced BOS/EOS
// steps) gives (-inf, 0) instead of NaN, thanks to the finite shift.
//
// What bounds it on an H100: bytes. The statistics and the selection read
// the fp32 logits once, 320 x 50320 x 4 B = 64 MB at the beam step's shape,
// about 19 us at the card's 3.35 TB/s; the chunk candidates it writes and
// reads back are 2% of that at k 10.
//
// Design. Stage 1 (vocab_stats_topk_kernel), a block of 256 threads per
// (row, chunk of 1024 columns): each thread loads 4 columns with one 16-byte
// load (rows whose pitch is a multiple of 4 floats) and keeps them in
// registers; the block reduces the max and the exp-sum from them, then
// selects the chunk's k largest 64-bit keys
//   key = ordered_u32(v) << 32 | (0xFFFFFFFF - column)
// (one unsigned compare orders by value descending, then column ascending;
// every key of a row is distinct) by a radix select over 8-bit digits: a
// 256-bin shared histogram a round counts the keys that match the digits
// fixed so far, and one warp picks the digit that holds the k-th largest.
// The select stops as soon as the keys at or above the prefix are exactly
// k, usually after two or three rounds; ties of value (constant rows, -inf
// stripes) take up to eight. The chunk's k survivors go out unsorted to
// [R, C, k]. Stage 2 (topk_merge_kernel), a block per row, runs the same
// select over the row's C*k candidates, ranks the k survivors among
// themselves and writes them in order. A TPU walks the chunks greedily, k
// dependent steps (topk.py:108), or counts 2-bit digits over the whole row
// 16 times (:189); here the row is read once and every chunk selects at
// once on its own SM.
#include "common.cuh"

namespace {

constexpr float kFiniteMin = -3.0e38f;  // pallas_vocab_stats.FINITE_MIN
constexpr int kThreads = 256;
constexpr int kChunk = 1024;            // columns a stage-1 block
constexpr int kPerThread = kChunk / kThreads;
constexpr int kBins = 256;              // one 8-bit digit of a key a round
// the largest k: a chunk hands over at most its columns, and the merge
// ranks its survivors in shared memory; ops/vocab_stats.py routes a larger
// k to the stable sort
constexpr int kMaxK = 1024;

typedef unsigned long long u64;

// -0.0 takes +0.0's key, so the two tie and go by column as in a sort
__device__ __forceinline__ u64 make_key(float v, int col) {
  const unsigned int u = __float_as_uint(v == 0.f ? 0.f : v);
  const unsigned int ord = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return ((u64)ord << 32) | (u64)(0xFFFFFFFFu - (unsigned int)col);
}

__device__ __forceinline__ int key_col(u64 key) {
  return (int)(0xFFFFFFFFu - (unsigned int)(key & 0xFFFFFFFFull));
}

struct SelectSmem {
  unsigned int hist[kBins];
  u64 prefix;
  unsigned int remaining;
  int done;
  unsigned int count;
};

// The radix select shared by both stages. `each(f)` calls f(key) for every
// key this thread owns (distinct keys; at least k of them in the block).
// Returns t such that exactly k of the block's keys are >= t. All threads
// of the block call it; it ends with the block synchronised.
template <typename Each>
__device__ u64 select_threshold(Each each, unsigned int k, SelectSmem& s) {
  u64 prefix = 0, mask = 0;
  unsigned int remaining = k;
  for (int shift = 56; shift >= 0; shift -= 8) {
    for (int b = threadIdx.x; b < kBins; b += blockDim.x) s.hist[b] = 0;
    __syncthreads();
    each([&](u64 key) {
      if ((key & mask) == prefix) {
        // plain shared atomics: on the H100 they beat warp-aggregated ones
        // (__match_any_sync, or one atomic for a warp of ties) on random,
        // tied and forced rows alike
        atomicAdd(&s.hist[(unsigned int)(key >> shift) & 0xFFu], 1u);
      }
    });
    __syncthreads();
    if (threadIdx.x < 32) {
      // lane l holds bins [8l, 8l + 8); the digit is the highest bin whose
      // count from the top reaches `remaining`
      const int lane = threadIdx.x;
      unsigned int c[8], local = 0;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        c[j] = s.hist[lane * 8 + j];
        local += c[j];
      }
      unsigned int suffix = local;  // bins of this lane and every lane above
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const unsigned int up = __shfl_down_sync(0xffffffffu, suffix, o);
        if (lane + o < 32) suffix += up;
      }
      unsigned int above = suffix - local;
      if (above < remaining && remaining <= suffix) {
        for (int j = 7; j >= 0; --j) {
          if (above + c[j] >= remaining) {
            s.prefix = prefix | ((u64)(lane * 8 + j) << shift);
            s.remaining = remaining - above;
            s.done = c[j] == remaining - above;
            break;
          }
          above += c[j];
        }
      }
    }
    __syncthreads();
    prefix = s.prefix;
    remaining = s.remaining;
    mask |= 0xFFull << shift;
    // every key of the chosen bin is taken: the keys >= prefix (lower
    // digits 0) are exactly k. With distinct keys this holds by the last
    // round at the latest. s.* is next written two barriers on.
    if (s.done) break;
  }
  return prefix;
}

__global__ void __launch_bounds__(kThreads)
vocab_stats_topk_kernel(const float* __restrict__ x, float* __restrict__ cm,
                        float* __restrict__ es, u64* __restrict__ keys_out, int N, int C,
                        int k, int vec4) {
  __shared__ float red[kThreads / 32];
  __shared__ SelectSmem sel;
  const int r = blockIdx.x / C, c = blockIdx.x % C;
  const float* row = x + (size_t)r * N;
  const int lo = c * kChunk;
  const int n = min(kChunk, N - lo);  // this chunk's columns
  const int t = threadIdx.x, warp = t / 32, lane = t % 32;
  const int first = kPerThread * t;   // thread t holds columns lo + first .. + 3

  float v[kPerThread];
  if (vec4 && first + kPerThread <= n) {
    const float4 q = *reinterpret_cast<const float4*>(row + lo + first);
    v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
  } else {
#pragma unroll
    for (int j = 0; j < kPerThread; ++j)
      v[j] = first + j < n ? row[lo + first + j] : -INFINITY;
  }

  if (cm != nullptr) {
    float m = fmaxf(fmaxf(v[0], v[1]), fmaxf(v[2], v[3]));
    m = warp_max(m);
    if (lane == 0) red[warp] = m;
    __syncthreads();
    m = red[0];
    for (int w = 1; w < kThreads / 32; ++w) m = fmaxf(m, red[w]);
    __syncthreads();
    const float shift = fmaxf(m, kFiniteMin);
    float s = 0.f;
#pragma unroll
    for (int j = 0; j < kPerThread; ++j) s += expf(v[j] - shift);
    s = warp_sum(s);
    if (lane == 0) red[warp] = s;
    __syncthreads();
    if (t == 0) {
      float total = 0.f;
      for (int w = 0; w < kThreads / 32; ++w) total += red[w];
      cm[(size_t)r * C + c] = m;
      es[(size_t)r * C + c] = total;
    }
  }
  if (k == 0) return;

  u64* out = keys_out + ((size_t)r * C + c) * k;
  if (n <= k) {
    // every column is a candidate; key 0 (below any real key) fills the rest
    for (int i = t; i < k; i += kThreads) out[i] = i < n ? make_key(row[lo + i], lo + i) : 0ull;
    return;
  }
  u64 key[kPerThread];
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) key[j] = make_key(v[j], lo + first + j);
  const int owned = max(0, min(kPerThread, n - first));
  if (t == 0) sel.count = 0;
  const u64 thr = select_threshold(
      [&](auto f) {
#pragma unroll
        for (int j = 0; j < kPerThread; ++j)
          if (j < owned) f(key[j]);
      },
      (unsigned int)k, sel);
#pragma unroll
  for (int j = 0; j < kPerThread; ++j)
    if (j < owned && key[j] >= thr) out[atomicAdd(&sel.count, 1u)] = key[j];
}

__global__ void __launch_bounds__(kThreads)
topk_merge_kernel(const float* __restrict__ x, const u64* __restrict__ keys_in,
                  float* __restrict__ values, int64_t* __restrict__ indices, int N, int n,
                  int k) {
  __shared__ SelectSmem sel;
  __shared__ u64 top[kMaxK];
  const int r = blockIdx.x;
  const u64* keys = keys_in + (size_t)r * n;
  if (threadIdx.x == 0) sel.count = 0;
  const u64 thr = select_threshold(
      [&](auto f) {
        for (int i = threadIdx.x; i < n; i += kThreads) f(keys[i]);
      },
      (unsigned int)k, sel);
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const u64 key = keys[i];
    if (key >= thr) top[atomicAdd(&sel.count, 1u)] = key;
  }
  __syncthreads();
  // rank each survivor among the k (distinct keys: ranks 0..k-1 once each)
  for (int i = threadIdx.x; i < k; i += kThreads) {
    const u64 key = top[i];
    int rank = 0;
    for (int j = 0; j < k; ++j) rank += top[j] > key;
    const int col = key_col(key);
    values[(size_t)r * k + rank] = x[(size_t)r * N + col];
    indices[(size_t)r * k + rank] = col;
  }
}

}  // namespace

// cm and es null: statistics off. k 0: selection off (keys unused).
// keys: [R, C, k] 64-bit scratch for kmb_topk_merge. vec4: x's rows start
// on 16-byte boundaries (N % 4 == 0 and x aligned).
KMB_EXPORT int kmb_vocab_stats_topk(const void* x, void* cm, void* es, void* keys, int R,
                                    int N, int chunk, int k, int vec4, void* stream) {
  if (chunk != kChunk || k < 0 || k > kMaxK || k > N) return (int)cudaErrorInvalidValue;
  const int C = (N + chunk - 1) / chunk;
  vocab_stats_topk_kernel<<<(unsigned int)R * C, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)x, (float*)cm, (float*)es, (u64*)keys, N, C, k, vec4);
  return cudaGetLastError();
}

// The row's top-k from kmb_vocab_stats_topk's [R, C, k] keys: values fp32
// (x's bits) and int64 indices, [R, k] each, sorted.
KMB_EXPORT int kmb_topk_merge(const void* x, const void* keys, void* values, void* indices,
                              int R, int N, int C, int k, void* stream) {
  if (k < 1 || k > kMaxK || k > N) return (int)cudaErrorInvalidValue;
  topk_merge_kernel<<<R, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)x, (const u64*)keys, (float*)values, (int64_t*)indices, N, C * k, k);
  return cudaGetLastError();
}
