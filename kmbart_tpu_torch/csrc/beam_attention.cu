// K3: one decode step of self-attention over the beam-stationary cache.
//
// Replaces kmbart_tpu/ops/pallas_beam_attention.py:214 beam_gather_attention
// (kernel _kernel :205, math _attend :153), the decoder self-attention of
// every beam step.
//
// What it computes, for live beam r = b*K + q, head h (hd = D / H):
//   for t <= cache_index:  j_t = ancestry[r, t]       slot holding position t
//     s_t = sum_d bf16(q[r, h, d]) * bf16(k[b, j_t, t, h, d])        fp32
//   p_t = bf16(softmax_t(s))                                          fp32 softmax
//   out[r, h] = sum_t p_t * bf16(v[b, j_t, t, h])                     fp32
// This is the TPU kernel's function: there every (slot, position) pair is
// scored and a one-hot mask sets all but the ancestor entries to -1e9, whose
// exp is exactly 0 in fp32; position 0 is always valid, so the max is finite.
// (The TPU kernel also rounds its output to bf16; the port keeps the fp32 of
// the oracle, beam_gather_attention_reference.)
//
// Ring mode (valid != nullptr): the continuous-batching pool's ring cache,
// which every slot writes at column tick % T (kmbart_tpu/serving/
// continuous.py pool_step, where build_selection_mask_ring,
// pallas_beam_attention.py:87, feeds the same TPU kernel). Sample b's
// positions are the n_b = valid[b] columns ending at column cache_index,
// cyclically; the kernel visits them in logical order, oldest first
// (column (cache_index - n_b + 1 + a) mod T for a = 0 .. n_b - 1), so a slot
// admitted at any tick runs its scores, softmax and P.V sums in the order
// of the offline decode, bit for bit. valid is clamped to [1, T]: an
// inactive slot reads its own newest column and does not fault. It is a
// template parameter, so the scalar-index path compiles as it did.
//
// What bounds it on an H100: bytes and latency. At the main path's shape
// (B 64, K 5, T 32, D 768, H 12) a step reads at most the K and V rows up to
// cache_index, 2 x 320 x 32 x 768 x 2 B = 31 MB per layer at the last step
// (9.4 us at 3.35 TB/s), and computes 63 MFLOP. A query beam's rows are
// scattered over the K slots of its sample, and all K query beams of a
// sample read from the same K x (cache_index + 1) slab of each head.
//
// Design (bf16 cache): a block per (sample, head), 256 threads.
//   1. The sample's K ancestry rows (t <= cache_index), its K queries of the
//      head (rounded to bf16), a zeroed fp32 [K, hd] accumulator and, for
//      each slab row, its place in a chunk buffer (-1 if no beam descends
//      through it) go to shared memory, so the copy loop below does no
//      ancestry test and no division on the main path.
//   2. The slab's rows stream in by 16-byte cp.async copies, eight lanes to
//      a 128-byte head row, in chunks of positions (ops/beam_attention.py
//      beam_plan picks the chunk: the whole slab at the main path's shape),
//      K rows first, then V, two chunks in flight. A (slot, position) row is
//      copied only if some query beam of the sample descends through it, so
//      each row is read at most once per sample and rows no beam needs are
//      never read.
//   3. Scores gather each beam's own ancestor row from shared memory: eight
//      lanes per (beam, position) dot, each lane 8 products of a 16-byte
//      piece (hd / 64 pieces for hd > 64) in fp32, then a butterfly over the
//      eight lanes. There is no all-pairs product and no mask: the gather
//      gives the masked softmax's terms exactly.
//   4. A warp per query beam takes the softmax in fp32 and rounds p to bf16.
//   5. P.V: a thread per (beam, column pair) walks the positions in order,
//      gathering V rows from shared memory; the sums stay fp32.
// The work is 63 MFLOP against 31 MB, so the CUDA cores suffice; the
// tensor cores would buy nothing a byte-bound step can use.
//
// What bounds it, measured (tools/beam_attention_timeline.py, clock64 and
// %globaltimer marks of every block on an H100, and the occupancy API): 5
// blocks run on an SM (shared memory), so the generate step's 768 blocks
// run in two waves (660, then 108) and the serving pool's 1,344 in three;
// at position 0 a block spends a third of its 8,700 cycles before its first
// copy (the prologue's K^2 global ancestry reads), at 31 most of its 17,900
// in the scores and P.V. Grids that fit one wave
// measured slower at position 31: this kernel at 192 threads, 6 blocks an
// SM and 26-position chunks 0.0234 ms against 0.0190 (faster only at
// position 0, 0.0068 against 0.0073), and a block per (sample, group of
// heads) streaming 8- or 16-position stages through mbarriers, fed by one
// producer warp (TMA bulk copies of 128-byte rows, then cp.async) or by
// every thread, 0.021-0.036. With every SM full, a block's phases take
// longer by as much as the one wave saves, and per-chunk waits and
// bookkeeping add to them: the step is bound by each SM's execution of the
// eight-lane dot products and the P.V chains, not by waves. Any number of
// heads (the grid is B x H), any head_dim % 8 == 0 with 16-byte aligned rows.
//
// The fp32-cache instantiations keep a scalar kernel (one block per
// live beam, one warp per head, H <= 32): the port's configurations keep a
// bf16 cache on the card.
#include "common.cuh"

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kThreads = 256;   // the bf16 kernel's block
constexpr int kGroup = 8;       // lanes per dot product: 8 x 16 B = one 64-wide head row

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>  // at most N committed groups still pending
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Shared memory of the bf16 kernel, in bytes (ops/beam_attention.py
// beam_plan computes the same): two chunk buffers [K][chunk][hd] bf16, the
// queries [K][hd] bf16, the ancestry [K][n] int32, the scores, then p,
// [K][n] fp32, the accumulator [K][hd] fp32, and for each slab row (j, t)
// its place in a chunk buffer (or -1) and its row in the cache, [K][n]
// int32 each.
__host__ __device__ inline size_t beam_smem_bytes(int K, int n, int hd, int chunk) {
  return (size_t)2 * K * chunk * hd * 2 + (size_t)K * hd * 2 + (size_t)K * n * 16 +
         (size_t)K * hd * 4;
}

// Copies chunk `load` (K rows for load < nchunks, then V) of the slab into
// buffer load % 2: the rows (j, t), t in [t0, t0 + cnt), that some query
// beam's ancestry passes through (dst_s[j n + t] >= 0: the row's place in
// the buffer; src_s: its row j T + t of the cache). k_bh and v_bh point at
// the block's (sample, head); rows are D apart. PIECES is hd / 8 (the
// 16-byte pieces of a head row), a constant at the main path's width.
template <int PIECES>
__device__ __forceinline__ void issue_chunk(int load, int nchunks, int chunk, int n,
                                            const bf16* k_bh, const bf16* v_bh, bf16* bufs,
                                            const int* dst_s, const int* src_s, int K, int D,
                                            int hd) {
  const int t0 = (load % nchunks) * chunk, cnt = min(chunk, n - t0);
  const bf16* src = load < nchunks ? k_bh : v_bh;
  bf16* dst = bufs + (size_t)(load & 1) * K * chunk * hd;
  const int pieces = PIECES > 0 ? PIECES : hd / 8;
  for (int i = threadIdx.x; i < K * cnt * pieces; i += kThreads) {
    const int piece = i % pieces, r = i / pieces;
    const int row = nchunks == 1 ? r : (r / cnt) * n + t0 + r % cnt;  // j n + t
    const int at = dst_s[row];
    if (at >= 0)
      cp_async16(dst + (size_t)at * hd + 8 * piece, src + (size_t)src_s[row] * D + 8 * piece);
  }
  cp_async_commit();
}

template <typename TQ, int PIECES, bool RING>
__global__ void __launch_bounds__(kThreads)
    beam_attention_bf16(const TQ* __restrict__ q, const bf16* __restrict__ kc,
                        const bf16* __restrict__ vc, const int* __restrict__ ancestry,
                        const int* __restrict__ valid, float* __restrict__ out, int K, int T,
                        int D, int H, int cache_index, int chunk) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int hd = PIECES > 0 ? 8 * PIECES : D / H;
  // positions a = 0 .. n - 1; a's cache column is RING ? (first + a) % T : a
  const int n = RING ? min(max(valid[b], 1), T) : cache_index + 1;
  const int first = RING ? cache_index - n + 1 + T : 0;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  bf16* bufs = reinterpret_cast<bf16*>(smem);
  bf16* q_s = bufs + (size_t)2 * K * chunk * hd;
  int* anc_s = reinterpret_cast<int*>(q_s + K * hd);
  float* p_s = reinterpret_cast<float*>(anc_s + K * n);
  float* acc_s = p_s + K * n;
  int* dst_s = reinterpret_cast<int*>(acc_s + K * hd);
  int* src_s = dst_s + K * n;
  const int* anc_b = ancestry + (size_t)b * K * T;
  const size_t bh = (size_t)b * K * T * D + (size_t)h * hd;

  // the ancestry, and where each slab row (j, t) that a beam descends
  // through goes (each thread reads the K entries of its position from
  // global memory, so this needs no second barrier)
  for (int i = tid; i < K * n; i += kThreads) {
    const int j = i / n, a = i - j * n;
    const int t = RING ? (first + a) % T : a;
    anc_s[i] = anc_b[(size_t)j * T + t];
    bool used = false;
    for (int qb = 0; qb < K; ++qb) used |= anc_b[(size_t)qb * T + t] == j;
    dst_s[i] = used ? j * chunk + a % chunk : -1;
    src_s[i] = j * T + t;
  }
  for (int i = tid; i < K * hd; i += kThreads) {
    const int qb = i / hd, d = i - qb * hd;
    q_s[i] = __float2bfloat16(to_f(q[((size_t)b * K + qb) * D + (size_t)h * hd + d]));
    acc_s[i] = 0.f;
  }
  __syncthreads();

  const int nchunks = (n + chunk - 1) / chunk, nloads = 2 * nchunks;
  const int pieces = hd / 8, grp = tid / kGroup, gl = tid % kGroup;
  issue_chunk<PIECES>(0, nchunks, chunk, n, kc + bh, vc + bh, bufs, dst_s, src_s, K, D, hd);
  issue_chunk<PIECES>(1, nchunks, chunk, n, kc + bh, vc + bh, bufs, dst_s, src_s, K, D, hd);
  for (int load = 0; load < nloads; ++load) {
    if (load + 1 < nloads) cp_async_wait<1>();
    else cp_async_wait<0>();
    __syncthreads();
    const bf16* buf = bufs + (size_t)(load & 1) * K * chunk * hd;
    const int t0 = (load % nchunks) * chunk, cnt = min(chunk, n - t0);
    if (load < nchunks) {
      // scores of the chunk's (beam, position) pairs; the loop is uniform
      // across each warp, so its four groups shuffle together
      for (int base = warp * (32 / kGroup); base < K * cnt; base += kThreads / kGroup) {
        const int pair = base + grp % (32 / kGroup);
        float s = 0.f;
        if (pair < K * cnt) {
          const int qb = pair / cnt, t = t0 + pair % cnt;
          const bf16* krow = buf + ((size_t)anc_s[qb * n + t] * chunk + (t - t0)) * hd;
          const bf16* qrow = q_s + qb * hd;
          for (int c = gl; c < pieces; c += kGroup) {
            const uint4 kv = *reinterpret_cast<const uint4*>(krow + 8 * c);
            const uint4 qv = *reinterpret_cast<const uint4*>(qrow + 8 * c);
            const __nv_bfloat162* k2 = reinterpret_cast<const __nv_bfloat162*>(&kv);
            const __nv_bfloat162* q2 = reinterpret_cast<const __nv_bfloat162*>(&qv);
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const float2 kf = __bfloat1622float2(k2[e]), qf = __bfloat1622float2(q2[e]);
              s = fmaf(qf.x, kf.x, s);
              s = fmaf(qf.y, kf.y, s);
            }
          }
        }
#pragma unroll
        for (int o = kGroup / 2; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
        if (pair < K * cnt && gl == 0) p_s[(pair / cnt) * n + t0 + pair % cnt] = s;
      }
      if (load == nchunks - 1) {
        __syncthreads();
        // p = bf16(softmax(s)), a warp per query beam
        for (int qb = warp; qb < K; qb += kThreads / 32) {
          float* row = p_s + qb * n;
          float m = -INFINITY;
          for (int t = lane; t < n; t += 32) m = fmaxf(m, row[t]);
          m = warp_max(m);
          float l = 0.f;
          for (int t = lane; t < n; t += 32) {
            const float e = expf(row[t] - m);
            row[t] = e;
            l += e;
          }
          l = warp_sum(l);
          for (int t = lane; t < n; t += 32) row[t] = round_bf16(row[t] / l);
        }
      }
    } else {
      // out += p . V over the chunk, a thread per (beam, column pair)
      const int pairs = hd / 2;
      for (int i = tid; i < K * pairs; i += kThreads) {
        const int qb = i / pairs, c = 2 * (i % pairs);
        float2 a = *reinterpret_cast<float2*>(acc_s + qb * hd + c);
#pragma unroll 4
        for (int t = t0; t < t0 + cnt; ++t) {
          const float p = p_s[qb * n + t];
          const float2 v = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
              buf + ((size_t)anc_s[qb * n + t] * chunk + (t - t0)) * hd + c));
          a.x = fmaf(p, v.x, a.x);
          a.y = fmaf(p, v.y, a.y);
        }
        *reinterpret_cast<float2*>(acc_s + qb * hd + c) = a;
      }
    }
    __syncthreads();  // the buffer is read: it may take chunk load + 2
    if (load + 2 < nloads)
      issue_chunk<PIECES>(load + 2, nchunks, chunk, n, kc + bh, vc + bh, bufs, dst_s, src_s, K,
                          D, hd);
  }
  for (int i = tid; i < K * hd; i += kThreads)
    out[((size_t)b * K + i / hd) * D + (size_t)h * hd + i % hd] = acc_s[i];
}

// The scalar kernel of the fp32 cache: one block per live beam, one warp
// per head; lanes own positions for the scores and split head_dim for P.V.
template <typename TQ, typename TC>
__global__ void beam_attention_scalar(const TQ* __restrict__ q, const TC* __restrict__ kc,
                                      const TC* __restrict__ vc,
                                      const int* __restrict__ ancestry,
                                      const int* __restrict__ valid,
                                      float* __restrict__ out, int K, int T, int D, int hd,
                                      int cache_index) {
  extern __shared__ float smem_f[];
  const int r = blockIdx.x;  // live beam b*K + q
  const int b = r / K;
  const int h = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  float* q_w = smem_f + h * (hd + T);
  float* p_w = q_w + hd;
  // positions in logical order, as in the bf16 kernel's ring mode
  const int n = valid ? min(max(valid[b], 1), T) : cache_index + 1;
  const int first = valid ? cache_index - n + 1 + T : 0;
  auto col = [&](int a) { return valid ? (first + a) % T : a; };
  const int* anc = ancestry + (size_t)r * T;
  const size_t hcol = (size_t)h * hd;

  for (int d = lane; d < hd; d += 32) q_w[d] = round_bf16(to_f(q[(size_t)r * D + hcol + d]));
  __syncwarp();

  float m = -INFINITY;
  for (int t = lane; t < n; t += 32) {
    const int c = col(t);
    const TC* k_row = kc + (((size_t)b * K + anc[c]) * T + c) * D + hcol;
    float s = 0.f;
    for (int d = 0; d < hd; ++d) s = fmaf(q_w[d], round_bf16(to_f(k_row[d])), s);
    p_w[t] = s;
    m = fmaxf(m, s);
  }
  m = warp_max(m);
  float l = 0.f;
  for (int t = lane; t < n; t += 32) {
    const float e = expf(p_w[t] - m);
    p_w[t] = e;
    l += e;
  }
  l = warp_sum(l);
  for (int t = lane; t < n; t += 32) p_w[t] = round_bf16(p_w[t] / l);
  __syncwarp();

  for (int d = lane; d < hd; d += 32) {
    float acc = 0.f;
    for (int t = 0; t < n; ++t) {
      const int c = col(t);
      const TC* v_row = vc + (((size_t)b * K + anc[c]) * T + c) * D + hcol;
      acc = fmaf(p_w[t], round_bf16(to_f(v_row[d])), acc);
    }
    out[(size_t)r * D + hcol + d] = acc;
  }
}

template <typename TQ, int PIECES, bool RING>
cudaError_t launch_bf16_hd(const void* q, const void* kc, const void* vc, const int* anc,
                           const int* valid, float* out, int B, int K, int T, int D, int H,
                           int cache_index, int chunk, cudaStream_t stream) {
  // a ring call is sized for all T columns: no block holds more
  const size_t smem = beam_smem_bytes(K, RING ? T : cache_index + 1, D / H, chunk);
  cudaError_t err = kmb_allow_smem(beam_attention_bf16<TQ, PIECES, RING>, smem);
  if (err != cudaSuccess) return err;
  beam_attention_bf16<TQ, PIECES, RING><<<B * H, kThreads, smem, stream>>>(
      (const TQ*)q, (const bf16*)kc, (const bf16*)vc, anc, valid, out, K, T, D, H,
      cache_index, chunk);
  return cudaGetLastError();
}

template <typename TQ, int PIECES>
cudaError_t launch_bf16_mode(const void* q, const void* kc, const void* vc, const int* anc,
                             const int* valid, float* out, int B, int K, int T, int D, int H,
                             int cache_index, int chunk, cudaStream_t stream) {
  if (valid)
    return launch_bf16_hd<TQ, PIECES, true>(q, kc, vc, anc, valid, out, B, K, T, D, H,
                                            cache_index, chunk, stream);
  return launch_bf16_hd<TQ, PIECES, false>(q, kc, vc, anc, valid, out, B, K, T, D, H,
                                           cache_index, chunk, stream);
}

// head_dim 64 (BART-base's) with its row pieces as a constant, others generic
template <typename TQ>
cudaError_t launch_bf16(const void* q, const void* kc, const void* vc, const int* anc,
                        const int* valid, float* out, int B, int K, int T, int D, int H,
                        int cache_index, int chunk, cudaStream_t stream) {
  const int hd = D / H;
  if (hd % 8 || chunk < 1) return cudaErrorInvalidValue;
  if (hd == 64)
    return launch_bf16_mode<TQ, 8>(q, kc, vc, anc, valid, out, B, K, T, D, H, cache_index,
                                   chunk, stream);
  return launch_bf16_mode<TQ, 0>(q, kc, vc, anc, valid, out, B, K, T, D, H, cache_index,
                                 chunk, stream);
}

template <typename TQ>
cudaError_t launch_scalar(const void* q, const void* kc, const void* vc, const int* anc,
                          const int* valid, float* out, int B, int K, int T, int D, int H,
                          int cache_index, cudaStream_t stream) {
  const int hd = D / H;
  if (H > 32) return cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * (size_t)H * (hd + T);
  cudaError_t err = kmb_allow_smem(beam_attention_scalar<TQ, float>, smem);
  if (err != cudaSuccess) return err;
  beam_attention_scalar<TQ, float><<<B * K, H * 32, smem, stream>>>(
      (const TQ*)q, (const float*)kc, (const float*)vc, anc, valid, out, K, T, D, hd,
      cache_index);
  return cudaGetLastError();
}

}  // namespace

// chunk: positions per shared-memory chunk of the bf16 kernel (ops/
// beam_attention.py beam_plan); the fp32 cache ignores it. valid: int32 [B],
// the ring mode's window lengths (cache_index is then the ring column), or
// null for positions [0, cache_index].
KMB_EXPORT int kmb_beam_attention(const void* q, int q_dtype, const void* k_cache,
                                  const void* v_cache, int cache_dtype,
                                  const void* ancestry, const void* valid, void* out, int B,
                                  int K, int T, int D, int H, int cache_index, int chunk,
                                  void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  const int* anc = (const int*)ancestry;
  const int* vld = (const int*)valid;
  float* o = (float*)out;
  if (cache_dtype == KMB_BF16) {
    if (q_dtype == KMB_BF16)
      return launch_bf16<__nv_bfloat16>(q, k_cache, v_cache, anc, vld, o, B, K, T, D, H,
                                        cache_index, chunk, s);
    if (q_dtype == KMB_F32)
      return launch_bf16<float>(q, k_cache, v_cache, anc, vld, o, B, K, T, D, H, cache_index,
                                chunk, s);
  } else if (cache_dtype == KMB_F32) {
    if (q_dtype == KMB_BF16)
      return launch_scalar<__nv_bfloat16>(q, k_cache, v_cache, anc, vld, o, B, K, T, D, H,
                                          cache_index, s);
    if (q_dtype == KMB_F32)
      return launch_scalar<float>(q, k_cache, v_cache, anc, vld, o, B, K, T, D, H,
                                  cache_index, s);
  }
  return cudaErrorInvalidValue;
}

// The blocks of the bf16 kernel (bf16 queries; ring: its ring mode) that
// one SM holds at once for K beams, n positions and `chunk`
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor), into blocks (an int).
KMB_EXPORT int kmb_beam_attention_occupancy(int K, int D, int H, int ring, int n, int chunk,
                                            void* blocks) {
  const int hd = D / H;
  if (hd % 8 || chunk < 1 || n < 1) return cudaErrorInvalidValue;
  const size_t smem = beam_smem_bytes(K, n, hd, chunk);
  auto query = [&](auto kernel) {
    cudaError_t err = kmb_allow_smem(kernel, smem);
    if (err != cudaSuccess) return err;
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(static_cast<int*>(blocks), kernel,
                                                         kThreads, smem);
  };
  if (hd == 64)
    return ring ? query(beam_attention_bf16<__nv_bfloat16, 8, true>)
                : query(beam_attention_bf16<__nv_bfloat16, 8, false>);
  return ring ? query(beam_attention_bf16<__nv_bfloat16, 0, true>)
              : query(beam_attention_bf16<__nv_bfloat16, 0, false>);
}
