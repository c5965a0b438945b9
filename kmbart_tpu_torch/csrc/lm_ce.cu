// K7, K8, K9 and K10: the tied LM head fused with the ignore-index
// cross-entropy, modes "fwdbwd" (K7 + K8) and "nomat" (K9 + K10) of
// kmbart_tpu/ops/pallas_lm_ce.py.
//
// K7 replaces _fwd_project_stats_call (pallas_lm_ce.py:250, body
// _fwd_project_stats_kernel :193):
//   logits[n, v] = bf16(sum_d h[n, d] W[v, d] + bias[v])       fp32 accumulation
//   m[n]  = max_v logits,  se[n] = sum_v exp(logits - m),  ll[n] = logits[n, label[n]]
// with the statistics taken on the bf16-rounded logits, as on the TPU.
// K8 replaces _bwd_call (pallas_lm_ce.py:289, body _bwd_kernel :53):
//   dlogits[n, v] = bf16(scale[n] (exp(logits - m[n]) inv_se[n] - [v == label[n]]))
//   dh[n, :]      = bf16(sum_v dlogits[n, v] W[v, :])
// K9 replaces _fwd_stats_call (pallas_lm_ce.py:348, body _fwd_stats_kernel
// :146): K7's statistics without the [N, V] logits ever reaching memory.
// K10 replaces _recompute_bwd_call (pallas_lm_ce.py:317, body
// _recompute_bwd_kernel :105): K8's outputs with each logits tile recomputed
// from (h, W, bias) instead of read.
// Labels arrive already made safe (-100 -> 0); the valid mask is in scale.
// dW = dlogits^T h stays a library matmul outside (pallas_lm_ce.py:426-431).
//
// What bounds them on an H100: each is one GEMM of 2 x N x V x D FLOP (396
// GFLOP at N 5120, V 50320, D 768; 712 at the pretraining head's N 9216), so
// tensor-core FLOPs (0.40 and 0.72 ms at 989 TFLOP/s); the logits and
// dlogits are 515 MB each in bf16 at N 5120 (0.15 ms of HBM time each at
// 3.35 TB/s). The TPU walked the vocab sequentially and carried (m, se, ll)
// and the dh accumulator in VMEM across grid steps. Hopper has no ordered
// grid, so:
//   K7 runs the [N, V] = h @ W^T product on the persistent wgmma + TMA main
//      loop of wgmma_gemm.cuh (A = h K-major, B = W [V, D] K-major, K = D =
//      768) on 256 x 128 tiles that both consumer warpgroups share, 128 rows
//      apiece (LogitsCoop, ops/lm_ce.py coop_plan), with its EPI_STATS
//      epilogue: bias, bf16 rounding, the logits tile out by TMA, and from
//      the same rounded values in registers one partial (max, exp-sum, label
//      logit) per row and 128-column tile into [3, N, ceil(V / 128)]; a
//      second pass merges a row's partials in a fixed order (as K4 does).
//      Each element's sum is the chain it had on 128-row tiles, so the
//      outputs are those of that layout bit for bit. A 64-deep slice moves
//      48 KB for 2 M MACs where 128 x 128 tiles moved 32 KB for 1 M: their
//      main loop waited for data at every slice with the ring full (a
//      clock64 timeline on an H100: a slice every 1,000 cycles for 512 of
//      tensor work, the epilogue hidden under the other consumer's main
//      loop). The cooperative epilogue is exposed (about 5,000 cycles of a
//      22,000-cycle tile), and the ring keeps four 48 KB stages (with
//      three it waited for data a third of the time, 19,400 cycles a
//      tile's main loop against 16,500) only because each consumer's tile
//      buffer is half a tile: the first 64 columns leave while the
//      statistics are taken, the last 64 once that store has read the
//      buffer. On an H100 that is 4% under the 128-row tiles at N 5120 and
//      even at 9216, where the main loop slows beside the logits' stores.
//      The tiles walk rows fastest: W (77 MB) is larger than the 50 MB L2,
//      and walked columns fastest each row block would stream all of it from
//      HBM (3 GB at N 5120), where rows fastest reads each 196 KB W slice
//      once while h (7.9 MB at N 5120) stays in L2. TMA wants 16-byte row
//      pitches, so for a vocab that is not a multiple of 8 the logits live in
//      an [N, ceil(V / 8) x 8] buffer (the wrapper returns the [:, :V] view;
//      the store's map spans the pitch, so the pad columns get bf16(0 + 0) =
//      0), and K8 reads them at that pitch;
//   K9 is K7's projection and statistics with no store, on the same tiles
//      with no tile buffers (StatsCoop: four stages in their room): the same
//      accumulator chains, rounding, partials and merge, so its statistics
//      equal K7's bit for bit, and no [N, V] tensor reaches memory;
//   K8 is one launch of its own kernel (lm_ce_bwd.cu, its source note): the
//      dlogits formed on chip from each logits slice, stored once by TMA
//      into an [N, ceil(V / 8) x 8] buffer with zero pad columns (the dW
//      product reads them; the wrapper returns the [:, :V] view), and fed
//      as wgmma's A straight into the dh product, 64 rows across the whole
//      of D in registers; the vocab walk split in parts summed in part
//      order (ops/lm_ce.py bwd_plan) when 64-row units alone would leave
//      SMs idle. The dlogits never come back from memory;
//   K10 cannot keep the TPU's [tn, D] fp32 dh accumulator beside a
//      recomputed logits tile (the projection's accumulators already fill
//      the registers), so it runs in two passes: K7's projection with the
//      EPI_DLOGITS epilogue, which rounds the logits as K7 does, forms the
//      dlogits in registers with the function K8 uses (kmb_wg::dlogit) and
//      stores them in bf16 by TMA into K8's padded buffer (the dW product
//      needs them anyway, pallas_lm_ce.py:426-431), then a dh pass of its
//      own (lm_ce_bwd.cu dh_tiles: units of 128 rows by a 384-column half
//      of D, the dlogits loaded as A, both MMA warpgroups on one W slice)
//      on K8's vocab parts (ops/lm_ce.py dh_plan), each dh element the
//      same wgmma chain K8's kernel runs for it. K10's outputs thus equal
//      K8's on K7's logits bit for bit. The price against one fused pass is
//      a second read of the dlogits, N x V x 2 bytes (0.93 GB, about 0.3 ms
//      at N 9216). The first pass runs on K9's 256-row cooperative tiles
//      (DlogitsCoop: its two tile buffers and three stages); its epilogue
//      forms the dlogits in branch-free chunks and writes its tile buffer
//      by shared address (wgmma_gemm.cuh dlogits_epilogue), and each
//      tile's store is waited for before the next tile's writes.
// The ragged vocab tail (50320 = 393 x 128 + 16) is masked: W rows past V
// load as zero, and those columns take no part in the statistics and get
// zero dlogits, as _masked_w (:93-102) and the NEG floor do on the TPU.
#include "wgmma_gemm.cuh"

namespace {

typedef __nv_bfloat16 bf16;

// merges a row's per-tile partials in a fixed order: a warp per row
__global__ void lm_ce_merge_kernel(const float* __restrict__ part_m,
                                   const float* __restrict__ part_se,
                                   const float* __restrict__ part_ll, float* __restrict__ m,
                                   float* __restrict__ se, float* __restrict__ ll, int N,
                                   int n_vtiles) {
  const int n = blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (n >= N) return;
  const float* pm = part_m + (size_t)n * n_vtiles;
  const float* ps = part_se + (size_t)n * n_vtiles;
  const float* pl = part_ll + (size_t)n * n_vtiles;
  float mx = -INFINITY;
  for (int t = lane; t < n_vtiles; t += 32) mx = fmaxf(mx, pm[t]);
  mx = warp_max(mx);
  float s = 0.f, l = 0.f;
  for (int t = lane; t < n_vtiles; t += 32) {
    s += ps[t] * expf(pm[t] - mx);
    l += pl[t];
  }
  s = warp_sum(s);
  l = warp_sum(l);
  if (lane == 0) {
    m[n] = mx;
    se[n] = s;
    ll[n] = l;
  }
}

// K7's projection on the shared main loop (wgmma_gemm.cuh): A = h [N, D]
// K-major, B = W [V, D] K-major, the EPI_STATS epilogue, rows fastest, on
// 256-row cooperative tiles with two half buffers and four stages
using K7Layout = kmb_wg::LogitsCoop;
__global__ void __launch_bounds__(kmb_wg::THREADS, 1)
    lm_ce_logits_gemm(const __grid_constant__ CUtensorMap tma_a,
                      const __grid_constant__ CUtensorMap tma_b,
                      const __grid_constant__ CUtensorMap out_c,
                      const __grid_constant__ CUtensorMap out_d, const kmb_wg::GemmArgs p) {
  kmb_wg::gemm_tiles<kmb_wg::EPI_STATS, false, true, K7Layout>(&tma_a, &tma_b, &out_c, &out_d, p);
}

// K9: K7's projection and statistics on the same tiles with no tile
// buffers (four stages in their room): the statistics alone
using K9Layout = kmb_wg::StatsCoop;
__global__ void __launch_bounds__(kmb_wg::THREADS, 1)
    lm_ce_stats_gemm(const __grid_constant__ CUtensorMap tma_a,
                     const __grid_constant__ CUtensorMap tma_b,
                     const __grid_constant__ CUtensorMap out_c,
                     const __grid_constant__ CUtensorMap out_d, const kmb_wg::GemmArgs p) {
  kmb_wg::gemm_tiles<kmb_wg::EPI_STATS, false, true, K9Layout>(&tma_a, &tma_b, &out_c, &out_d, p);
}

// K10's first pass: K7's projection with the EPI_DLOGITS epilogue, on
// 256-row cooperative tiles
__global__ void __launch_bounds__(kmb_wg::THREADS, 1)
    lm_ce_dlogits_gemm(const __grid_constant__ CUtensorMap tma_a,
                       const __grid_constant__ CUtensorMap tma_b,
                       const __grid_constant__ CUtensorMap out_c,
                       const __grid_constant__ CUtensorMap out_d, const kmb_wg::GemmArgs p) {
  kmb_wg::gemm_tiles<kmb_wg::EPI_DLOGITS, false, true, kmb_wg::DlogitsCoop>(&tma_a, &tma_b,
                                                                             &out_c, &out_d, p);
}

}  // namespace

// K7, or K9 when logits is null. logits: bf16 [N, V] at row pitch ldl (ldl %
// 8 == 0, ldl >= V; unused for K9); parts: fp32 [3, N, ceil(V / 128)]
// scratch (max, exp-sum, label logit); m, se, ll: fp32 [N]; ctas: the
// persistent grid (ops/lm_ce.py coop_plan). h, w,
// logits 16-byte aligned; D % 8 == 0. The projection, then the merge of its
// partials.
KMB_EXPORT int kmb_lm_ce_fwd(const void* h, const void* w, const void* bias,
                             const void* labels, void* logits, void* parts, void* m, void* se,
                             void* ll, int N, int V, int D, int ldl, int ctas, void* stream) {
  const bool store = logits != nullptr;
  if (N < 1 || ctas < 1 || D % 8 || (store && (ldl < V || ldl % 8)))
    return cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  static unsigned configured[2] = {0, 0};  // a bit per device, for each kernel
  kmb_wg::GemmArgs p = {(const float*)bias, nullptr, N, V, 0, 0, 1, 0};
  p.labels = (const int*)labels;
  p.stats = (float*)parts;
  cudaError_t err =
      store ? kmb_wg::gemm_launch<K7Layout>(lm_ce_logits_gemm, configured[1], false, h, D, w,
                                            logits, nullptr, p, D, ctas, s, ldl)
            : kmb_wg::gemm_launch<K9Layout>(lm_ce_stats_gemm, configured[0], false, h, D, w,
                                            nullptr, nullptr, p, D, ctas, s);
  if (err != cudaSuccess) return err;
  const int nvt = (V + kmb_wg::BN - 1) / kmb_wg::BN;
  const float* part = (const float*)parts;
  const size_t plane = (size_t)N * nvt;
  lm_ce_merge_kernel<<<(N + 7) / 8, 256, 0, s>>>(part, part + plane, part + 2 * plane, (float*)m,
                                                  (float*)se, (float*)ll, N, nvt);
  return cudaGetLastError();
}

// K10's first pass: the dlogits from the recomputed logits into dl [N, ldo]
// (K8's padded buffer: ldo % 8 == 0, V <= ldo < V + 8; its pad columns get
// zeros), for kmb_lm_ce_dh (lm_ce_bwd.cu) after it; m, inv_se, scale fp32 [N]; ctas as
// K7's. h, w, dl 16-byte aligned; D % 8 == 0.
KMB_EXPORT int kmb_lm_ce_recompute_dlogits(const void* h, const void* w, const void* bias,
                                           const void* m, const void* inv_se,
                                           const void* scale, const void* labels, void* dl,
                                           int N, int V, int ldo, int D, int ctas,
                                           void* stream) {
  if (N < 1 || ctas < 1 || ldo < V || ldo % 8 || ldo >= V + 8 || D % 8)
    return cudaErrorInvalidValue;
  static unsigned configured = 0;  // a bit per device
  kmb_wg::GemmArgs p = {(const float*)bias, nullptr, N, V, 0, 0, 1, 0};
  p.labels = (const int*)labels;
  p.row_m = (const float*)m;
  p.row_inv_se = (const float*)inv_se;
  p.row_scale = (const float*)scale;
  return kmb_wg::gemm_launch<kmb_wg::DlogitsCoop>(lm_ce_dlogits_gemm, configured, false, h, D, w,
                                                  dl, nullptr, p, D, ctas, (cudaStream_t)stream,
                                                  ldo);
}
