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
//      768, 128 x 128 tiles) with its EPI_STATS epilogue: bias, bf16
//      rounding, a TMA store of the logits tile, and from the same rounded
//      values in registers one partial (max, exp-sum, label logit) per row
//      and 128-column tile into [3, N, ceil(V / 128)]; a second pass merges
//      a row's partials in a fixed order (as K4 does). The tiles walk rows
//      fastest: W (77 MB) is larger than the 50 MB L2, and walked columns
//      fastest each 128-row block would stream all of it from HBM (3 GB at N
//      5120), where rows fastest reads each 196 KB W slice once while h
//      (7.9 MB at N 5120) stays in L2. TMA wants 16-byte row pitches, so for
//      a vocab that is not a multiple of 8 the logits live in an [N,
//      ceil(V / 8) x 8] buffer (the wrapper returns the [:, :V] view; the
//      store's map spans the pitch, so the pad columns get bf16(0 + 0) =
//      0), and K8's first launch reads them at that pitch;
//   K9 is K7's launch with the epilogue's store turned off (store_c = 0,
//      under its own kernel name, lm_ce_stats_gemm): the same accumulators,
//      rounding, partials and merge, so its statistics equal K7's bit for
//      bit, and no [N, V] tensor reaches memory;
//   K8 is two launches. An elementwise pass reads the logits once (16-byte
//      loads where V % 8 == 0) and writes the dlogits, which the dW product
//      needs anyway: 2 x N x V x 2 bytes, 1.03 GB at N 5120 (0.31 ms at
//      3.35 TB/s). Then dh = dlogits @ W on the persistent wgmma + TMA main
//      loop of wgmma_gemm.cuh (K2b's B2 GEMM: A = dlogits K-major, B = W
//      [V, D] read MN-major, K = V, the plain bf16 epilogue). TMA wants a
//      row pitch of a multiple of 16 bytes, so the dlogits live in an [N,
//      ceil(V / 8) x 8] buffer with zero pad columns (the wrapper returns
//      the [:, :V] view); the GEMM's map of them is V
//      wide, and TMA zero-fills the ragged last K slice (50320 = 786 x 64 +
//      16) of both operands. The output is 128 x 128 tiles walked columns
//      first, so the six D tiles of a row block read each dlogits slice
//      together (from L2 for five of them). When the tiles alone leave SMs
//      idle, the plan (ops/lm_ce.py dh_plan) splits the V walk into fp32
//      partials added in split order, so the result is deterministic;
//   K10 cannot keep the TPU's [tn, D] fp32 dh accumulator on chip (768 fp32
//      columns per row tile) and recomputing a logits tile once per 128-wide
//      D tile would repeat the projection six times. So it runs in two
//      passes: K7's projection with the EPI_DLOGITS epilogue, which rounds
//      the logits as K7 does, forms the dlogits in registers with the
//      function K8's first launch uses (kmb_wg::dlogit) and stores them in
//      bf16 by TMA into K8's padded buffer (the dW product needs them
//      anyway, pallas_lm_ce.py:426-431), then K8's dh GEMM. K10's outputs
//      thus equal K8's on K7's logits bit for bit. The price against one
//      fused pass is a second read of the dlogits, N x V x 2 bytes (0.93 GB,
//      about 0.3 ms at N 9216).
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

// K8's first launch: grid (N, ceil(ldo / 2048)), a thread per 8 columns.
// dl[n, v] = bf16(scale (exp(logit - m) inv_se - [v == label])) for v < V,
// 0 on the pad columns [V, ldo). The logits rows are ldl apart (K7's padded
// pitch, or V); 16-byte loads where ldl % 8 == 0 (every row then starts
// aligned, and a pad column's value is read and dropped), else element by
// element.
__global__ void __launch_bounds__(256)
lm_ce_dlogits_kernel(const bf16* __restrict__ logits, const float* __restrict__ m,
                     const float* __restrict__ inv_se, const float* __restrict__ scale,
                     const int* __restrict__ labels, bf16* __restrict__ dl, int V, int ldl,
                     int ldo) {
  const int n = blockIdx.x;
  const int c = (blockIdx.y * blockDim.x + threadIdx.x) * 8;
  if (c >= ldo) return;
  const float rm = m[n], rinv = inv_se[n], rscale = scale[n];
  const int label = labels[n];
  const bf16* row = logits + (size_t)n * ldl;
  __align__(16) bf16 x[8];
  if ((ldl & 7) == 0 && c < ldl) {
    *reinterpret_cast<uint4*>(x) = *reinterpret_cast<const uint4*>(row + c);
  } else {
#pragma unroll
    for (int e = 0; e < 8; ++e) x[e] = c + e < V ? row[c + e] : __float2bfloat16(0.f);
  }
  __align__(16) bf16 y[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    const int v = c + e;
    y[e] = __float2bfloat16(
        v < V ? kmb_wg::dlogit(__bfloat162float(x[e]), rm, rinv, rscale, v == label) : 0.f);
  }
  *reinterpret_cast<uint4*>(dl + (size_t)n * ldo + c) = *reinterpret_cast<const uint4*>(y);
}

// K7's projection on the shared main loop (wgmma_gemm.cuh): A = h [N, D]
// K-major, B = W [V, D] K-major, the EPI_STATS epilogue, rows fastest
__global__ void __launch_bounds__(kmb_wg::THREADS, 1)
    lm_ce_logits_gemm(const __grid_constant__ CUtensorMap tma_a,
                      const __grid_constant__ CUtensorMap tma_b,
                      const __grid_constant__ CUtensorMap out_c,
                      const __grid_constant__ CUtensorMap out_d, const kmb_wg::GemmArgs p) {
  kmb_wg::gemm_tiles<kmb_wg::EPI_STATS, false, true>(&tma_a, &tma_b, &out_c, &out_d, p);
}

// K9: K7's instantiation under its own name, launched with store_c = 0
__global__ void __launch_bounds__(kmb_wg::THREADS, 1)
    lm_ce_stats_gemm(const __grid_constant__ CUtensorMap tma_a,
                     const __grid_constant__ CUtensorMap tma_b,
                     const __grid_constant__ CUtensorMap out_c,
                     const __grid_constant__ CUtensorMap out_d, const kmb_wg::GemmArgs p) {
  kmb_wg::gemm_tiles<kmb_wg::EPI_STATS, false, true>(&tma_a, &tma_b, &out_c, &out_d, p);
}

// K10's first pass: K7's projection with the EPI_DLOGITS epilogue
__global__ void __launch_bounds__(kmb_wg::THREADS, 1)
    lm_ce_dlogits_gemm(const __grid_constant__ CUtensorMap tma_a,
                       const __grid_constant__ CUtensorMap tma_b,
                       const __grid_constant__ CUtensorMap out_c,
                       const __grid_constant__ CUtensorMap out_d, const kmb_wg::GemmArgs p) {
  kmb_wg::gemm_tiles<kmb_wg::EPI_DLOGITS, false, true>(&tma_a, &tma_b, &out_c, &out_d, p);
}

// dh = dl @ W on the shared main loop (wgmma_gemm.cuh): A = dl [N, V] at row
// pitch ldl, K-major; B = W [V, D] read MN-major; K = V
__global__ void __launch_bounds__(kmb_wg::THREADS, 1)
    lm_ce_dh_gemm(const __grid_constant__ CUtensorMap tma_a,
                  const __grid_constant__ CUtensorMap tma_b,
                  const __grid_constant__ CUtensorMap out_c,
                  const __grid_constant__ CUtensorMap out_d, const kmb_wg::GemmArgs p) {
  kmb_wg::gemm_tiles<kmb_wg::EPI_OUT, true>(&tma_a, &tma_b, &out_c, &out_d, p);
}

__global__ void lm_ce_dh_finalize(const float* __restrict__ partial,
                                  const float* __restrict__ bias, bf16* __restrict__ out, int M,
                                  int Ncols, int nsplit) {
  kmb_wg::finalize_sum(partial, bias, out, M, Ncols, nsplit);
}

}  // namespace

// K7, or K9 when logits is null. logits: bf16 [N, V] at row pitch ldl (ldl %
// 8 == 0, ldl >= V; unused for K9); parts: fp32 [3, N, ceil(V / 128)]
// scratch (max, exp-sum, label logit); m, se, ll: fp32 [N]; ctas: the
// persistent grid (ops/lm_ce.py logits_plan). h, w, logits 16-byte aligned;
// D % 8 == 0. The projection, then the merge of its partials.
KMB_EXPORT int kmb_lm_ce_fwd(const void* h, const void* w, const void* bias,
                             const void* labels, void* logits, void* parts, void* m, void* se,
                             void* ll, int N, int V, int D, int ldl, int ctas, void* stream) {
  const bool store = logits != nullptr;
  if (N < 1 || ctas < 1 || D % 8 || (store && (ldl < V || ldl % 8)))
    return cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  static unsigned configured[2] = {0, 0};  // a bit per device, for each kernel
  kmb_wg::GemmArgs p = {(const float*)bias, nullptr, N, V, 0, 0, 1, 0};
  p.store_c = store;
  p.labels = (const int*)labels;
  p.stats = (float*)parts;
  cudaError_t err = kmb_wg::gemm_launch(store ? lm_ce_logits_gemm : lm_ce_stats_gemm,
                                        configured[store], false, h, D, w, logits, nullptr, p,
                                        D, ctas, s, ldl);
  if (err != cudaSuccess) return err;
  const int nvt = (V + kmb_wg::BN - 1) / kmb_wg::BN;
  const float* part = (const float*)parts;
  const size_t plane = (size_t)N * nvt;
  lm_ce_merge_kernel<<<(N + 7) / 8, 256, 0, s>>>(part, part + plane, part + 2 * plane, (float*)m,
                                                  (float*)se, (float*)ll, N, nvt);
  return cudaGetLastError();
}

// K8's first launch. logits bf16 [N, V] at row pitch ldl >= V; dl bf16 [N,
// ldo] (ldo % 8 == 0, ldo >= V); both 16-byte aligned.
KMB_EXPORT int kmb_lm_ce_dlogits(const void* logits, const void* m, const void* inv_se,
                                 const void* scale, const void* labels, void* dl, int N, int V,
                                 int ldl, int ldo, void* stream) {
  if (N < 1 || ldl < V || ldo < V || ldo % 8) return cudaErrorInvalidValue;
  lm_ce_dlogits_kernel<<<dim3(N, (ldo / 8 + 255) / 256), 256, 0, (cudaStream_t)stream>>>(
      (const bf16*)logits, (const float*)m, (const float*)inv_se, (const float*)scale,
      (const int*)labels, (bf16*)dl, V, ldl, ldo);
  return cudaGetLastError();
}

// K8's and K10's dh GEMM: dh bf16 [N, D] = dl [N, V] (row pitch ldl) @ w [V,
// D], on `ctas` persistent blocks, the V walk in nsplit parts of kper
// 64-deep slices (ops/lm_ce.py dh_plan); partial: fp32 [nsplit, N, D] scratch
// when nsplit > 1. Every pointer 16-byte aligned, ldl % 8 == 0, D % 8 == 0.
KMB_EXPORT int kmb_lm_ce_dh(const void* dl, const void* w, void* dh, void* partial, int N,
                            int V, int ldl, int D, int ctas, int nsplit, int kper,
                            void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  if (ctas < 1 || nsplit < 1 || ldl < V || ldl % 8 || D % 8) return cudaErrorInvalidValue;
  static unsigned configured = 0;  // a bit per device
  float* part = nsplit > 1 ? (float*)partial : nullptr;
  const kmb_wg::GemmArgs p = {nullptr, part, N, D, 0, kper, nsplit, 0};
  cudaError_t err =
      kmb_wg::gemm_launch(lm_ce_dh_gemm, configured, true, dl, ldl, w, dh, nullptr, p, V, ctas, s);
  if (err != cudaSuccess || nsplit == 1) return err;
  return kmb_wg::finalize_launch(lm_ce_dh_finalize, part, nullptr, (bf16*)dh, N, D, nsplit, s);
}

// K10's first pass: the dlogits from the recomputed logits into dl [N, ldo]
// (K8's padded buffer: ldo % 8 == 0, V <= ldo < V + 8; its pad columns get
// zeros), for kmb_lm_ce_dh after it; m, inv_se, scale fp32 [N]; ctas as
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
  return kmb_wg::gemm_launch(lm_ce_dlogits_gemm, configured, false, h, D, w, dl, nullptr, p, D,
                             ctas, (cudaStream_t)stream, ldo);
}
