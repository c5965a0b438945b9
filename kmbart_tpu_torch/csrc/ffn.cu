// K2 and K2b: the fused FFN, forward and backward, on Hopper's wgmma and TMA.
//
// Replaces kmbart_tpu/ops/pallas_ffn.py:160 _fwd_call (body _fwd_kernel :95)
// and :190 _bwd_call (body _bwd_kernel :123): the FFN of every encoder layer,
// every decoder layer in training and every decoder step in generation.
//
// What it computes (bf16 operands, fp32 accumulation; W1 = fc1.weight [F, D],
// W2 = fc2.weight [D, F], as PyTorch stores them; b1, b2 fp32):
//   forward   a  = bf16(x @ W1^T + b1)            (written when with_a)
//             h  = bf16(gelu(a))                   exact erf in fp32
//             y  = bf16(h @ W2^T + b2)
//   backward  da = bf16((g @ W2) * gelu'(a))       dh never leaves registers
//             dx = bf16(da @ W1)
// (The TPU kernels used the Abramowitz-Stegun polynomial for erf: Mosaic has
// none.) The weight and bias gradients are library products and reductions
// outside the kernel, as pallas_ffn.py:292-303 leaves them to XLA.
//
// What bounds it on an H100: tensor-core FLOPs. A training call at N 9216
// rows does 2 x 2 x N x D x F = 87 GFLOP (0.088 ms at 989 TFLOP/s) against
// 0.03-0.06 ms of bytes; a decode step (N 320) is bound by its 9.4 MB of
// weights (2.8 us at 3.35 TB/s). The TPU kernels kept h in VMEM and walked F
// with a [tn, D] fp32 accumulator. Here such an accumulator ([64, 768] fp32
// for one wgmma row tile) takes 196 KB of the SM's 256 KB register file,
// leaving no room for a copy pipeline, and every 64 rows would re-stream the
// weights. So each direction is two GEMMs on one main loop, with the
// nonlinearity in the first GEMM's epilogue:
//   F1  x @ W1^T    epilogue a = bf16(acc + b1), h = bf16(gelu(a)) -> h scratch
//   F2  h @ W2^T    epilogue y = bf16(acc + b2)
//   B1  g @ W2      epilogue da = bf16(acc * gelu'(a)), a read in the epilogue
//   B2  da @ W1     epilogue dx = bf16(acc)
// h makes one round trip through device memory (56.6 MB at N 9216, about
// 34 us at 3.35 TB/s); the backward already wrote da.
//
// The kernel is persistent and warp-specialised, one block an SM, 384
// threads. Warpgroup 2 is the producer: one thread issues the TMA copies
// (cp.async.bulk.tensor, 128-byte swizzle) into a ring of STAGES 64-deep K
// slices of A and B in shared memory, each stage with a full and an empty
// mbarrier. Warpgroups 0 and 1 are consumers that take turns ("ping-pong"):
// each owns every other 128 x 128 output tile of the block and computes it
// with wgmma.mma_async m64n128k16 (bf16 -> fp32, two 64-row halves, 128
// accumulator registers a thread), so one warpgroup's epilogue overlaps the
// other's main loop. setmaxnreg moves registers from the producer to the
// consumers. A is read K-major. B is read K-major for W1 in F1 and W2 in F2
// (a weight row is a K row there), and MN-major, through wgmma's transpose
// of 16-bit operands, for W2 in B1 and W1 in B2: no weight is transposed or
// copied.
//
// The epilogues, not the main loop, set the pace of F1 and B1: an erf for
// every element, with one warp a scheduler and most registers holding the
// accumulator. So each consumer has a 32 KB tile buffer in shared memory,
// laid out as TMA's 128-byte swizzle: F1 rounds a into it, then reruns the
// buffer in 16-byte chunks with the accumulator's registers free for eight
// independent erfs at a time; B1's a tile arrives there by TMA (loaded by
// the producer behind the tile's K slices) and da overwrites it in place;
// every bf16 result leaves by a TMA store. TMA zero-fills rows and columns
// past the edges and its stores clip them, so any N, any D % 16 and any
// F % 64 run here.
//
// When the output tiles alone leave SMs idle (F2 and B2 at a decode step's
// N 320 make 3 x 6 tiles), the host's plan (ops/ffn.py plan) splits the K
// walk into fp32 partials that ffn_finalize adds in split order; no atomics,
// so the result is deterministic.
//
// The inference forward (kmb_ffn_infer, no a) runs at every row count the
// callers give it, from a decode step's N 320 to an encoder's 4608, and
// walks F2's depth in the same 512-deep parts at every N, so a row's bits
// never depend on the batch it shares. On the partials route that cost a
// [6, N, D] fp32 round trip through device memory (85 MB at N 4608) and a
// third launch, and at a decode step its 128-row tiles left most SMs idle
// (F1 72 tiles, F2 108 on 132 SMs, three launches for 2.8 us of weight
// bytes). Here the parts never leave the SM (ops/ffn.py infer_plan picks
// the tiling from N; wgmma_gemm.cuh's note says how each keeps the
// partials route's bits):
//   F1  64-row tiles when they all fit in one wave (120 CTAs at N 320),
//       else the 128-row ping-pong tiles of training
//   F2  MODE_CLUSTER, when one wave of clusters holds every tile: a tile's
//       six parts on a cluster's CTAs, one or two a CTA, summed from
//       distributed shared memory (at N 320: 15 tiles of 64 x 256 on
//       clusters of six, 90 CTAs); else MODE_SUM: a 128 x 128 tile walks all
//       six with a running fp32 sum, both consumers on its two 64-row halves
// Two launches a call; the tensor maps come from a per-thread cache
// (wgmma_gemm.cuh cached_map), so a call with the same weights encodes none
// of theirs again.
//
// The training forward (kmb_ffn_fwd with a) and the backward (ffn_bwd.cu)
// run at 5120-12288 rows, where every GEMM is a few waves of 128 x 128
// tiles. There the first GEMM's epilogue, not the L2 or the last wave,
// sets the pace: F1 and B1 take longer than F2 and B2 for the same work
// (chip_smoke.py's gemm_split_ms; PERF.md). train_plan gives B1 Fast (the
// formula, over a tile buffer read by address in batches) at every row
// count and F1 Table (h from a table of the bf16 a) where D is deep enough
// for consumer 0's first main loop to hide the table's build (D >= 768;
// Legacy below), both bit for bit Legacy's; F2 and B2 keep Legacy and
// plan's split. Pairs of CTAs sharing each weight slice by multicast, and
// 128 x 256 tiles, measured no faster than Legacy there (PERF.md) and are
// not built.
#include "wgmma_gemm.cuh"

namespace {

using namespace kmb_wg;

// K2's two GEMMs (B K-major), under their own name so a profile tells the
// directions apart (K2b's are ffn_bwd.cu's ffn_bwd_gemm)
template <int EPI, class L = Legacy>
__global__ void __launch_bounds__(THREADS, 1)
    ffn_fwd_gemm(const __grid_constant__ CUtensorMap tma_a,
                 const __grid_constant__ CUtensorMap tma_b,
                 const __grid_constant__ CUtensorMap out_c,
                 const __grid_constant__ CUtensorMap out_d, const GemmArgs p) {
  gemm_tiles<EPI, false, false, L>(&tma_a, &tma_b, &out_c, &out_d, p);
}

__global__ void ffn_finalize(const float* __restrict__ partial, const float* __restrict__ bias,
                             bf16* __restrict__ out, int M, int Ncols, int nsplit) {
  finalize_sum(partial, bias, out, M, Ncols, nsplit);
}

// C = A @ W^T (A [M, K] K-major; W [Ncols, K]); C and D bf16 [M, Ncols]
// (D: F1's a out, or null)
template <int EPI, class L = Legacy>
cudaError_t gemm(const void* A, const void* W, void* C, const void* D, GemmArgs p, int K,
                 int ctas, cudaStream_t s) {
  static unsigned configured = 0;  // a bit per device
  return gemm_launch<L>(ffn_fwd_gemm<EPI, L>, configured, false, A, K, W, C, D, p, K, ctas, s);
}

// the same on F1's training layout (TRAIN_LEGACY or TRAIN_TABLE)
cudaError_t gemm_first(int layout, const void* A, const void* W, void* C, const void* D,
                       GemmArgs p, int K, int ctas, cudaStream_t s) {
  if (layout == TRAIN_LEGACY) return gemm<EPI_GELU>(A, W, C, D, p, K, ctas, s);
  if (layout == TRAIN_TABLE) return gemm<EPI_GELU, Table>(A, W, C, D, p, K, ctas, s);
  return cudaErrorInvalidValue;
}

}  // namespace

// Every pointer 16-byte aligned (the wrapper checks). h: bf16 [N, F] scratch.
// a_out: bf16 [N, F] pre-activations, or null to skip writing them (the
// partials route, which keeps Legacy: lay1 = 0). ctas1, ctas2, lay1: the
// two GEMMs' grids and F1's layout (TRAIN_*; ops/ffn.py train_plan, or
// plan for the partials route). The second GEMM (K = F) walks K in nsplit
// parts of kper 64-deep slices; partial: fp32 [nsplit, N, D] scratch when
// nsplit > 1.
KMB_EXPORT int kmb_ffn_fwd(const void* x, const void* w1, const void* b1, const void* w2,
                           const void* b2, void* y, void* h, void* partial, void* a_out, int N,
                           int D, int F, int ctas1, int ctas2, int nsplit, int kper, int lay1,
                           void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  if (ctas1 < 1 || ctas2 < 1 || nsplit < 1 || (a_out == nullptr && lay1))
    return cudaErrorInvalidValue;
  GemmArgs p1 = {(const float*)b1, nullptr, N, F, 0, 0, 1, a_out != nullptr};
  cudaError_t err = gemm_first(lay1, x, w1, h, a_out, p1, D, ctas1, s);
  if (err != cudaSuccess) return err;
  float* part = nsplit > 1 ? (float*)partial : nullptr;
  GemmArgs p2 = {(const float*)b2, part, N, D, 0, kper, nsplit, 0};
  err = gemm<EPI_OUT>(h, w2, y, nullptr, p2, F, ctas2, s);
  if (err != cudaSuccess || nsplit == 1) return err;
  return finalize_launch(ffn_finalize, part, (const float*)b2, (bf16*)y, N, D, nsplit, s);
}

// The inference forward (no a): y = bf16(gelu(x @ W1^T + b1) @ W2^T + b2)
// through the h scratch, bit for bit kmb_ffn_fwd's at the same kper
// (ops/ffn.py infer_plan gives the plan). rows1: F1's tile rows, 64 or 128
// (128 columns); ctas1 its grid. rows2 x cols2: F2's tiles, 128 x 128 with
// MODE_SUM (ctas2 persistent blocks), 64 x 128 or 64 x 256 with
// MODE_CLUSTER (clusters of cluster2 CTAs, ctas2 = F2's tiles times
// cluster2, at most MAX_CLUSTER parts); F2 walks its depth F in parts of
// kper 64-deep slices.
// device: the tensors' card (set here when the runtime's current device is
// another).
KMB_EXPORT int kmb_ffn_infer(const void* x, const void* w1, const void* b1, const void* w2,
                             const void* b2, void* y, void* h, int N, int D, int F, int rows1,
                             int ctas1, int mode2, int rows2, int cols2, int ctas2, int kper,
                             int cluster2, int device, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  const int tile2 = rows2 * 1000 + cols2;
  const bool tiles_ok = (rows1 == 64 || rows1 == 128) &&
                        ((mode2 == MODE_CLUSTER && (tile2 == 64128 || tile2 == 64256)) ||
                         (mode2 == MODE_SUM && tile2 == 128128));
  if (ctas1 < 1 || ctas2 < 1 || kper < 1 || cluster2 < 1 || !tiles_ok) return cudaErrorInvalidValue;
  int current = -1;
  cudaError_t err = cudaGetDevice(&current);
  if (err == cudaSuccess && current != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const GemmArgs p1 = {(const float*)b1, nullptr, N, F, 0, 0, 1, 0};
  err = rows1 == 64 ? gemm<EPI_GELU, Rows64>(x, w1, h, nullptr, p1, D, ctas1, s)
                    : gemm<EPI_GELU>(x, w1, h, nullptr, p1, D, ctas1, s);
  if (err != cudaSuccess) return err;
  const int ksteps = (F + BK - 1) / BK;
  const int splits = (ksteps + kper - 1) / kper;
  GemmArgs p2 = {(const float*)b2, nullptr, N, D, 0, kper, splits, 0};
  p2.out = (bf16*)y;
  p2.ppc = splits / cluster2;
  if (mode2 == MODE_SUM) return gemm<EPI_OUT, CoopSum>(h, w2, y, nullptr, p2, F, ctas2, s);
  if (p2.ppc * cluster2 != splits) return cudaErrorInvalidValue;
  return tile2 == 64128
             ? gemm<EPI_OUT, Rows64Cluster>(h, w2, nullptr, nullptr, p2, F, ctas2, s)
             : gemm<EPI_OUT, WideCluster>(h, w2, nullptr, nullptr, p2, F, ctas2, s);
}

// How many clusters of `size` CTAs of MODE_CLUSTER's F2 kernel the card
// holds at once (cudaOccupancyMaxActiveClusters; 0: none of that size fits),
// or a negative CUDA error:
// the plan's wave count (ops/ffn.py cluster_slots). One block an SM (the
// 64 x 128 cluster kernel's shared memory and registers hold it to one too),
// so a cluster needs `size` free SMs of one GPC.
KMB_EXPORT int kmb_ffn_cluster_slots(int size, int device) {
  int current = -1;
  cudaError_t err = cudaGetDevice(&current);
  if (err == cudaSuccess && current != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return -(int)err;
  GemmKernel kernel = ffn_fwd_gemm<EPI_OUT, WideCluster>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             WideCluster::SMEM_BYTES);
  if (err != cudaSuccess) return -(int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(size * 64);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = WideCluster::SMEM_BYTES;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = size;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int clusters = 0;
  err = cudaOccupancyMaxActiveClusters(&clusters, (void*)kernel, &cfg);
  return err == cudaSuccess ? clusters : -(int)err;
}
