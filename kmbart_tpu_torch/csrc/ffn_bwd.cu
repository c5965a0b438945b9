// K2b: the fused FFN's backward for the input, replacing
// kmbart_tpu/ops/pallas_ffn.py:190 _bwd_call. Two GEMMs on K2's main loop,
// g @ W2 with the gelu' epilogue and da @ W1 (B MN-major: the weights as
// PyTorch stores them, through wgmma's transpose); ffn.cu's source note
// says what they compute, what bounds them and which layouts they take. A
// file of its own so that it compiles beside ffn.cu.
#include "wgmma_gemm.cuh"

namespace {

using namespace kmb_wg;

template <int EPI, class L = Legacy>
__global__ void __launch_bounds__(THREADS, 1)
    ffn_bwd_gemm(const __grid_constant__ CUtensorMap tma_a,
                 const __grid_constant__ CUtensorMap tma_b,
                 const __grid_constant__ CUtensorMap out_c,
                 const __grid_constant__ CUtensorMap out_d, const GemmArgs p) {
  gemm_tiles<EPI, true, false, L>(&tma_a, &tma_b, &out_c, &out_d, p);
}

__global__ void ffn_finalize(const float* __restrict__ partial, const float* __restrict__ bias,
                             bf16* __restrict__ out, int M, int Ncols, int nsplit) {
  finalize_sum(partial, bias, out, M, Ncols, nsplit);
}

// C = A @ W (A [M, K] K-major; W [K, Ncols]); C and D bf16 [M, Ncols] (D:
// B1's a in, or null)
template <int EPI, class L = Legacy>
cudaError_t gemm(const void* A, const void* W, void* C, const void* D, GemmArgs p, int K,
                 int ctas, cudaStream_t s) {
  static unsigned configured = 0;  // a bit per device
  return gemm_launch<L>(ffn_bwd_gemm<EPI, L>, configured, true, A, K, W, C, D, p, K, ctas, s);
}

// the same on B1's training layout (TRAIN_LEGACY or TRAIN_FAST)
cudaError_t gemm_first(int layout, const void* A, const void* W, void* C, const void* D,
                       GemmArgs p, int K, int ctas, cudaStream_t s) {
  if (layout == TRAIN_LEGACY) return gemm<EPI_DGELU>(A, W, C, D, p, K, ctas, s);
  if (layout == TRAIN_FAST) return gemm<EPI_DGELU, Fast>(A, W, C, D, p, K, ctas, s);
  return cudaErrorInvalidValue;
}

}  // namespace

// As kmb_ffn_fwd: the second GEMM (da @ W1, K = F) splits by the same
// plan, lay1 B1's layout (ops/ffn.py train_plan).
KMB_EXPORT int kmb_ffn_bwd(const void* g, const void* a, const void* w1, const void* w2, void* da,
                           void* dx, void* partial, int N, int D, int F, int ctas1, int ctas2,
                           int nsplit, int kper, int lay1, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  if (ctas1 < 1 || ctas2 < 1 || nsplit < 1) return cudaErrorInvalidValue;
  GemmArgs p1 = {nullptr, nullptr, N, F, 0, 0, 1, 0};
  cudaError_t err = gemm_first(lay1, g, w2, da, a, p1, D, ctas1, s);
  if (err != cudaSuccess) return err;
  float* part = nsplit > 1 ? (float*)partial : nullptr;
  GemmArgs p2 = {nullptr, part, N, D, 0, kper, nsplit, 0};
  err = gemm<EPI_OUT>(da, w1, dx, nullptr, p2, F, ctas2, s);
  if (err != cudaSuccess || nsplit == 1) return err;
  return finalize_launch(ffn_finalize, part, nullptr, (bf16*)dx, N, D, nsplit, s);
}
