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
//
// What bounds it on an H100: bytes. At the main path's shape (B 64, K 5,
// T 32, D 768, H 12) a step reads at most the K and V rows up to
// cache_index, 2 x 320 x 32 x 768 x 2 B = 31 MB per layer at the last step,
// and computes 63 MFLOP. Design: instead of reading the whole [K, T] cache
// tile per sample and a bf16 one-hot of K*T x K*H (the TPU's MXU-friendly
// form), each query beam reads the int32 ancestry row and gathers only its
// cache_index + 1 ancestor rows. One block per live beam, one warp per head:
// lanes own positions for the scores and split head_dim for the PV sum,
// so V rows are read coalesced.
#include "common.cuh"

namespace {

template <typename TQ, typename TC>
__global__ void beam_attention_kernel(const TQ* __restrict__ q, const TC* __restrict__ kc,
                                      const TC* __restrict__ vc,
                                      const int* __restrict__ ancestry,
                                      float* __restrict__ out, int K, int T, int D, int hd,
                                      int cache_index) {
  extern __shared__ float smem[];
  const int r = blockIdx.x;  // live beam b*K + q
  const int b = r / K;
  const int h = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  float* q_w = smem + h * (hd + T);
  float* p_w = q_w + hd;
  const int n = cache_index + 1;
  const int* anc = ancestry + (size_t)r * T;
  const size_t col = (size_t)h * hd;

  for (int d = lane; d < hd; d += 32) q_w[d] = round_bf16(to_f(q[(size_t)r * D + col + d]));
  __syncwarp();

  float m = -INFINITY;
  for (int t = lane; t < n; t += 32) {
    const TC* k_row = kc + (((size_t)b * K + anc[t]) * T + t) * D + col;
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
      const TC* v_row = vc + (((size_t)b * K + anc[t]) * T + t) * D + col;
      acc = fmaf(p_w[t], round_bf16(to_f(v_row[d])), acc);
    }
    out[(size_t)r * D + col + d] = acc;
  }
}

template <typename TQ, typename TC>
cudaError_t launch(const void* q, const void* kc, const void* vc, const int* anc,
                   float* out, int B, int K, int T, int D, int H, int cache_index,
                   cudaStream_t stream) {
  const int hd = D / H;
  const size_t smem = sizeof(float) * (size_t)H * (hd + T);
  cudaError_t err = kmb_allow_smem(beam_attention_kernel<TQ, TC>, smem);
  if (err != cudaSuccess) return err;
  beam_attention_kernel<TQ, TC><<<B * K, H * 32, smem, stream>>>(
      (const TQ*)q, (const TC*)kc, (const TC*)vc, anc, out, K, T, D, hd, cache_index);
  return cudaGetLastError();
}

}  // namespace

KMB_EXPORT int kmb_beam_attention(const void* q, int q_dtype, const void* k_cache,
                                  const void* v_cache, int cache_dtype,
                                  const void* ancestry, void* out, int B, int K, int T,
                                  int D, int H, int cache_index, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  const int* anc = (const int*)ancestry;
  float* o = (float*)out;
  if (q_dtype == KMB_BF16 && cache_dtype == KMB_BF16)
    return launch<__nv_bfloat16, __nv_bfloat16>(q, k_cache, v_cache, anc, o, B, K, T, D, H,
                                                 cache_index, s);
  if (q_dtype == KMB_F32 && cache_dtype == KMB_BF16)
    return launch<float, __nv_bfloat16>(q, k_cache, v_cache, anc, o, B, K, T, D, H,
                                        cache_index, s);
  if (q_dtype == KMB_BF16 && cache_dtype == KMB_F32)
    return launch<__nv_bfloat16, float>(q, k_cache, v_cache, anc, o, B, K, T, D, H,
                                        cache_index, s);
  if (q_dtype == KMB_F32 && cache_dtype == KMB_F32)
    return launch<float, float>(q, k_cache, v_cache, anc, o, B, K, T, D, H, cache_index, s);
  return cudaErrorInvalidValue;
}
