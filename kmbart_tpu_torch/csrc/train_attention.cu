// K1: multi-head attention forward on the flat QKV projections.
//
// Replaces kmbart_tpu/ops/pallas_train_attention.py:194 _fwd_call (body
// _fwd_kernel :52), the encoder self-attention of the generation path.
//
// What it computes, per batch b, head h, query i (hd = D / H):
//   qs   = round_T(q[b, i, h] * scale)           scale rounded to T by the caller
//   s_j  = sum_d qs[d] * k[b, j, h, d] + bias[b, j]   (fp32; -1e9 where j > i if causal)
//   p_j  = round_T(exp(s_j - max) / sum)          fp32 softmax, P rounded to T
//   out  = round_T(sum_j p_j * v[b, j, h])        fp32 accumulation
// with T the input type (bf16 on the main path, float also accepted).
//
// What bounds it on an H100: at the main path's shape (B 64, T 72, D 768,
// H 12) the work is 1.3 MFLOP per (b, h) and the bytes are q, k, v and out,
// 28 MB in bf16; both are tiny, so launch and latency dominate. Design: one
// block per (head, batch) keeps that head's whole K and V slices in shared
// memory (Tk <= 256, so no online softmax is needed, as on the TPU); each
// warp owns query rows, each lane owns keys for the score row, and the
// lanes then split head_dim for the PV product. Row stride hd + 1 keeps the
// lane-per-key reads free of bank conflicts.
#include "common.cuh"

namespace {

constexpr int kWarps = 4;

template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
train_attention_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v, const float* __restrict__ bias,
                           T* __restrict__ out, int Tq, int Tk, int D, int hd,
                           int causal, float scale) {
  extern __shared__ float smem[];
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int ld = hd + 1;
  float* k_s = smem;                       // [Tk][hd + 1]
  float* v_s = k_s + Tk * ld;              // [Tk][hd + 1]
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  float* q_w = v_s + Tk * ld + warp * (hd + Tk);  // this warp's query row
  float* p_w = q_w + hd;                          // this warp's score row

  for (int i = threadIdx.x; i < Tk * hd; i += blockDim.x) {
    const int j = i / hd, d = i % hd;
    const size_t g = ((size_t)b * Tk + j) * D + (size_t)h * hd + d;
    k_s[j * ld + d] = to_f(k[g]);
    v_s[j * ld + d] = to_f(v[g]);
  }
  __syncthreads();

  const float* bias_b = bias + (size_t)b * Tk;
  for (int i = warp; i < Tq; i += kWarps) {
    const T* q_row = q + ((size_t)b * Tq + i) * D + (size_t)h * hd;
    for (int d = lane; d < hd; d += 32) q_w[d] = round_to<T>(to_f(q_row[d]) * scale);
    __syncwarp();

    float m = -INFINITY;
    for (int j = lane; j < Tk; j += 32) {
      float s = 0.f;
      const float* k_row = k_s + j * ld;
      for (int d = 0; d < hd; ++d) s = fmaf(q_w[d], k_row[d], s);
      s += bias_b[j];
      if (causal && j > i) s = KMB_NEG_INF;
      p_w[j] = s;
      m = fmaxf(m, s);
    }
    m = warp_max(m);
    float l = 0.f;
    for (int j = lane; j < Tk; j += 32) {
      const float e = expf(p_w[j] - m);
      p_w[j] = e;
      l += e;
    }
    l = warp_sum(l);
    for (int j = lane; j < Tk; j += 32) p_w[j] = round_to<T>(p_w[j] / l);
    __syncwarp();

    T* o_row = out + ((size_t)b * Tq + i) * D + (size_t)h * hd;
    for (int d = lane; d < hd; d += 32) {
      float acc = 0.f;
      for (int j = 0; j < Tk; ++j) acc = fmaf(p_w[j], v_s[j * ld + d], acc);
      o_row[d] = from_f<T>(acc);
    }
    __syncwarp();
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, const float* bias,
                   void* out, int B, int Tq, int Tk, int D, int H, int causal,
                   float scale, cudaStream_t stream) {
  const int hd = D / H;
  const size_t smem = sizeof(float) * (2 * (size_t)Tk * (hd + 1) + kWarps * (size_t)(hd + Tk));
  cudaError_t err = kmb_allow_smem(train_attention_fwd_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  train_attention_fwd_kernel<T><<<dim3(H, B), kWarps * 32, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, bias, (T*)out, Tq, Tk, D, hd, causal, scale);
  return cudaGetLastError();
}

}  // namespace

KMB_EXPORT size_t kmb_train_attention_smem_bytes(int Tk, int hd) {
  return sizeof(float) * (2 * (size_t)Tk * (hd + 1) + kWarps * (size_t)(hd + Tk));
}

KMB_EXPORT int kmb_train_attention_fwd(const void* q, const void* k, const void* v,
                                       const void* bias, void* out, int B, int Tq,
                                       int Tk, int D, int H, int causal, float scale,
                                       int dtype, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  const float* kb = (const float*)bias;
  if (dtype == KMB_BF16)
    return launch<__nv_bfloat16>(q, k, v, kb, out, B, Tq, Tk, D, H, causal, scale, s);
  if (dtype == KMB_F32)
    return launch<float>(q, k, v, kb, out, B, Tq, Tk, D, H, causal, scale, s);
  return cudaErrorInvalidValue;
}
