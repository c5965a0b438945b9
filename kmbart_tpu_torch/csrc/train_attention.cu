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

// ---------------------------------------------------------------------------
// K1 backward: dq, dk, dv from the scores recomputed on chip.
//
// Replaces kmbart_tpu/ops/pallas_train_attention.py:223 _bwd_call (body
// _bwd_kernel :76). Per batch b, head h (qs = round_T(q * scale_q) as in the
// forward, g already rounded to T by the caller):
//   p_ij  = exp(s_ij - m_i) / l_i                       fp32, unrounded
//   dp_ij = g_i . v_j                                    fp32
//   r_i   = sum_j p_ij dp_ij                             (not rowsum(dO.O): O is rounded)
//   ds_ij = round_T(p_ij (dp_ij - r_i))
//   dq_i  = round_T((sum_j ds_ij k_j) * scale_dq)        scale_dq = hd**-0.5 in fp32
//   dk_j  = round_T(sum_i ds_ij qs_i)
//   dv_j  = round_T(sum_i round_T(p_ij) g_i)
//
// What bounds it on an H100: at the fine-tune shapes (B 128, T 72 or 40,
// D 768, H 12) each (b, h) does about 5 x 2*Tq*Tk*hd FLOP on 4 x T x hd
// inputs, a few MFLOP on ~40 KB: latency and shared-memory bandwidth, not
// HBM or the tensor cores. Design: one block per (head, batch) as in the
// forward; q, k, v, g of the head stay in shared memory in the input type
// (4 x 256 x 64 bf16 = 128 KB at the largest supported length). Pass 1 is a
// warp per query row: lanes own keys for s, p, dp, the row statistics
// (m, l, r) go to shared memory, and lanes then split head_dim for dq.
// Pass 2 is a warp per key row, the transposed recompute the TPU kernel
// also does (:120-148): lanes own queries and rebuild p_ij and ds_ij from
// the saved statistics with the same fmaf order as pass 1, then split
// head_dim for dk and dv. No atomics: every output row has one owner.
constexpr int kBwdWarps = 8;

template <typename T>
__host__ __device__ constexpr int bwd_ld(int hd) { return hd + (sizeof(T) == 2 ? 2 : 1); }

template <typename T>
size_t bwd_smem_bytes(int Tq, int Tk, int hd) {
  const int ld = bwd_ld<T>(hd);
  const size_t tiles = sizeof(T) * (size_t)ld * (2 * (size_t)Tq + 2 * (size_t)Tk);
  const size_t stats = sizeof(float) * 3 * (size_t)Tq;
  const int row = Tq > Tk ? Tq : Tk;
  const size_t scratch = sizeof(float) * kBwdWarps * 2 * (size_t)row;
  return tiles + stats + scratch;
}

template <typename T>
__global__ void __launch_bounds__(kBwdWarps * 32)
train_attention_bwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v, const float* __restrict__ bias,
                           const T* __restrict__ g, T* __restrict__ dq,
                           T* __restrict__ dk, T* __restrict__ dv, int Tq, int Tk,
                           int D, int hd, int causal, float scale_q, float scale_dq) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int ld = bwd_ld<T>(hd);
  T* q_s = reinterpret_cast<T*>(smem_raw);   // [Tq][ld], q * scale_q rounded
  T* g_s = q_s + (size_t)Tq * ld;            // [Tq][ld]
  T* k_s = g_s + (size_t)Tq * ld;            // [Tk][ld]
  T* v_s = k_s + (size_t)Tk * ld;            // [Tk][ld]
  float* m_s = reinterpret_cast<float*>(v_s + (size_t)Tk * ld);  // [Tq]
  float* l_s = m_s + Tq;
  float* r_s = l_s + Tq;
  const int row = Tq > Tk ? Tq : Tk;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  float* a_w = r_s + Tq + (size_t)warp * 2 * row;  // this warp's two scratch rows
  float* b_w = a_w + row;

  for (int i = threadIdx.x; i < Tq * hd; i += blockDim.x) {
    const int t = i / hd, d = i % hd;
    const size_t gi = ((size_t)b * Tq + t) * D + (size_t)h * hd + d;
    q_s[t * ld + d] = from_f<T>(to_f(q[gi]) * scale_q);
    g_s[t * ld + d] = g[gi];
  }
  for (int i = threadIdx.x; i < Tk * hd; i += blockDim.x) {
    const int t = i / hd, d = i % hd;
    const size_t gi = ((size_t)b * Tk + t) * D + (size_t)h * hd + d;
    k_s[t * ld + d] = k[gi];
    v_s[t * ld + d] = v[gi];
  }
  __syncthreads();
  const float* bias_b = bias + (size_t)b * Tk;

  // pass 1: a warp per query row i -> m, l, r and dq_i
  for (int i = warp; i < Tq; i += kBwdWarps) {
    const T* qi = q_s + i * ld;
    const T* gi = g_s + i * ld;
    float m = -INFINITY;
    for (int j = lane; j < Tk; j += 32) {
      const T* kj = k_s + j * ld;
      float s = 0.f;
      for (int d = 0; d < hd; ++d) s = fmaf(to_f(qi[d]), to_f(kj[d]), s);
      s += bias_b[j];
      if (causal && j > i) s = KMB_NEG_INF;
      a_w[j] = s;
      m = fmaxf(m, s);
    }
    m = warp_max(m);
    float l = 0.f;
    for (int j = lane; j < Tk; j += 32) l += expf(a_w[j] - m);
    l = warp_sum(l);
    float r = 0.f;
    for (int j = lane; j < Tk; j += 32) {
      const float p = expf(a_w[j] - m) / l;
      const T* vj = v_s + j * ld;
      float dp = 0.f;
      for (int d = 0; d < hd; ++d) dp = fmaf(to_f(gi[d]), to_f(vj[d]), dp);
      a_w[j] = p;
      b_w[j] = dp;
      r += p * dp;
    }
    r = warp_sum(r);
    for (int j = lane; j < Tk; j += 32) a_w[j] = round_to<T>(a_w[j] * (b_w[j] - r));
    if (lane == 0) {
      m_s[i] = m;
      l_s[i] = l;
      r_s[i] = r;
    }
    __syncwarp();
    T* dq_row = dq + ((size_t)b * Tq + i) * D + (size_t)h * hd;
    for (int d = lane; d < hd; d += 32) {
      float acc = 0.f;
      for (int j = 0; j < Tk; ++j) acc = fmaf(a_w[j], to_f(k_s[j * ld + d]), acc);
      dq_row[d] = from_f<T>(acc * scale_dq);
    }
    __syncwarp();
  }
  __syncthreads();

  // pass 2: a warp per key row j -> dk_j, dv_j
  for (int j = warp; j < Tk; j += kBwdWarps) {
    const T* kj = k_s + j * ld;
    const T* vj = v_s + j * ld;
    for (int i = lane; i < Tq; i += 32) {
      const T* qi = q_s + i * ld;
      const T* gi = g_s + i * ld;
      float s = 0.f;
      for (int d = 0; d < hd; ++d) s = fmaf(to_f(qi[d]), to_f(kj[d]), s);
      s += bias_b[j];
      if (causal && j > i) s = KMB_NEG_INF;
      const float p = expf(s - m_s[i]) / l_s[i];
      float dp = 0.f;
      for (int d = 0; d < hd; ++d) dp = fmaf(to_f(gi[d]), to_f(vj[d]), dp);
      a_w[i] = round_to<T>(p * (dp - r_s[i]));
      b_w[i] = round_to<T>(p);
    }
    __syncwarp();
    T* dk_row = dk + ((size_t)b * Tk + j) * D + (size_t)h * hd;
    T* dv_row = dv + ((size_t)b * Tk + j) * D + (size_t)h * hd;
    for (int d = lane; d < hd; d += 32) {
      float ak = 0.f, av = 0.f;
      for (int i = 0; i < Tq; ++i) {
        ak = fmaf(a_w[i], to_f(q_s[i * ld + d]), ak);
        av = fmaf(b_w[i], to_f(g_s[i * ld + d]), av);
      }
      dk_row[d] = from_f<T>(ak);
      dv_row[d] = from_f<T>(av);
    }
    __syncwarp();
  }
}

template <typename T>
cudaError_t launch_bwd(const void* q, const void* k, const void* v, const float* bias,
                       const void* g, void* dq, void* dk, void* dv, int B, int Tq, int Tk,
                       int D, int H, int causal, float scale_q, float scale_dq,
                       cudaStream_t stream) {
  const int hd = D / H;
  const size_t smem = bwd_smem_bytes<T>(Tq, Tk, hd);
  cudaError_t err = kmb_allow_smem(train_attention_bwd_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  train_attention_bwd_kernel<T><<<dim3(H, B), kBwdWarps * 32, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, bias, (const T*)g, (T*)dq, (T*)dk, (T*)dv,
      Tq, Tk, D, hd, causal, scale_q, scale_dq);
  return cudaGetLastError();
}

}  // namespace

KMB_EXPORT size_t kmb_train_attention_bwd_smem_bytes(int Tq, int Tk, int hd, int dtype) {
  return dtype == KMB_BF16 ? bwd_smem_bytes<__nv_bfloat16>(Tq, Tk, hd)
                           : bwd_smem_bytes<float>(Tq, Tk, hd);
}

KMB_EXPORT int kmb_train_attention_bwd(const void* q, const void* k, const void* v,
                                       const void* bias, const void* g, void* dq, void* dk,
                                       void* dv, int B, int Tq, int Tk, int D, int H,
                                       int causal, float scale_q, float scale_dq, int dtype,
                                       void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  const float* kb = (const float*)bias;
  if (dtype == KMB_BF16)
    return launch_bwd<__nv_bfloat16>(q, k, v, kb, g, dq, dk, dv, B, Tq, Tk, D, H, causal,
                                      scale_q, scale_dq, s);
  if (dtype == KMB_F32)
    return launch_bwd<float>(q, k, v, kb, g, dq, dk, dv, B, Tq, Tk, D, H, causal, scale_q,
                             scale_dq, s);
  return cudaErrorInvalidValue;
}

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
