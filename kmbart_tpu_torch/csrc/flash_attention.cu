// K11: blockwise (flash) attention forward for sequences too long for K1.
//
// Replaces kmbart_tpu/ops/pallas_attention.py:62 flash_attention (body
// _flash_kernel :24). Per batch b, head h, query i (hd = D / H), from the flat
// [B, T, H * hd] projections:
//   qs   = float(q[b, i, h]) * scale                  fp32, scaled after the cast
//   s_j  = qs . float(k[b, j, h]) + bias[b, j]        bias 0 or -1e9 (key padding);
//                                                     s_j = -1e9 where j > i if causal
//   online over key tiles, from m = -1e9, l = 0, acc = 0:
//     m' = max(m, max_j s_j);  p_j = exp(s_j - m');  alpha = exp(m - m')
//     acc = acc * alpha + sum_j p_j float(v[b, j, h]);  l = l * alpha + sum_j p_j
//   out  = acc / max(l, 1e-30)                        fp32 output
// p stays fp32 (the TPU kernel does not round it before the PV product), so
// the products run on the CUDA cores in fp32, not on the tensor cores.
//
// What bounds it on an H100: at the long-caption pretraining shapes (B 32,
// H 12, hd 64, T 296 / 272) the work is 4 Tq Tk hd FLOP per (b, h), 8.6 GFLOP
// a call, on 2 x 30 MB of bf16 K/V: fp32 FMA throughput and shared-memory
// bandwidth, far from HBM. The TPU kernel keeps a whole head's K and V in
// VMEM; here K/V stream through shared memory in tiles of 64 keys. Design:
// one block of four warps per (query tile of 64, b * h); each warp owns 16
// query rows and keeps their running (m, l) and fp32 output rows in
// registers (lanes split head_dim). q is staged once, scaled and transposed
// ([hd][64 + 4]) so a lane reads four rows as one float4; for the scores a
// lane owns two keys of the tile (K rows padded to hd + 1: conflict-free),
// for P.V it owns head_dim columns and reads p transposed as float4. The
// block reads q, k, v straight from the flat projections by stride, so no
// split-heads copy is made. Any Tq, Tk is taken: keys past Tk get -inf (no
// weight) and rows past Tq are not written, so the ragged last tiles need no
// padding. Causal tiles above the diagonal are not skipped: a row whose
// every key is masked averages over all Tk keys, as the TPU kernel does, and
// skipping would change that.
#include "common.cuh"

namespace {

constexpr int kBQ = 64;             // query rows per block
constexpr int kBK = 64;             // keys per shared-memory tile
constexpr int kWarps = 4;
constexpr int kRows = kBQ / kWarps;  // query rows per warp
constexpr int kLdQ = kBQ + 4;       // q^T row stride: float4-aligned, fewer conflicts

size_t smem_bytes(int hd) {
  return sizeof(float) * ((size_t)hd * kLdQ + (size_t)kBK * (hd + 1) + (size_t)kBK * hd +
                          (size_t)kWarps * kBK * kRows);
}

// NPL: head_dim columns per lane (hd <= 32 * NPL)
template <typename T, int NPL>
__global__ void __launch_bounds__(kWarps * 32)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, const float* __restrict__ bias,
                       float* __restrict__ out, int Tq, int Tk, int D, int H, int hd,
                       int causal, float scale) {
  extern __shared__ __align__(16) float smem[];
  float* q_t = smem;                         // [hd][kLdQ]   q * scale, transposed
  float* k_s = q_t + (size_t)hd * kLdQ;      // [kBK][hd + 1]
  float* v_s = k_s + (size_t)kBK * (hd + 1); // [kBK][hd]
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* p_t = v_s + (size_t)kBK * hd + (size_t)warp * kBK * kRows;  // [kBK][kRows]
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int q0 = blockIdx.x * kBQ;
  const int ldk = hd + 1;
  const size_t head = (size_t)h * hd;

  for (int i = threadIdx.x; i < kBQ * hd; i += blockDim.x) {
    const int r = i / hd, d = i % hd, qi = q0 + r;
    q_t[d * kLdQ + r] = qi < Tq ? to_f(q[((size_t)b * Tq + qi) * D + head + d]) * scale : 0.f;
  }

  float m[kRows], l[kRows], acc[kRows][NPL];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    m[r] = KMB_NEG_INF;
    l[r] = 0.f;
#pragma unroll
    for (int e = 0; e < NPL; ++e) acc[r][e] = 0.f;
  }
  const float* bias_b = bias + (size_t)b * Tk;
  const int row0 = q0 + warp * kRows;  // this warp's first query row

  for (int k0 = 0; k0 < Tk; k0 += kBK) {
    __syncthreads();  // the previous tile is consumed (and q_t is written)
    for (int i = threadIdx.x; i < kBK * hd; i += blockDim.x) {
      const int j = i / hd, d = i % hd, kj = k0 + j;
      float kv = 0.f, vv = 0.f;
      if (kj < Tk) {
        const size_t g = ((size_t)b * Tk + kj) * D + head + d;
        kv = to_f(k[g]);
        vv = to_f(v[g]);
      }
      k_s[j * ldk + d] = kv;
      v_s[j * hd + d] = vv;
    }
    __syncthreads();

    // scores of the warp's 16 rows against keys lane and lane + 32
    float s[kRows][2];
#pragma unroll
    for (int r = 0; r < kRows; ++r) s[r][0] = s[r][1] = 0.f;
    const float* k0_row = k_s + lane * ldk;
    const float* k1_row = k_s + (lane + 32) * ldk;
    for (int d = 0; d < hd; ++d) {
      const float ka = k0_row[d], kb = k1_row[d];
      const float4* qd = reinterpret_cast<const float4*>(q_t + d * kLdQ + warp * kRows);
#pragma unroll
      for (int r4 = 0; r4 < kRows / 4; ++r4) {
        const float4 qv = qd[r4];
        const float qs[4] = {qv.x, qv.y, qv.z, qv.w};
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          s[r4 * 4 + t][0] = fmaf(qs[t], ka, s[r4 * 4 + t][0]);
          s[r4 * 4 + t][1] = fmaf(qs[t], kb, s[r4 * 4 + t][1]);
        }
      }
    }

    // masks, then the online softmax update of each row
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int kj = k0 + lane + 32 * c;
      const bool valid = kj < Tk;
      const float bj = valid ? bias_b[kj] : 0.f;
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        float x = s[r][c] + bj;
        if (causal && kj > row0 + r) x = KMB_NEG_INF;
        s[r][c] = valid ? x : -INFINITY;  // keys past Tk take no weight
      }
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const float m_new = fmaxf(m[r], warp_max(fmaxf(s[r][0], s[r][1])));
      const float p0 = expf(s[r][0] - m_new), p1 = expf(s[r][1] - m_new);
      const float alpha = expf(m[r] - m_new);
      l[r] = l[r] * alpha + warp_sum(p0 + p1);
      m[r] = m_new;
#pragma unroll
      for (int e = 0; e < NPL; ++e) acc[r][e] *= alpha;
      s[r][0] = p0;
      s[r][1] = p1;
    }
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      float4* pj = reinterpret_cast<float4*>(p_t + (lane + 32 * c) * kRows);
#pragma unroll
      for (int r4 = 0; r4 < kRows / 4; ++r4)
        pj[r4] = make_float4(s[r4 * 4][c], s[r4 * 4 + 1][c], s[r4 * 4 + 2][c],
                             s[r4 * 4 + 3][c]);
    }
    __syncwarp();

    // acc += P V over the tile's keys (past Tk: p = 0 and v = 0)
    const int nk = min(kBK, Tk - k0);
    for (int j = 0; j < nk; ++j) {
      float vv[NPL];
#pragma unroll
      for (int e = 0; e < NPL; ++e) {
        const int d = lane + 32 * e;
        vv[e] = d < hd ? v_s[j * hd + d] : 0.f;
      }
      const float4* pj = reinterpret_cast<const float4*>(p_t + j * kRows);
#pragma unroll
      for (int r4 = 0; r4 < kRows / 4; ++r4) {
        const float4 pv = pj[r4];
        const float ps[4] = {pv.x, pv.y, pv.z, pv.w};
#pragma unroll
        for (int t = 0; t < 4; ++t)
#pragma unroll
          for (int e = 0; e < NPL; ++e)
            acc[r4 * 4 + t][e] = fmaf(ps[t], vv[e], acc[r4 * 4 + t][e]);
      }
    }
    __syncwarp();
  }

#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int qi = row0 + r;
    if (qi >= Tq) break;
    const float inv = 1.f / fmaxf(l[r], 1e-30f);
    float* o_row = out + ((size_t)b * Tq + qi) * D + head;
#pragma unroll
    for (int e = 0; e < NPL; ++e) {
      const int d = lane + 32 * e;
      if (d < hd) o_row[d] = acc[r][e] * inv;
    }
  }
}

template <typename T, int NPL>
cudaError_t launch(const void* q, const void* k, const void* v, const float* bias, float* out,
                   int B, int Tq, int Tk, int D, int H, int causal, float scale,
                   cudaStream_t stream) {
  const int hd = D / H;
  const size_t smem = smem_bytes(hd);
  cudaError_t err = kmb_allow_smem(flash_attention_kernel<T, NPL>, smem);
  if (err != cudaSuccess) return err;
  flash_attention_kernel<T, NPL><<<dim3((Tq + kBQ - 1) / kBQ, B * H), kWarps * 32, smem,
                                   stream>>>((const T*)q, (const T*)k, (const T*)v, bias, out,
                                             Tq, Tk, D, H, hd, causal, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_hd(const void* q, const void* k, const void* v, const float* bias,
                      float* out, int B, int Tq, int Tk, int D, int H, int causal, float scale,
                      cudaStream_t s) {
  const int hd = D / H;
  if (hd <= 32) return launch<T, 1>(q, k, v, bias, out, B, Tq, Tk, D, H, causal, scale, s);
  if (hd <= 64) return launch<T, 2>(q, k, v, bias, out, B, Tq, Tk, D, H, causal, scale, s);
  if (hd <= 128) return launch<T, 4>(q, k, v, bias, out, B, Tq, Tk, D, H, causal, scale, s);
  return cudaErrorInvalidValue;
}

}  // namespace

// q [B, Tq, D], k, v [B, Tk, D] (D = H * hd, hd <= 128) of type ``dtype``;
// bias fp32 [B, Tk]; out fp32 [B, Tq, D].
KMB_EXPORT int kmb_flash_attention(const void* q, const void* k, const void* v,
                                   const void* bias, void* out, int B, int Tq, int Tk, int D,
                                   int H, int causal, float scale, int dtype, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  const float* kb = (const float*)bias;
  if (dtype == KMB_BF16)
    return launch_hd<__nv_bfloat16>(q, k, v, kb, (float*)out, B, Tq, Tk, D, H, causal, scale,
                                    s);
  if (dtype == KMB_F32)
    return launch_hd<float>(q, k, v, kb, (float*)out, B, Tq, Tk, D, H, causal, scale, s);
  return cudaErrorInvalidValue;
}
