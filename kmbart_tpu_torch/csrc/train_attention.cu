// K1: multi-head attention on the flat QKV projections, forward and backward.
//
// Forward replaces kmbart_tpu/ops/pallas_train_attention.py:194 _fwd_call
// (body _fwd_kernel :52). Per batch b, head h, query i (hd = D / H):
//   qs   = round_T(q[b, i, h] * scale)           scale rounded to T by the caller
//   s_j  = sum_d qs[d] * k[b, j, h, d] + bias[b, j]   (fp32; -1e9 where j > i if causal)
//   p_j  = round_T(exp(s_j - max) / sum)          fp32 softmax, P rounded to T
//   out  = round_T(sum_j p_j * v[b, j, h])        fp32 accumulation
// with T the input type (bf16 on the main path, float also accepted).
//
// Backward replaces kmbart_tpu/ops/pallas_train_attention.py:223 _bwd_call
// (body _bwd_kernel :76). With g already rounded to T by the caller:
//   p_ij  = exp(s_ij - m_i) / l_i                       fp32, unrounded
//   dp_ij = g_i . v_j                                    fp32
//   r_i   = sum_j p_ij dp_ij                             (not rowsum(dO.O): O is rounded)
//   ds_ij = round_T(p_ij (dp_ij - r_i))
//   dq_i  = round_T((sum_j ds_ij k_j) * scale_dq)        scale_dq = hd**-0.5 in fp32
//   dk_j  = round_T(sum_i ds_ij qs_i)
//   dv_j  = round_T(sum_i round_T(p_ij) g_i)
//
// q, k and v are read by row stride (ldq, ldk, ldv elements between rows),
// so the three chunks of self-attention's fused QKV projection ([B, T, 3D],
// stride 3D) need no copy; g and every output are [B, T, D].
//
// What bounds them on an H100 (NVIDIA H100 80GB HBM3, 3.35 TB/s, 989
// TFLOP/s bf16): the bytes. Each input read once and each output written
// once, the generation encoder (B 64, 72 x 72, D 768, H 12) moves 28.3 MB
// of q, k, v and out for 1.0 GFLOP: 8.5 us at the memory rate against 1.0
// us at the bf16 rate. The fine-tune backward (B 128, 72 x 72) moves 99.1
// MB of q, k, v, g, dq, dk, dv for 5.1 GFLOP: 29.6 us against 5.2 us. The
// other main-path shapes (causal 40 x 40, cross 40 x 72, pretraining's 96
// and 72 tokens) are memory-bound by the same margin.
//
// The main path (bf16, head_dim 64, lengths up to 128) runs the persistent
// TMA + wgmma kernels of train_attention_wg.cu instead (ops/train_attention.py
// plan); the kernels below serve the other shapes: head_dim other than 64,
// lengths past 128, float.
//
// bf16 design (mma.sync). Every product above is a bf16 x bf16 sum in
// fp32, which is what mma.sync.m16n8k16 (bf16 in, fp32 accumulate)
// computes, so the tensor cores change only the order of the fp32 sums.
// One block owns one (head, batch) pair and stages that head's rows of q,
// k, v (and g) into shared memory once, with 16-byte cp.async loads of the
// 128-byte row segments; rows padded to a multiple of 16 and head_dim
// padded to 16 are zero-filled, and a row pitch of head_dim + 8 elements (an
// odd number of 16-byte units) keeps ldmatrix free of bank conflicts.
// - Forward: a warp owns 16 query rows. Tk <= 256, so the whole score row
//   stays in registers (Tk/2 fp32 a lane, a template bound KC on the 16-key
//   chunks, no online softmax); row max and sum take two quad shuffles; P is
//   rounded to bf16 in registers, where the score tile's accumulator layout
//   is already the A operand of the PV product. The ragged key tile (72 ->
//   80) is masked with -inf (no such key), the ragged query tile is not
//   stored. Output tiles go out through shared memory as 16-byte stores.
//   P = e / l comes from Markstein's correction of e times a correctly
//   rounded 1/l (div_by_sum): the division's bits without its range check,
//   which sent every masked key (e = 0) down the slow path; the causal
//   kernels spent most of their extra time there.
// - Backward, two passes, no atomics (every output row has one owner):
//   pass 1, a warp per 16 query rows, holds P for the full row, sweeps the
//   keys once for r = sum P dP and once more (recomputing dP = G V^T, which
//   costs flops, not bytes) for dS and dq = dS K; it keeps (m, l, 1/l, r) in
//   shared memory. Pass 2, a warp per 16 key rows, walks the query chunks
//   once: S^T and P^T from (m, l, 1/l), dP^T, dS^T, then dk += dS^T qs and dv +=
//   round(P^T) G, 16 queries at a time. Its operand fragments are re-read
//   from shared memory (ldmatrix) where they are used, not held: fewer
//   registers, so more resident warps.
// - head_dim: any multiple of 8. A warp's output tiles hold 64 columns
//   (BART's head_dim); a wider head, off the main path, walks 64-column
//   slabs, and the products that feed a slab (S and dP for the backward's
//   dq, dk and dv; P for the forward's PV) are recomputed or re-rounded for
//   each: the same instructions, so the same bits. Such heads take one
//   instantiation (KC 16, any key length, a template flag); at head_dim
//   <= 64 the flag folds the slab loops away at compile time.
// The bf16 kernels are in train_attention_tc.cuh, instantiated here (the
// forward), in train_attention_bwd.cu and in train_attention_wide.cu, so
// that nvcc builds the three at once.
// Grid (H, B) with one warp per 16-row tile (at most 6 or 8, looping
// beyond): one (b, h) pair is 40-96 rows, too little to split further, and
// a block per pair reads each K and V row once. At these lengths the
// kernels are bound by latency more than by bytes, so residency decides:
// blocks are capped at 112 or 128 registers a thread, and several share an
// SM, one block's loads overlapping another's products.
//
// The float instantiation (dtype_code float, off the main path) keeps the
// first version's scalar code: one block per (head, batch), a warp per row,
// fmaf dot products from fp32 copies in shared memory.
#include "train_attention_tc.cuh"

using namespace kmb_ta;

cudaError_t kmb_ta::launch_fwd_tc(const FwdArgs& a, cudaStream_t stream) {
  if (a.hd > kSlab) return launch_fwd_tc_wide(a, stream);
  switch (kc_bucket(a.Tk)) {
#define KMB_FWD(KC) \
  case KC:          \
    return launch_fwd_kc<KC, false>(a, stream);
    KMB_KC_CASES(KMB_FWD)
#undef KMB_FWD
  }
  return cudaErrorInvalidValue;
}

namespace {

// ---------------------------------------------------------------------------
// float path: the first version's scalar kernels

constexpr int kWarps = 4;

__global__ void __launch_bounds__(kWarps * 32)
train_attention_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
                        const float* __restrict__ v, const int64_t* __restrict__ mask,
                        float* __restrict__ out, int Tq, int Tk, int D, int hd, int ldq,
                        int ldk, int ldv, int causal, float scale) {
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
    const size_t row = (size_t)b * Tk + j;
    k_s[j * ld + d] = k[row * ldk + (size_t)h * hd + d];
    v_s[j * ld + d] = v[row * ldv + (size_t)h * hd + d];
  }
  __syncthreads();

  for (int i = warp; i < Tq; i += kWarps) {
    const float* q_row = q + ((size_t)b * Tq + i) * ldq + (size_t)h * hd;
    for (int d = lane; d < hd; d += 32) q_w[d] = q_row[d] * scale;
    __syncwarp();

    float m = -INFINITY;
    for (int j = lane; j < Tk; j += 32) {
      float s = 0.f;
      const float* k_row = k_s + j * ld;
      for (int d = 0; d < hd; ++d) s = fmaf(q_w[d], k_row[d], s);
      s += key_bias(mask, b, Tk, j);
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
    for (int j = lane; j < Tk; j += 32) p_w[j] = p_w[j] / l;
    __syncwarp();

    float* o_row = out + ((size_t)b * Tq + i) * D + (size_t)h * hd;
    for (int d = lane; d < hd; d += 32) {
      float acc = 0.f;
      for (int j = 0; j < Tk; ++j) acc = fmaf(p_w[j], v_s[j * ld + d], acc);
      o_row[d] = acc;
    }
    __syncwarp();
  }
}

size_t fwd_f32_smem_bytes(int Tk, int hd) {
  return sizeof(float) * (2 * (size_t)Tk * (hd + 1) + kWarps * (size_t)(hd + Tk));
}

constexpr int kBwdWarps = 8;

size_t bwd_f32_smem_bytes(int Tq, int Tk, int hd) {
  const int ld = hd + 1;
  const size_t tiles = sizeof(float) * (size_t)ld * (2 * (size_t)Tq + 2 * (size_t)Tk);
  const size_t stats = sizeof(float) * 3 * (size_t)Tq;
  const int row = Tq > Tk ? Tq : Tk;
  const size_t scratch = sizeof(float) * kBwdWarps * 2 * (size_t)row;
  return tiles + stats + scratch;
}

// pass 1 a warp per query row (lanes own keys for s, p, dp, then split
// head_dim for dq), pass 2 a warp per key row (the transposed recompute,
// lanes own queries, then split head_dim for dk and dv)
__global__ void __launch_bounds__(kBwdWarps * 32)
train_attention_bwd_f32(const float* __restrict__ q, const float* __restrict__ k,
                        const float* __restrict__ v, const int64_t* __restrict__ mask,
                        const float* __restrict__ g, float* __restrict__ dq,
                        float* __restrict__ dk, float* __restrict__ dv, int Tq, int Tk, int D,
                        int hd, int ldq, int ldk, int ldv, int causal, float scale_q,
                        float scale_dq) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int ld = hd + 1;
  float* q_s = reinterpret_cast<float*>(smem_raw);  // [Tq][ld], q * scale_q
  float* g_s = q_s + (size_t)Tq * ld;               // [Tq][ld]
  float* k_s = g_s + (size_t)Tq * ld;               // [Tk][ld]
  float* v_s = k_s + (size_t)Tk * ld;               // [Tk][ld]
  float* m_s = v_s + (size_t)Tk * ld;               // [Tq]
  float* l_s = m_s + Tq;
  float* r_s = l_s + Tq;
  const int row = Tq > Tk ? Tq : Tk;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  float* a_w = r_s + Tq + (size_t)warp * 2 * row;  // this warp's two scratch rows
  float* b_w = a_w + row;

  for (int i = threadIdx.x; i < Tq * hd; i += blockDim.x) {
    const int t = i / hd, d = i % hd;
    const size_t r = (size_t)b * Tq + t;
    q_s[t * ld + d] = q[r * ldq + (size_t)h * hd + d] * scale_q;
    g_s[t * ld + d] = g[r * D + (size_t)h * hd + d];
  }
  for (int i = threadIdx.x; i < Tk * hd; i += blockDim.x) {
    const int t = i / hd, d = i % hd;
    const size_t r = (size_t)b * Tk + t;
    k_s[t * ld + d] = k[r * ldk + (size_t)h * hd + d];
    v_s[t * ld + d] = v[r * ldv + (size_t)h * hd + d];
  }
  __syncthreads();

  for (int i = warp; i < Tq; i += kBwdWarps) {
    const float* qi = q_s + i * ld;
    const float* gi = g_s + i * ld;
    float m = -INFINITY;
    for (int j = lane; j < Tk; j += 32) {
      const float* kj = k_s + j * ld;
      float s = 0.f;
      for (int d = 0; d < hd; ++d) s = fmaf(qi[d], kj[d], s);
      s += key_bias(mask, b, Tk, j);
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
      const float* vj = v_s + j * ld;
      float dp = 0.f;
      for (int d = 0; d < hd; ++d) dp = fmaf(gi[d], vj[d], dp);
      a_w[j] = p;
      b_w[j] = dp;
      r += p * dp;
    }
    r = warp_sum(r);
    for (int j = lane; j < Tk; j += 32) a_w[j] = a_w[j] * (b_w[j] - r);
    if (lane == 0) {
      m_s[i] = m;
      l_s[i] = l;
      r_s[i] = r;
    }
    __syncwarp();
    float* dq_row = dq + ((size_t)b * Tq + i) * D + (size_t)h * hd;
    for (int d = lane; d < hd; d += 32) {
      float acc = 0.f;
      for (int j = 0; j < Tk; ++j) acc = fmaf(a_w[j], k_s[j * ld + d], acc);
      dq_row[d] = acc * scale_dq;
    }
    __syncwarp();
  }
  __syncthreads();

  for (int j = warp; j < Tk; j += kBwdWarps) {
    const float* kj = k_s + j * ld;
    const float* vj = v_s + j * ld;
    for (int i = lane; i < Tq; i += 32) {
      const float* qi = q_s + i * ld;
      const float* gi = g_s + i * ld;
      float s = 0.f;
      for (int d = 0; d < hd; ++d) s = fmaf(qi[d], kj[d], s);
      s += key_bias(mask, b, Tk, j);
      if (causal && j > i) s = KMB_NEG_INF;
      const float p = expf(s - m_s[i]) / l_s[i];
      float dp = 0.f;
      for (int d = 0; d < hd; ++d) dp = fmaf(gi[d], vj[d], dp);
      a_w[i] = p * (dp - r_s[i]);
      b_w[i] = p;
    }
    __syncwarp();
    float* dk_row = dk + ((size_t)b * Tk + j) * D + (size_t)h * hd;
    float* dv_row = dv + ((size_t)b * Tk + j) * D + (size_t)h * hd;
    for (int d = lane; d < hd; d += 32) {
      float ak = 0.f, av = 0.f;
      for (int i = 0; i < Tq; ++i) {
        ak = fmaf(a_w[i], q_s[i * ld + d], ak);
        av = fmaf(b_w[i], g_s[i * ld + d], av);
      }
      dk_row[d] = ak;
      dv_row[d] = av;
    }
    __syncwarp();
  }
}

}  // namespace

KMB_EXPORT size_t kmb_train_attention_smem_bytes(int Tq, int Tk, int hd, int dtype) {
  return dtype == KMB_BF16 ? fwd_tc_smem_bytes(Tq, Tk, hd) : fwd_f32_smem_bytes(Tk, hd);
}

KMB_EXPORT size_t kmb_train_attention_bwd_smem_bytes(int Tq, int Tk, int hd, int dtype) {
  if (dtype == KMB_BF16)
    return bwd_tc_smem_bytes(Tq, Tk, hd, bwd_warps(Tq, Tk));
  return bwd_f32_smem_bytes(Tq, Tk, hd);
}

KMB_EXPORT int kmb_train_attention_fwd(const void* q, const void* k, const void* v,
                                       const void* mask, void* out, int B, int Tq, int Tk,
                                       int D, int H, int ldq, int ldk, int ldv, int causal,
                                       float scale, int dtype, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  const int64_t* kb = (const int64_t*)mask;
  const int hd = D / H;
  if (dtype == KMB_BF16) {
    if (hd % 8 || Tk > 16 * 16) return cudaErrorInvalidValue;
    const FwdArgs a = {(const bf16*)q, (const bf16*)k, (const bf16*)v, kb, (bf16*)out, B, Tq,
                       Tk, H, hd, ldq, ldk, ldv, causal, scale};
    return launch_fwd_tc(a, s);
  }
  if (dtype == KMB_F32) {
    const size_t smem = fwd_f32_smem_bytes(Tk, hd);
    cudaError_t err = kmb_allow_smem(train_attention_fwd_f32, smem);
    if (err != cudaSuccess) return err;
    train_attention_fwd_f32<<<dim3(H, B), kWarps * 32, smem, s>>>(
        (const float*)q, (const float*)k, (const float*)v, kb, (float*)out, Tq, Tk, D, hd, ldq,
        ldk, ldv, causal, scale);
    return cudaGetLastError();
  }
  return cudaErrorInvalidValue;
}

KMB_EXPORT int kmb_train_attention_bwd(const void* q, const void* k, const void* v,
                                       const void* mask, const void* g, void* dq, void* dk,
                                       void* dv, int B, int Tq, int Tk, int D, int H, int ldq,
                                       int ldk, int ldv, int causal, float scale_q,
                                       float scale_dq, int dtype, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  const int64_t* kb = (const int64_t*)mask;
  const int hd = D / H;
  if (dtype == KMB_BF16) {
    if (hd % 8 || Tk > 16 * 16) return cudaErrorInvalidValue;
    const BwdArgs a = {(const bf16*)q, (const bf16*)k, (const bf16*)v, kb, (const bf16*)g,
                       (bf16*)dq, (bf16*)dk, (bf16*)dv, B, Tq, Tk, H, hd, ldq, ldk, ldv,
                       causal, scale_q, scale_dq};
    return launch_bwd_tc(a, s);
  }
  if (dtype == KMB_F32) {
    const size_t smem = bwd_f32_smem_bytes(Tq, Tk, hd);
    cudaError_t err = kmb_allow_smem(train_attention_bwd_f32, smem);
    if (err != cudaSuccess) return err;
    train_attention_bwd_f32<<<dim3(H, B), kBwdWarps * 32, smem, s>>>(
        (const float*)q, (const float*)k, (const float*)v, kb, (const float*)g, (float*)dq,
        (float*)dk, (float*)dv, Tq, Tk, D, hd, ldq, ldk, ldv, causal, scale_q, scale_dq);
    return cudaGetLastError();
  }
  return cudaErrorInvalidValue;
}
