// K12: AdamW over every tensor of the model in a few launches.
//
// Replaces no TPU kernel: the JAX package's AdamW (kmbart_tpu/training/
// adamw.py) is plain jitted JAX, which XLA fuses into a few loops. Eager
// PyTorch runs the same update as about 21 launches a tensor (the per-group
// "used" test, the moments, the step, the masks, the copy), some 5,700 a
// step at BART-base, and the card idles between them while the host
// dispatches. K12 is that update as three kernels a step (plus one memset)
// over a table of tensors passed by value.
//
// What it computes (training/adamw.py, the HF transformers.AdamW order),
// element by element, in fp32, each operation rounded as the plain path's
// separate launches round it (no contraction, IEEE sqrt and division):
//   m' = b1 m + (1 - b1) g
//   v' = b2 v + (1 - b2) g g
//   p' = p - (s m') / (sqrt(v') + eps)          s: the group's step size
//   p' = p' - (lr wd) p                        with weight decay
// written only where the group is used (the per-group "used" test and the
// non-finite guard ``ok``); a null gradient is a zero gradient.
//
// What bounds it on an H100: bytes. The update reads p, g, m, v and writes
// p, m, v once, 28 B a parameter: 3.95 GB at 141M parameters, 1.18 ms at
// 3.35 TB/s; the "used" test reads the gradients once more (0.17 ms), and
// stops reading a group as soon as a block has found it used.
//
// Design. A tensor is rows of contiguous elements with a row stride (a
// contiguous tensor is one row; a ZeRO-1 part, a ``narrow`` on any
// dimension, is many), described per launch in ``AdamWTable``, up to
// kTensors tensors a launch. A block takes kChunk elements of one row; a
// tensor's blocks are consecutive, and a block finds its tensor by a binary
// search of the table's cumulative block counts (kernel parameters, read
// alike by the whole block). 16-byte loads where the row's four streams are
// 16-byte aligned, four of each a thread in flight.
//   adamw_used_kernel: ORs "some gradient element != 0" into one byte a
//     group (zeroed by the launcher's memset first).
//   adamw_steps_kernel: one block; each group's used flag (and the guard),
//     its step count (in place) and its step size; the global step.
//   adamw_update_kernel: the update above, skipping unused groups' blocks.
#include <string.h>

#include "common.cuh"

namespace {

constexpr int kTensors = 384;  // tensors a launch (ops/adamw.py TABLE)
constexpr int kChunk = 4096;   // elements a block (ops/adamw.py CHUNK)
constexpr int kThreads = 256;
constexpr int kVecPerThread = kChunk / 4 / kThreads;

// Mirrored byte for byte by ops/adamw.py Table: four pointer columns, three
// int64 columns, three int32 columns, each kTensors long.
struct AdamWTable {
  float* p[kTensors];
  const float* g[kTensors];  // null: a zero gradient
  float* m[kTensors];
  float* v[kTensors];
  long long sp[kTensors];    // row strides in elements: p, g, and m and v
  long long sg[kTensors];
  long long smv[kTensors];
  int cols[kTensors];
  int group[kTensors];
  int block_end[kTensors];   // blocks of tensors 0..i, cumulative
};
static_assert(sizeof(AdamWTable) == 68 * kTensors, "ops/adamw.py Table layout");

struct Chunk {
  int tensor;
  long long row;
  int c0, n;  // first column and element count
};

__device__ __forceinline__ Chunk locate(const AdamWTable& t, int count) {
  const int b = blockIdx.x;
  int lo = 0, hi = count - 1;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (t.block_end[mid] > b) hi = mid; else lo = mid + 1;
  }
  const int local = b - (lo ? t.block_end[lo - 1] : 0);
  const int cols = t.cols[lo];
  const int per_row = (cols + kChunk - 1) / kChunk;
  Chunk c;
  c.tensor = lo;
  c.row = local / per_row;
  c.c0 = (local % per_row) * kChunk;
  c.n = min(kChunk, cols - c.c0);
  return c;
}

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

__global__ void __launch_bounds__(kThreads)
adamw_used_kernel(const __grid_constant__ AdamWTable t, int count, unsigned char* flags) {
  const Chunk c = locate(t, count);
  const int grp = t.group[c.tensor];
  const float* g = t.g[c.tensor];
  __shared__ int known;
  if (threadIdx.x == 0) known = *(volatile unsigned char*)(flags + grp);
  __syncthreads();
  if (known || g == nullptr) return;  // uniform over the block
  g += c.row * t.sg[c.tensor] + c.c0;
  bool any = false;
  int tail = 0;
  if (aligned16(g)) {
    const float4* g4 = reinterpret_cast<const float4*>(g);
    const int nvec = c.n >> 2;
#pragma unroll
    for (int k = 0; k < kVecPerThread; ++k) {
      const int j = threadIdx.x + k * kThreads;
      if (j < nvec) {
        const float4 x = g4[j];
        any |= (x.x != 0.f) | (x.y != 0.f) | (x.z != 0.f) | (x.w != 0.f);
      }
    }
    tail = nvec << 2;
  }
  for (int i = tail + threadIdx.x; i < c.n; i += kThreads) any |= g[i] != 0.f;
  if (__syncthreads_or(any) && threadIdx.x == 0) flags[grp] = 1;
}

__global__ void adamw_steps_kernel(int* steps, const unsigned char* used_in,
                                   const unsigned char* ok, int* gused, float* gstep,
                                   int groups, int per_leaf, int correct_bias, float lr,
                                   float b1, float b2) {
  const int okv = ok ? (*ok != 0) : 1;
  const int step = steps[0] + okv;
  __syncthreads();  // every thread has read the old global step
  for (int i = threadIdx.x; i < groups; i += blockDim.x) {
    int used, t;
    if (per_leaf) {
      used = (used_in[i] != 0) & okv;
      t = steps[1 + i] + used;
      steps[1 + i] = t;
    } else {
      used = okv;
      t = step;
    }
    float s = lr;
    if (correct_bias) {  // t == 0 only where the update is discarded
      const float tf = fmaxf((float)t, 1.f);
      s = __fdiv_rn(__fmul_rn(lr, __fsqrt_rn(__fsub_rn(1.f, powf(b2, tf)))),
                    __fsub_rn(1.f, powf(b1, tf)));
    }
    gused[i] = used;
    gstep[i] = s;
  }
  if (threadIdx.x == 0) steps[0] = step;
}

struct Hyper {
  float b1, c1, b2, c2, eps, wdlr;  // c1 = 1 - b1, c2 = 1 - b2, wdlr = lr wd
  int decay;
};

__device__ __forceinline__ void adam(float& p, float g, float& m, float& v, float s,
                                     const Hyper& h) {
  const float nm = __fadd_rn(__fmul_rn(h.b1, m), __fmul_rn(h.c1, g));
  const float nv = __fadd_rn(__fmul_rn(h.b2, v), __fmul_rn(h.c2, __fmul_rn(g, g)));
  float np = __fsub_rn(p, __fdiv_rn(__fmul_rn(s, nm), __fadd_rn(__fsqrt_rn(nv), h.eps)));
  if (h.decay) np = __fsub_rn(np, __fmul_rn(h.wdlr, p));
  p = np;
  m = nm;
  v = nv;
}

__device__ __forceinline__ void adam4(float4& p, float4 g, float4& m, float4& v, float s,
                                      const Hyper& h) {
  adam(p.x, g.x, m.x, v.x, s, h);
  adam(p.y, g.y, m.y, v.y, s, h);
  adam(p.z, g.z, m.z, v.z, s, h);
  adam(p.w, g.w, m.w, v.w, s, h);
}

__global__ void __launch_bounds__(kThreads)
adamw_update_kernel(const __grid_constant__ AdamWTable t, int count, const int* gused,
                    const float* gstep, Hyper h) {
  const Chunk c = locate(t, count);
  const int grp = t.group[c.tensor];
  if (!gused[grp]) return;  // uniform over the block
  const float s = gstep[grp];
  const int e = c.tensor;
  float* p = t.p[e] + c.row * t.sp[e] + c.c0;
  float* m = t.m[e] + c.row * t.smv[e] + c.c0;
  float* v = t.v[e] + c.row * t.smv[e] + c.c0;
  const float* g = t.g[e] ? t.g[e] + c.row * t.sg[e] + c.c0 : nullptr;
  int tail = 0;
  if (aligned16(p) && aligned16(m) && aligned16(v) && (g == nullptr || aligned16(g))) {
    float4* p4 = reinterpret_cast<float4*>(p);
    float4* m4 = reinterpret_cast<float4*>(m);
    float4* v4 = reinterpret_cast<float4*>(v);
    const float4* g4 = reinterpret_cast<const float4*>(g);
    const int nvec = c.n >> 2;
    float4 P[kVecPerThread], G[kVecPerThread], M[kVecPerThread], V[kVecPerThread];
#pragma unroll
    for (int k = 0; k < kVecPerThread; ++k) {
      const int j = threadIdx.x + k * kThreads;
      if (j < nvec) {
        P[k] = p4[j];
        M[k] = m4[j];
        V[k] = v4[j];
        G[k] = g4 ? g4[j] : make_float4(0.f, 0.f, 0.f, 0.f);
      }
    }
#pragma unroll
    for (int k = 0; k < kVecPerThread; ++k) {
      const int j = threadIdx.x + k * kThreads;
      if (j < nvec) {
        adam4(P[k], G[k], M[k], V[k], s, h);
        p4[j] = P[k];
        m4[j] = M[k];
        v4[j] = V[k];
      }
    }
    tail = nvec << 2;
  }
  for (int i = tail + threadIdx.x; i < c.n; i += kThreads) {
    float pi = p[i], mi = m[i], vi = v[i];
    adam(pi, g ? g[i] : 0.f, mi, vi, s, h);
    p[i] = pi;
    m[i] = mi;
    v[i] = vi;
  }
}

}  // namespace

KMB_EXPORT size_t kmb_adamw_table_bytes() { return sizeof(AdamWTable); }

// The "used" test over ``count`` tensors of ``table`` (``blocks`` their
// cumulative block count); ``clear``: zero the ``groups`` flags first (the
// step's first launch).
KMB_EXPORT int kmb_adamw_used(const void* table, int count, int blocks, void* flags, int groups,
                              int clear, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (clear) {
    const cudaError_t err = cudaMemsetAsync(flags, 0, groups, s);
    if (err != cudaSuccess) return err;
  }
  if (blocks == 0) return cudaGetLastError();
  AdamWTable t;
  memcpy(&t, table, sizeof(t));
  adamw_used_kernel<<<blocks, kThreads, 0, s>>>(t, count, (unsigned char*)flags);
  return cudaGetLastError();
}

// Each group's used flag, step count and step size, and the global step:
// ``steps`` [1 + groups] int32 (the global step, then the groups' steps),
// ``used`` [groups] bytes, ``ok`` a bool scalar or null.
KMB_EXPORT int kmb_adamw_steps(void* steps, const void* used, const void* ok, void* gused,
                               void* gstep, int groups, int per_leaf, int correct_bias,
                               float lr, float b1, float b2, void* stream) {
  adamw_steps_kernel<<<1, kThreads, 0, (cudaStream_t)stream>>>(
      (int*)steps, (const unsigned char*)used, (const unsigned char*)ok, (int*)gused,
      (float*)gstep, groups, per_leaf, correct_bias, lr, b1, b2);
  return cudaGetLastError();
}

// The update over ``count`` tensors of ``table``, in place.
KMB_EXPORT int kmb_adamw_update(const void* table, int count, int blocks, const void* gused,
                                const void* gstep, float b1, float c1, float b2, float c2,
                                float eps, float wdlr, int decay, void* stream) {
  if (blocks == 0) return cudaGetLastError();
  AdamWTable t;
  memcpy(&t, table, sizeof(t));
  const Hyper h{b1, c1, b2, c2, eps, wdlr, decay};
  adamw_update_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      t, count, (const int*)gused, (const float*)gstep, h);
  return cudaGetLastError();
}
