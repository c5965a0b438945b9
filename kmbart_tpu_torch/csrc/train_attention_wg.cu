// K1 and K1b at head_dim 64 in bf16, rebuilt on Hopper's machinery: TMA,
// mbarrier pipelines, wgmma and persistent blocks.
//
// The forward replaces kmbart_tpu/ops/pallas_train_attention.py:194
// _fwd_call (body _fwd_kernel :52), the backward (train_attention_wg_bwd.cu)
// :223 _bwd_call (body _bwd_kernel :76). The function, with every rounding
// point, is train_attention.cu's (its first 23 lines): qs, p, out and ds
// rounded to bf16; r = sum p dp with the unrounded p; dv from round(p).
//
// What bounds them on an H100 (NVIDIA H100 80GB HBM3, 3.35 TB/s, 989
// TFLOP/s bf16): the bytes. Each input read once and each output written
// once, the generation encoder G (B 64, 72 x 72, D 768, H 12) moves 28.3 MB
// for 1.0 GFLOP (8.5 us against 1.0 us); the fine-tune encoder F (B 128, 72
// x 72) 56.6 MB forward (16.9 us) and 99.1 MB backward for 5.1 GFLOP (29.6
// us against 5.2 us); the pretraining encoder P (B 128, 96 x 96) 75.5 MB
// forward (22.6 us) and 132.1 MB backward (39.5 us against 9.2 us).
//
// PR 4's kernels (train_attention_tc.cuh, mma.sync) give a block one (b, h)
// pair: it copies the pair's rows with cp.async, waits for all of them, then
// computes, then stores, with nothing in the block overlapping its loads
// with its products or its stores; only the two or three blocks that share
// an SM overlap each other, and a grid of 1536 short blocks ends in a tail.
// Its backward recomputes S^T, P^T and dP^T in a second pass whose warps
// own key rows. At these lengths that made them bound by latency, not by
// bytes. This design:
// - Persistent blocks. The grid is the SMs times the blocks an SM holds
//   (ops/train_attention.py plan), and block x walks the pairs x, x + grid,
//   ... in order: no atomics, no tail wave of short blocks.
// - One producer warp keeps the next pairs in flight in a ring of two
//   shared-memory stages, completion on mbarriers: TMA tiles (128-byte
//   swizzle, a 64-wide bf16 head row is one swizzle row) from 3-D tensor
//   maps over [B, T, D] with the caller's row pitch (the fused QKV chunks
//   read in place), so rows past T load as zero and no pair reads another
//   batch row's data; its lanes write the pair's key bias beside it.
//   While the consumers compute pair n, pair n + 1's copy is in flight.
//   (cp.async.bulk copies of each 128-byte row need no tensor map, but they
//   land unswizzled, and wgmma's operand layouts want the swizzle or 16-byte
//   pieces: eight copies a row. TMA it is; its maps are encoded per call
//   only on a miss of a per-thread cache keyed by every input of the
//   encoding.)
// - Consumer warpgroups compute on wgmma, as flash attention does on
//   Hopper: S = Q K^T with both operands in shared memory, m64 by N = Tk
//   rounded to 16 (in pieces of 64, 32 and 16 keys); the softmax on the
//   whole row in registers (PR 4's masks, sums and division, so the same
//   P from the same S); P rounded to bf16 in registers as the register A
//   operand of P V. At head_dim 64 the scale is 2^-3, so scaling the fp32
//   sums gives the products of round(q scale) to the bit (dK's too). Each
//   output tile leaves through a shared staging tile by a TMA store that
//   clips rows past T and overlaps the next tile's products.
// - The backward keeps one pass over a pair's keys: each consumer takes
//   query tiles (S, dP = G V^T, P, r, dS, then dQ = dS K with dS as the
//   register A operand) and writes round(P) and dS once to shared memory;
//   after a barrier each takes key tiles, dV = round(P)^T G and dK = dS^T
//   Q with the P and dS tiles read as transposed (MN-major) wgmma A
//   operands, and stores them through those same tiles once read. Every
//   output row has one owner. Two consumers split a pair when it has two
//   query or key tiles, else one.
// The forward has one consumer warpgroup, its registers capped at 128 a
// thread, and its Q tiles at Tq rounded to 16 rows (a 64-row A tile reads
// on into K and V: rows whose output is not stored), so its 38-76 KB of
// shared memory at the main path's shapes leave three blocks (15 warps) on
// an SM; 64-row Q tiles and no register cap left one or two, and the
// third block made the forward faster at every main-path shape (NVIDIA
// H100 80GB HBM3). The backward's two consumers,
// 168 registers a thread and 84-199 KB with the P and dS tiles leave one
// block an SM (two at causal 40 x 40); it overlaps what it can inside a
// pair: the softmax on S with dP's products, dQ's products with the P and
// dS stores, dV's staging with dK's products, and the wait for a pair's
// last stores with the next pair's S, dP and softmax.
//
// What stays on PR 4's kernels: the float instantiation, head_dim other
// than 64 and lengths past 128 (both off the main path). A 64-row wgmma
// tile of a pair this design takes wastes rows at Tq 40 and 72, yet PR 4's
// kernel, timed beside this one at every timed shape (chip_smoke.py
// legacy_ms), measured faster at none of the main path's (PERF.md). Past 128
// keys a row's S and dP would take 128 fp32 registers a thread each, more
// than one pass holds; those lengths keep PR 4's kernel.
#include "train_attention_wg.cuh"

using namespace kmb_taw;

namespace {

unsigned configured[kMaxLen / 16 + 1];

FwdKernel fwd_kernel(int kc) {
  switch (kc) {
#define KMB_CASE(KC) \
  case KC:           \
    return attn_fwd_wg<KC>;
    KMB_TAW_KC_CASES(KMB_CASE)
#undef KMB_CASE
  }
  return nullptr;
}

}  // namespace

// blocks of the planned kernel an SM holds (negative: a CUDA error)
KMB_EXPORT int kmb_train_attention_wg_resident(int Tq, int Tk, int backward) {
  if (!takes(Tq, Tk, kHd, 1, 0)) return -(int)cudaErrorInvalidValue;
  if (backward) return bwd_resident(Tq, Tk);
  const Geometry geo = geometry(Tq, Tk, false);
  return resident(fwd_kernel(geo.rk / 16), configured[geo.rk / 16], geo);
}

KMB_EXPORT int kmb_train_attention_wg_fwd(const void* q, const void* k, const void* v,
                                          const void* mask, void* out, int B, int Tq, int Tk,
                                          int D, int H, int ldq, int ldk, int ldv, int causal,
                                          float scale, int grid, int smem, void* stream) {
  if (!takes(Tq, Tk, D, H, causal) || B < 1 || grid < 1) return cudaErrorInvalidValue;
  const Geometry geo = geometry(Tq, Tk, false);
  if (smem != geo.total) return cudaErrorInvalidValue;
  const int kc = geo.rk / 16;
  const FwdKernel kernel = fwd_kernel(kc);
  cudaError_t err = configure(kernel, configured[kc]);
  int device = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&device);
  CUtensorMap mq, mk, mv, mo;
  if (err == cudaSuccess) err = cached_map3(&mq, q, D, Tq, B, ldq, geo.rq, device);
  if (err == cudaSuccess) err = cached_map3(&mk, k, D, Tk, B, ldk, geo.rk, device);
  if (err == cudaSuccess) err = cached_map3(&mv, v, D, Tk, B, ldv, geo.rk, device);
  if (err == cudaSuccess) err = cached_map3(&mo, out, D, Tq, B, D, 64, device);
  if (err != cudaSuccess) return err;
  const Args a = {(const int64_t*)mask, Tq, Tk, H, causal, B * H, scale, 0.f};
  kernel<<<grid, threads(geo), geo.total, (cudaStream_t)stream>>>(mq, mk, mv, mo, a);
  return cudaGetLastError();
}
