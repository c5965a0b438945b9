// K1's backward (K1b) on wgmma at head_dim 64, one instantiation a key
// bucket (the kernel is in train_attention_wg.cuh, its design in
// train_attention_wg.cu's source note). Replaces
// kmbart_tpu/ops/pallas_train_attention.py:223 _bwd_call.
#include "train_attention_wg.cuh"

using namespace kmb_taw;

namespace {

unsigned configured[kMaxLen / 16 + 1];

BwdKernel bwd_kernel(int kc) {
  switch (kc) {
#define KMB_CASE(KC) \
  case KC:           \
    return attn_bwd_wg<KC>;
    KMB_TAW_KC_CASES(KMB_CASE)
#undef KMB_CASE
  }
  return nullptr;
}

}  // namespace

int kmb_taw::bwd_resident(int Tq, int Tk) {
  const Geometry geo = geometry(Tq, Tk, true);
  return resident(bwd_kernel(geo.rk / 16), configured[geo.rk / 16], geo);
}

KMB_EXPORT int kmb_train_attention_wg_bwd(const void* q, const void* k, const void* v,
                                          const void* mask, const void* g, void* dq, void* dk,
                                          void* dv, int B, int Tq, int Tk, int D, int H, int ldq,
                                          int ldk, int ldv, int causal, float scale_q,
                                          float scale_dq, int grid, int smem, void* stream) {
  if (!takes(Tq, Tk, D, H, causal) || B < 1 || grid < 1) return cudaErrorInvalidValue;
  const Geometry geo = geometry(Tq, Tk, true);
  if (smem != geo.total) return cudaErrorInvalidValue;
  const int kc = geo.rk / 16;
  const BwdKernel kernel = bwd_kernel(kc);
  cudaError_t err = configure(kernel, configured[kc]);
  int device = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&device);
  CUtensorMap mq, mk, mv, mg, mdq, mdk, mdv;
  if (err == cudaSuccess) err = cached_map3(&mq, q, D, Tq, B, ldq, geo.rq, device);
  if (err == cudaSuccess) err = cached_map3(&mk, k, D, Tk, B, ldk, geo.rk, device);
  if (err == cudaSuccess) err = cached_map3(&mv, v, D, Tk, B, ldv, geo.rk, device);
  if (err == cudaSuccess) err = cached_map3(&mg, g, D, Tq, B, D, geo.rq, device);
  if (err == cudaSuccess) err = cached_map3(&mdq, dq, D, Tq, B, D, 64, device);
  if (err == cudaSuccess) err = cached_map3(&mdk, dk, D, Tk, B, D, 64, device);
  if (err == cudaSuccess) err = cached_map3(&mdv, dv, D, Tk, B, D, 64, device);
  if (err != cudaSuccess) return err;
  const Args a = {(const int64_t*)mask, Tq, Tk, H, causal, B * H, scale_q, scale_dq};
  kernel<<<grid, threads(geo), geo.total, (cudaStream_t)stream>>>(mq, mk, mv, mg, mdq, mdk, mdv,
                                                                  a);
  return cudaGetLastError();
}
