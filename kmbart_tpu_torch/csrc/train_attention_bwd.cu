// K1's backward on the tensor cores, head_dim <= 64: one instantiation a
// key bucket (the kernel is in train_attention_tc.cuh, its design in
// train_attention.cu's source note). Replaces
// kmbart_tpu/ops/pallas_train_attention.py:223 _bwd_call.
#include "train_attention_tc.cuh"

using namespace kmb_ta;

cudaError_t kmb_ta::launch_bwd_tc(const BwdArgs& a, cudaStream_t stream) {
  if (a.hd > kSlab) return launch_bwd_tc_wide(a, stream);
  switch (kc_bucket(a.Tk)) {
#define KMB_BWD(KC) \
  case KC:          \
    return launch_bwd_kc<KC, false>(a, stream);
    KMB_KC_CASES(KMB_BWD)
#undef KMB_BWD
  }
  return cudaErrorInvalidValue;
}
