// K1 and its backward for heads wider than one 64-column slab (off the main
// path: BART's head_dim is 64), one instantiation each for every key length
// up to 256; built apart so that it compiles beside the others.
#include "train_attention_tc.cuh"

using namespace kmb_ta;

cudaError_t kmb_ta::launch_fwd_tc_wide(const FwdArgs& a, cudaStream_t stream) {
  return launch_fwd_kc<kKcWide, true>(a, stream);
}

cudaError_t kmb_ta::launch_bwd_tc_wide(const BwdArgs& a, cudaStream_t stream) {
  return launch_bwd_kc<kKcWide, true>(a, stream);
}
