// Runtime helpers the Python side calls around the kernel launches.
#include "common.cuh"

KMB_EXPORT const char* kmb_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// This library carries its own (static) CUDA runtime: its current device is
// set to the tensor's before every launch, like PyTorch's own.
KMB_EXPORT int kmb_set_device(int device) { return cudaSetDevice(device); }
