// Shared by every kernel library of the port (each .cu is its own .so).
//
// Each library links the CUDA runtime statically, so it keeps its own
// current device: every launcher takes the device ordinal of its tensors
// and sets it before launching on the stream PyTorch hands over.
#pragma once
#include <cuda_runtime.h>

// Message for a cudaError_t returned by a launcher (the Python wrapper
// raises with it).
extern "C" const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
