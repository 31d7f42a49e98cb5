// Shared by every kernel source of repro_torch.  Each source is compiled on
// its own into a shared library with a plain C interface: device pointers
// and the stream arrive as void*, and each launcher returns the
// cudaError_t of its launch as an int (0 = success).
#pragma once
#include <cstdint>
#include <cuda_runtime.h>

extern "C" const char* repro_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
