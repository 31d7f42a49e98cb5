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

// cp.async (Ampere and later): 16 bytes from global memory to the shared
// address `dst` (as __cvta_generic_to_shared gives it), zero-filled past
// `src_bytes`; grouped by commit, waited for by group.
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes)
               : "memory");
}
// 4 bytes, through L1 (.ca): for rows whose stride is not a multiple of 16.
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// Waits until at most N of this thread's newest groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
