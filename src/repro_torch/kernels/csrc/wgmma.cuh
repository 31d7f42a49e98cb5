// Hopper tensor-core helpers shared by B7's bf16 bodies, the forward
// (flash_attention.cu) and the backward (flash_attention_bwd.cu): `wgmma`
// m64n64k16 on bf16 operands with float32 accumulators, the 128-byte-swizzle
// shared-memory descriptors it reads, the fences around it, the `cp.async`
// copy of bf16 rows into that layout, ex2, and the exact split of a float32
// into three bf16 parts.  Needs sm_90a.
#pragma once
#include <cuda_bf16.h>

#include "common.cuh"

namespace {

constexpr int ATOM = 1024;     // one swizzle atom: 8 rows x 128 bytes
constexpr float LOG2E = 1.4426950408889634f;

// A `wgmma` shared-memory descriptor of a 128-byte-swizzled operand:
// start address, leading and stride byte offsets (16-byte units), layout 1
// (128-byte swizzle).  The stride byte offset steps between 8-row groups.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFFu) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void st_shared16(uint32_t dst, uint4 v) {
  asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(dst),
               "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w)
               : "memory");
}
// Shared-memory writes of this thread made visible to `wgmma` (the async
// proxy) once the block has passed its next barrier.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Pins accumulator registers in program order around the asynchronous
// products.
__device__ __forceinline__ void fence_regs(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define B7_D32(d)                                                            \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),    \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),           \
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),       \
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),       \
      "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),       \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),       \
      "+f"(d[31])
#define B7_REGS32                                                            \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "  \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "   \
  "%30, %31}"

// d (64 x 64, float32) += A (64 x 16) B (16 x 64): A and B bf16 in shared
// memory, both K-major.
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t a,
                                         uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " B7_REGS32
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : B7_D32(d)
      : "l"(a), "l"(b), "r"(1));
}

// d += A B with A from registers (the fragment of a 64 x 16 bf16 tile) and
// B in shared memory, MN-major (read transposed).
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4],
                                         uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " B7_REGS32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : B7_D32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 x) {
  return *reinterpret_cast<uint32_t*>(&x);
}

// ROWS rows of dh bf16 at src (`valid` of them exist) into NA swizzled
// column atoms at dst: atom a holds columns 64 a .. 64 a + 63 of every row,
// ROWS * 128 bytes; zeros past `valid` rows and past dh.  Thread i of the
// THREADS copies 16-byte chunk i % 8 of every atom's rows i / 8 + (THREADS /
// 8) p, so its shared offsets and its swizzle are fixed.  With `async` the
// chunks go by cp.async (rows 16-byte aligned, dh % 8 == 0); otherwise by
// ordinary loads and shared stores.
template <int THREADS, int NA, int ROWS>
__device__ __forceinline__ void load_tile(uint32_t dst,
                                          const __nv_bfloat16* __restrict__ src,
                                          int valid, int dh, bool async) {
  static_assert(ROWS % (THREADS / 8) == 0, "whole passes of the block");
  const int ch = threadIdx.x & 7, r0 = threadIdx.x >> 3;
  const uint32_t d0 = dst + r0 * 128 + ((ch ^ (r0 & 7)) << 4);
  const __nv_bfloat16* g0 = src + static_cast<long long>(r0) * dh + 8 * ch;
  constexpr int STEP = THREADS / 8;            // rows a pass
  if (async) {
#pragma unroll
    for (int a = 0; a < NA; ++a)
#pragma unroll
      for (int p = 0; p < ROWS / STEP; ++p) {
        const bool ok = r0 + STEP * p < valid && 64 * a + 8 * ch < dh;
        const __nv_bfloat16* g =
            g0 + static_cast<long long>(STEP * p) * dh + 64 * a;
        cp_async16(d0 + a * (ROWS * 128) + p * (STEP * 128), ok ? g : src,
                   ok ? 16 : 0);
      }
    return;
  }
  for (int a = 0; a < NA; ++a)
    for (int p = 0; p < ROWS / STEP; ++p) {
      const int r = r0 + STEP * p, col = 64 * a + 8 * ch;
      const unsigned short* ps = reinterpret_cast<const unsigned short*>(
          g0 + static_cast<long long>(STEP * p) * dh + 64 * a);
      uint32_t h[8];
#pragma unroll
      for (int e = 0; e < 8; ++e)
        h[e] = (r < valid && col + e < dh) ? ps[e] : 0u;
      st_shared16(d0 + a * (ROWS * 128) + p * (STEP * 128),
                  make_uint4(h[0] | (h[1] << 16), h[2] | (h[3] << 16),
                             h[4] | (h[5] << 16), h[6] | (h[7] << 16)));
    }
}

// 2^x, flushing results below 2^-126 to 0 (one MUFU operation).
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Two float32 values in three bf16 pairs, each rounded to nearest even:
// hi = bf16(x), mid = bf16(x - hi), lo = bf16(x - hi - mid).  Each
// subtraction is exact, so hi + mid + lo == x for |x| in [2^-100, inf)
// (`ref.split_bf16x3`).
__device__ __forceinline__ void split_bf16x3(float x0, float x1, uint32_t& hi,
                                             uint32_t& mid, uint32_t& lo) {
  const __nv_bfloat162 hb = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(hb);
  const float r0 = x0 - hf.x, r1 = x1 - hf.y;
  const __nv_bfloat162 mb = __floats2bfloat162_rn(r0, r1);
  const float2 mf = __bfloat1622float2(mb);
  const __nv_bfloat162 lb = __floats2bfloat162_rn(r0 - mf.x, r1 - mf.y);
  hi = bits(hb);
  mid = bits(mb);
  lo = bits(lb);
}

}  // namespace
