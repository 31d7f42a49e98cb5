// B7: forward attention with an online softmax, GQA, causal and
// sliding-window masks (prefill of every attention layer).
//
// Replaces the TPU kernel `flash_attention_pallas` / `_flash_kernel`
// (src/repro/kernels/flash_attention.py), reached through
// `ops.flash_attention`.
//
// Function.  q is (b, hq, sq, dh), k and v are (b, hkv, sk, dh), all
// contiguous, float32 or bfloat16 (one type for all four tensors, the output
// included).  Query head h reads kv head h / (hq / hkv).  For query row
// qpos and key kpos the score is dot(q, k) * scale (scale = 1/sqrt(dh),
// computed by the caller), replaced by -1e30 unless
//   kpos < sk, (not causal or kpos <= qpos), (no window or qpos - kpos < window).
// A running max m, denominator l and accumulator acc in float32 take each
// key tile as the TPU kernel does: m' = max(m, max_k s), alpha = exp(m - m'),
// p = exp(s - m'), l = l alpha + sum_k p, acc = acc alpha + p v; the output
// is acc / max(l, 1e-30) rounded to the input type.  The probabilities stay
// float32 into the PV product.  Products of bf16 inputs are exact in float32,
// so the kernel differs from its plain version (`ref.flash_attention_ref`)
// only in the order of the sums.  Every query row must see at least one key
// (the wrapper refuses shapes where one would not).
//
// Bound on the H100.  The prefill's layer (1 x 32 heads x 32,768 rows,
// dh 120, causal, window 4,096) does 4 dh operations for each of its 1.26e8
// unmasked (query, key) pairs a head, 1.93e12 in all: 28.8 ms at the fp32
// rate of the CUDA cores (67 TFLOP/s), against 0.19 ms for its 629 MB of
// bytes.  So it is bound by operations.
//
// Design (simple and right first; tensor cores and TMA come later).  One
// block of 128 threads per (64-row query tile, query head, batch row).  It
// keeps its query tile in shared memory as float32 and walks only the
// 64-key tiles that the causal band and the window reach (the "causal
// grid-skip"): a tile wholly masked for a row adds exp(-1e30 - m) = 0 to
// it, and one before the row's first key is wiped by alpha = exp(-1e30 - m)
// = 0, so skipping them is exact.  For each tile it stages K and V in shared
// memory as float32 (zeros past sk and past dh), computes the 64 x 64 scores
// with fp32 FMAs on the CUDA cores (a thread owns 4 rows x 8 interleaved
// keys), applies the masks and the online softmax in registers (row max and
// sum over the 8 lanes that share a row), writes the probabilities
// transposed to shared memory, and adds P V into its 4 rows x (4 x NC4)
// columns of the accumulator.  Shared-memory strides are chosen so that
// each quarter-warp's 16-byte loads hit distinct banks.
#include <cuda_bf16.h>

#include "common.cuh"

namespace {

constexpr int BQ = 64;          // query rows per block
constexpr int BK = 64;          // keys per tile
constexpr int THREADS = 128;    // 16 row groups (4 rows) x 8 key groups
constexpr int PST = BQ + 4;     // stride of the transposed probabilities
constexpr float NEG_INF = -1e30f;
static_assert(BQ == BK, "load_tile stages BK rows for the query tile too");

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);   // round to nearest even, as torch's cast
}

// Row stride of the query and key tiles: dh rounded up to 8, plus 4, so the
// stride is an odd multiple of 4 floats and the 8 key groups' float4 loads
// of one quarter-warp fall in distinct banks.
__host__ __device__ __forceinline__ int qk_stride(int dh) {
  return (dh + 7) / 8 * 8 + 4;
}

// rows x width floats into dst (row stride `stride`) from `valid` rows of
// dh elements at src; zeros past `valid` rows and past dh columns.
template <typename T>
__device__ __forceinline__ void load_tile(float* dst, const T* __restrict__ src,
                                          int valid, int dh, int width,
                                          int stride) {
  for (int e = threadIdx.x; e < BK * width; e += THREADS) {
    const int r = e / width, c = e - r * width;
    dst[r * stride + c] = (r < valid && c < dh)
        ? to_float(src[static_cast<long long>(r) * dh + c]) : 0.0f;
  }
}

__device__ __forceinline__ float group8_max(float x) {
#pragma unroll
  for (int o = 1; o < 8; o <<= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float group8_sum(float x) {
#pragma unroll
  for (int o = 1; o < 8; o <<= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// NC4: output columns per thread in float4 groups; dh <= 32 * NC4.
template <typename T, int NC4>
__global__ void __launch_bounds__(THREADS)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ out, int hq,
                       int hkv, int sq, int sk, int dh, int causal,
                       int window, float scale) {
  constexpr int VST = 32 * NC4;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int qst = qk_stride(dh);
  const int d4 = (dh + 3) / 4 * 4;
  float* Qs = smem;                 // [BQ][qst]
  float* Ks = Qs + BQ * qst;        // [BK][qst]
  float* Vs = Ks + BK * qst;        // [BK][VST]
  float* Pt = Vs + BK * VST;        // [BK][PST], probabilities transposed

  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int q_rows = min(BQ, sq - q0);
  const long long head = static_cast<long long>(b) * hq + h;
  const long long kv_head = static_cast<long long>(b) * hkv + h / (hq / hkv);
  const T* kg = k + kv_head * sk * dh;
  const T* vg = v + kv_head * sk * dh;
  T* og = out + (head * sq + q0) * dh;
  const int rg = threadIdx.x >> 3;    // rows 4 rg .. 4 rg + 3
  const int cg = threadIdx.x & 7;     // keys cg + 8 j; columns 4 cg + 32 j + e

  load_tile(Qs, q + (head * sq + q0) * dh, q_rows, dh, d4, qst);

  float m[4], l[4];
  float4 acc[4][NC4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.0f;
#pragma unroll
    for (int j = 0; j < NC4; ++j) acc[i][j] = make_float4(0.f, 0.f, 0.f, 0.f);
  }

  // The keys any row of this tile can see: [lo, hi).
  const int lo = window > 0 ? max(0, q0 - window + 1) : 0;
  const int hi = causal ? min(sk, q0 + q_rows) : sk;
  for (int k0 = lo / BK * BK; k0 < hi; k0 += BK) {
    const int k_rows = min(BK, sk - k0);
    __syncthreads();              // the last tile's P V is done with Vs, Pt
    load_tile(Ks, kg + static_cast<long long>(k0) * dh, k_rows, dh, d4, qst);
    load_tile(Vs, vg + static_cast<long long>(k0) * dh, k_rows, dh, VST, VST);
    __syncthreads();

    float s[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) s[i][j] = 0.0f;
    for (int d = 0; d < d4; d += 4) {
      float4 qv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qv[i] = *reinterpret_cast<const float4*>(Qs + (4 * rg + i) * qst + d);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float4 kv =
            *reinterpret_cast<const float4*>(Ks + (cg + 8 * j) * qst + d);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          float a = s[i][j];
          a = fmaf(qv[i].x, kv.x, a);
          a = fmaf(qv[i].y, kv.y, a);
          a = fmaf(qv[i].z, kv.z, a);
          a = fmaf(qv[i].w, kv.w, a);
          s[i][j] = a;
        }
      }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + 4 * rg + i;
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int kpos = k0 + cg + 8 * j;
        const bool ok = kpos < sk && (!causal || kpos <= qpos) &&
                        (window <= 0 || qpos - kpos < window);
        s[i][j] = ok ? s[i][j] * scale : NEG_INF;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], group8_max(mx));
      const float alpha = expf(m[i] - m_new);
      float ps = 0.0f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        s[i][j] = expf(s[i][j] - m_new);
        ps += s[i][j];
      }
      l[i] = l[i] * alpha + group8_sum(ps);
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < NC4; ++j) {
        acc[i][j].x *= alpha;
        acc[i][j].y *= alpha;
        acc[i][j].z *= alpha;
        acc[i][j].w *= alpha;
      }
    }
#pragma unroll
    for (int j = 0; j < 8; ++j)
      *reinterpret_cast<float4*>(Pt + (cg + 8 * j) * PST + 4 * rg) =
          make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
    __syncthreads();

    for (int kk = 0; kk < k_rows; ++kk) {
      const float4 p = *reinterpret_cast<const float4*>(Pt + kk * PST + 4 * rg);
      const float pr[4] = {p.x, p.y, p.z, p.w};
#pragma unroll
      for (int j = 0; j < NC4; ++j) {
        const float4 vv =
            *reinterpret_cast<const float4*>(Vs + kk * VST + 4 * cg + 32 * j);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          acc[i][j].x = fmaf(pr[i], vv.x, acc[i][j].x);
          acc[i][j].y = fmaf(pr[i], vv.y, acc[i][j].y);
          acc[i][j].z = fmaf(pr[i], vv.z, acc[i][j].z);
          acc[i][j].w = fmaf(pr[i], vv.w, acc[i][j].w);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = 4 * rg + i;
    if (r >= q_rows) continue;
    const float denom = fmaxf(l[i], 1e-30f);
    T* row = og + static_cast<long long>(r) * dh;
#pragma unroll
    for (int j = 0; j < NC4; ++j) {
      const int c = 4 * cg + 32 * j;
      const float a[4] = {acc[i][j].x, acc[i][j].y, acc[i][j].z, acc[i][j].w};
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (c + e < dh) store(row + c + e, a[e] / denom);
    }
  }
}

template <typename T, int NC4>
int launch(const void* q, const void* k, const void* v, void* out, int b,
           int hq, int hkv, int sq, int sk, int dh, int causal, int window,
           float scale, cudaStream_t stream) {
  const int qst = qk_stride(dh);
  const size_t bytes =
      sizeof(float) * (static_cast<size_t>(BQ + BK) * qst + BK * 32 * NC4 +
                       BK * PST);
  auto kern = flash_attention_kernel<T, NC4>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((sq + BQ - 1) / BQ, hq, b);
  kern<<<grid, THREADS, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), hq, hkv, sq, sk, dh,
      causal, window, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_type(const void* q, const void* k, const void* v, void* out, int b,
                int hq, int hkv, int sq, int sk, int dh, int causal,
                int window, float scale, cudaStream_t s) {
  switch ((dh + 31) / 32) {
    case 1: return launch<T, 1>(q, k, v, out, b, hq, hkv, sq, sk, dh, causal, window, scale, s);
    case 2: return launch<T, 2>(q, k, v, out, b, hq, hkv, sq, sk, dh, causal, window, scale, s);
    case 3: return launch<T, 3>(q, k, v, out, b, hq, hkv, sq, sk, dh, causal, window, scale, s);
    case 4: return launch<T, 4>(q, k, v, out, b, hq, hkv, sq, sk, dh, causal, window, scale, s);
    case 5: return launch<T, 5>(q, k, v, out, b, hq, hkv, sq, sk, dh, causal, window, scale, s);
    case 6: return launch<T, 6>(q, k, v, out, b, hq, hkv, sq, sk, dh, causal, window, scale, s);
    case 7: return launch<T, 7>(q, k, v, out, b, hq, hkv, sq, sk, dh, causal, window, scale, s);
    case 8: return launch<T, 8>(q, k, v, out, b, hq, hkv, sq, sk, dh, causal, window, scale, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// window <= 0 means no window; is_bf16 selects bfloat16 over float32.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* out, int b, int hq,
                                      int hkv, int sq, int sk, int dh,
                                      int causal, int window, int is_bf16,
                                      float scale, void* stream) {
  if (b < 1 || hkv < 1 || hq % hkv != 0 || sq < 1 || sk < 1 || dh < 1 ||
      dh > 256 || hq > 65535 || b > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16
      ? launch_type<__nv_bfloat16>(q, k, v, out, b, hq, hkv, sq, sk, dh,
                                   causal, window, scale, s)
      : launch_type<float>(q, k, v, out, b, hq, hkv, sq, sk, dh, causal,
                           window, scale, s);
}
