// B7's backward, first design: src/repro_torch/kernels/csrc/
// flash_attention_bwd.cu as it stood before its bf16 body was redesigned for
// the tensor cores (the code below is copied verbatim), for `chip_smoke.py`
// to time beside the current one on the same inputs.  Build it with `-I`
// the port's csrc directory (it includes common.cuh).  Same function as the
// current kernel (flash_attention_bwd.cu's header).
//
// B7's backward: the gradients of GQA attention with causal and
// sliding-window masks with respect to q, k and v (LM training).
//
// Replaces no TPU kernel.  The JAX package's LM training differentiates
// `chunked_attention` (src/repro/models/layers.py:89) with XLA's autodiff;
// the port runs B7 (flash_attention.cu) in the forward on the card, whose
// output has no gradient of its own, so its backward is this kernel.
//
// Function.  q, o and dout are (b, hq, sq, dh), k and v (b, hkv, sk, dh),
// all contiguous and of one type, float32 or bfloat16; lse is the float32
// (b, hq, sq) log-sum-exp of each query row's scaled scores that B7's
// forward wrote.  Query head h reads kv head h / (hq / hkv).  With
// s = (q . k) scale and the forward's masks (a key is seen when kpos < sk,
// kpos <= qpos if causal, and qpos - kpos < window if windowed),
//   P  = exp(s - lse)        (0 where the key is not seen)
//   D  = rowsum(dout o)      (one float32 a query row)
//   dV = P^T dout,  dP = dout V^T,  dS = P (dP - D),
//   dQ = scale dS K,  dK = scale dS^T Q,
// the FlashAttention-2 equations.  dK and dV sum over the hq / hkv query
// heads of their kv head.  Every product and sum is float32 on the CUDA
// cores; the gradients are rounded once to the input type.  Its plain
// version is `ref.flash_attention_bwd_ref`.
//
// Three kernels, launched in order by one entry point:
//  - `delta_kernel`: D, one warp a query row.
//  - `dkdv_kernel`: one block of 256 threads per (BR-key tile, kv head,
//    batch row).  K and V of the tile sit in shared memory as float32
//    (zeros past sk and past dh); the block walks the query heads of its
//    group in order, and for each the BR-row query tiles that can see a key
//    of the tile, in order; dK and dV stay in registers the whole time.
//  - `dq_kernel`: one block per (BR-row query tile, query head, batch row),
//    walking the key tiles its rows can see, in order; dQ in registers.
// No float atomics: every gradient element is summed by one thread in a
// fixed order, so the result is the same from run to run.
//
// Tiles: BR = 64 rows for dh <= 128, 32 above (shared memory); a thread of
// the 16 x 16 grid owns rows ty + 16 i and columns tx + 16 j of a score
// tile (BR / 16 each) and, for an accumulator, rows ty + 16 i and columns
// 4 tx + 64 c .. + 3 (NC4 = ceil(dh / 64) float4 groups).  Row strides of
// the staged tiles are 4 (mod 32) floats, so a quarter-warp's float4 loads
// of eight rows fall in distinct banks.
//
// Bound on the H100.  The gradient needs five products of 2 dh operations
// a seen (query, key) pair: S, dP, dV, dK and dQ.  At the training layer of
// h2o-danube-3-4b (b 2, 32 heads, 4,096 tokens, dh 120, causal) that is
// 6.4e11 operations: 9.6 ms at the 67 TFLOP/s of the CUDA cores, or 0.65 ms
// on the bf16 tensor cores, against 0.06 ms for the bytes.  This design
// does seven: the dQ kernel recomputes S and dP rather than sum dQ with
// atomics, 1.4 times the operations of the bound.  A first design on the
// CUDA cores, bound by operations.
#include <cuda_bf16.h>

#include "common.cuh"

namespace {

constexpr int THREADS = 256;    // a 16 x 16 grid of threads
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

__device__ __forceinline__ bool seen(int qpos, int kpos, int sk, int causal,
                                     int window) {
  return kpos < sk && (!causal || kpos <= qpos) &&
         (window <= 0 || qpos - kpos < window);
}

// BR rows of W floats into dst (row stride ST) from `valid` rows of dh
// elements at src; zeros past `valid` rows and past dh columns.
template <typename T, int BR, int W, int ST>
__device__ __forceinline__ void load_rows(float* dst,
                                          const T* __restrict__ src,
                                          int valid, int dh) {
  for (int e = threadIdx.x; e < BR * W; e += THREADS) {
    const int r = e / W, c = e - r * W;
    dst[r * ST + c] = (r < valid && c < dh)
        ? to_float(src[static_cast<long long>(r) * dh + c]) : 0.0f;
  }
}

// s[i][j] = A1 row (ty + 16 i) . B1 row (tx + 16 j) and dp likewise for A2,
// B2, over W columns, each a float32 FMA chain in column order.
template <int R, int W, int ST>
__device__ __forceinline__ void dots2(const float* A1, const float* B1,
                                      const float* A2, const float* B2,
                                      int ty, int tx, float (&s)[R][R],
                                      float (&dp)[R][R]) {
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < R; ++j) s[i][j] = dp[i][j] = 0.0f;
#pragma unroll 2
  for (int d = 0; d < W; d += 4) {
    float4 a1[R], a2[R];
#pragma unroll
    for (int i = 0; i < R; ++i) {
      a1[i] = *reinterpret_cast<const float4*>(A1 + (ty + 16 * i) * ST + d);
      a2[i] = *reinterpret_cast<const float4*>(A2 + (ty + 16 * i) * ST + d);
    }
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const float4 b1 =
          *reinterpret_cast<const float4*>(B1 + (tx + 16 * j) * ST + d);
      const float4 b2 =
          *reinterpret_cast<const float4*>(B2 + (tx + 16 * j) * ST + d);
#pragma unroll
      for (int i = 0; i < R; ++i) {
        float x = s[i][j], y = dp[i][j];
        x = fmaf(a1[i].x, b1.x, x);
        x = fmaf(a1[i].y, b1.y, x);
        x = fmaf(a1[i].z, b1.z, x);
        x = fmaf(a1[i].w, b1.w, x);
        y = fmaf(a2[i].x, b2.x, y);
        y = fmaf(a2[i].y, b2.y, y);
        y = fmaf(a2[i].z, b2.z, y);
        y = fmaf(a2[i].w, b2.w, y);
        s[i][j] = x;
        dp[i][j] = y;
      }
    }
  }
}

__device__ __forceinline__ void fma4(float4& acc, float a, const float4& b) {
  acc.x = fmaf(a, b.x, acc.x);
  acc.y = fmaf(a, b.y, acc.y);
  acc.z = fmaf(a, b.z, acc.z);
  acc.w = fmaf(a, b.w, acc.w);
}

// rows x NC4 float4 accumulators of one thread, times `mul`, into dst
// (row r0 + ty + 16 i, columns 4 tx + 64 c + e), rows below `valid` only.
template <typename T, int R, int NC4>
__device__ __forceinline__ void store_acc(T* dst, const float4 (&acc)[R][NC4],
                                          int valid, int dh, int ty, int tx,
                                          float mul) {
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int r = ty + 16 * i;
    if (r >= valid) continue;
    T* row = dst + static_cast<long long>(r) * dh;
#pragma unroll
    for (int c = 0; c < NC4; ++c) {
      const int col = 4 * tx + 64 * c;
      const float a[4] = {acc[i][c].x, acc[i][c].y, acc[i][c].z, acc[i][c].w};
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (col + e < dh) store(row + col + e, a[e] * mul);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
delta_kernel(const T* __restrict__ o, const T* __restrict__ dout,
             float* __restrict__ delta, long long rows, int dh) {
  const long long row =
      static_cast<long long>(blockIdx.x) * (THREADS / 32) + threadIdx.x / 32;
  if (row >= rows) return;
  const int lane = threadIdx.x & 31;
  const T* orow = o + row * dh;
  const T* drow = dout + row * dh;
  float acc = 0.0f;
  for (int c = lane; c < dh; c += 32)
    acc = fmaf(to_float(orow[c]), to_float(drow[c]), acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) delta[row] = acc;
}

template <int BR, int NC4>
struct Shape {
  static constexpr int R = BR / 16;        // score rows (columns) a thread
  static constexpr int W = 64 * NC4;       // padded head width
  static constexpr int ST = W + 4;         // tile row stride, 4 mod 32
  static constexpr int PS = BR + 16;        // P / dS row stride
};

template <typename T, int BR, int NC4>
__global__ void __launch_bounds__(THREADS)
dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
            const T* __restrict__ v, const T* __restrict__ dout,
            const float* __restrict__ lse, const float* __restrict__ delta,
            T* __restrict__ dk, T* __restrict__ dv, int hq, int hkv, int sq,
            int sk, int dh, int causal, int window, float scale) {
  using S = Shape<BR, NC4>;
  constexpr int R = S::R, W = S::W, ST = S::ST, PS = S::PS;
  extern __shared__ float4 smem4[];
  float* Ks = reinterpret_cast<float*>(smem4);
  float* Vs = Ks + BR * ST;
  float* Qs = Vs + BR * ST;
  float* dOs = Qs + BR * ST;
  float* Ps = dOs + BR * ST;
  float* dSs = Ps + BR * PS;
  float* Ls = dSs + BR * PS;
  float* Ds = Ls + BR;

  const int k0 = blockIdx.x * BR, hk = blockIdx.y, b = blockIdx.z;
  const int group = hq / hkv;
  const int k_rows = min(BR, sk - k0);
  const long long kv_head = static_cast<long long>(b) * hkv + hk;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  load_rows<T, BR, W, ST>(Ks, k + (kv_head * sk + k0) * dh, k_rows, dh);
  load_rows<T, BR, W, ST>(Vs, v + (kv_head * sk + k0) * dh, k_rows, dh);

  float4 dk_acc[R][NC4], dv_acc[R][NC4];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int c = 0; c < NC4; ++c)
      dk_acc[i][c] = dv_acc[i][c] = make_float4(0.f, 0.f, 0.f, 0.f);

  // The query rows that can see a key of this tile: [q_lo, q_hi).
  const int q_lo = causal ? k0 : 0;
  const int q_hi = window > 0 ? min(sq, k0 + k_rows - 1 + window) : sq;
  for (int g = 0; g < group; ++g) {
    const long long head = static_cast<long long>(b) * hq + hk * group + g;
    for (int q0 = q_lo / BR * BR; q0 < q_hi; q0 += BR) {
      const int q_rows = min(BR, sq - q0);
      __syncthreads();            // the last tile is done with Qs .. Ds
      load_rows<T, BR, W, ST>(Qs, q + (head * sq + q0) * dh, q_rows, dh);
      load_rows<T, BR, W, ST>(dOs, dout + (head * sq + q0) * dh, q_rows, dh);
      for (int r = threadIdx.x; r < BR; r += THREADS) {
        Ls[r] = r < q_rows ? lse[head * sq + q0 + r] : 0.0f;
        Ds[r] = r < q_rows ? delta[head * sq + q0 + r] : 0.0f;
      }
      __syncthreads();

      float s[R][R], dp[R][R];
      dots2<R, W, ST>(Qs, Ks, dOs, Vs, ty, tx, s, dp);
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const int qr = ty + 16 * i;
#pragma unroll
        for (int j = 0; j < R; ++j) {
          const int kc = tx + 16 * j;
          const bool ok = qr < q_rows &&
                          seen(q0 + qr, k0 + kc, sk, causal, window);
          const float p = ok ? expf(s[i][j] * scale - Ls[qr]) : 0.0f;
          Ps[qr * PS + kc] = p;
          dSs[qr * PS + kc] = p * (dp[i][j] - Ds[qr]);
        }
      }
      __syncthreads();

      // dV[k] += P[q][k] dO[q], dK[k] += dS[q][k] Q[q], q in order.
      for (int qq = 0; qq < q_rows; ++qq) {
        float pr[R], dsr[R];
#pragma unroll
        for (int i = 0; i < R; ++i) {
          pr[i] = Ps[qq * PS + ty + 16 * i];
          dsr[i] = dSs[qq * PS + ty + 16 * i];
        }
#pragma unroll
        for (int c = 0; c < NC4; ++c) {
          const float4 dov =
              *reinterpret_cast<const float4*>(dOs + qq * ST + 4 * tx + 64 * c);
          const float4 qv =
              *reinterpret_cast<const float4*>(Qs + qq * ST + 4 * tx + 64 * c);
#pragma unroll
          for (int i = 0; i < R; ++i) {
            fma4(dv_acc[i][c], pr[i], dov);
            fma4(dk_acc[i][c], dsr[i], qv);
          }
        }
      }
    }
  }
  store_acc<T, R, NC4>(dk + (kv_head * sk + k0) * dh, dk_acc, k_rows, dh, ty,
                       tx, scale);
  store_acc<T, R, NC4>(dv + (kv_head * sk + k0) * dh, dv_acc, k_rows, dh, ty,
                       tx, 1.0f);
}

template <typename T, int BR, int NC4>
__global__ void __launch_bounds__(THREADS)
dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, const T* __restrict__ dout,
          const float* __restrict__ lse, const float* __restrict__ delta,
          T* __restrict__ dq, int hq, int hkv, int sq, int sk, int dh,
          int causal, int window, float scale) {
  using S = Shape<BR, NC4>;
  constexpr int R = S::R, W = S::W, ST = S::ST, PS = S::PS;
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* dOs = Qs + BR * ST;
  float* Ks = dOs + BR * ST;
  float* Vs = Ks + BR * ST;
  float* dSs = Vs + BR * ST;
  float* Ls = dSs + BR * PS;
  float* Ds = Ls + BR;

  const int q0 = blockIdx.x * BR, h = blockIdx.y, b = blockIdx.z;
  const int q_rows = min(BR, sq - q0);
  const long long head = static_cast<long long>(b) * hq + h;
  const long long kv_head = static_cast<long long>(b) * hkv + h / (hq / hkv);
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  load_rows<T, BR, W, ST>(Qs, q + (head * sq + q0) * dh, q_rows, dh);
  load_rows<T, BR, W, ST>(dOs, dout + (head * sq + q0) * dh, q_rows, dh);
  for (int r = threadIdx.x; r < BR; r += THREADS) {
    Ls[r] = r < q_rows ? lse[head * sq + q0 + r] : 0.0f;
    Ds[r] = r < q_rows ? delta[head * sq + q0 + r] : 0.0f;
  }

  float4 dq_acc[R][NC4];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int c = 0; c < NC4; ++c) dq_acc[i][c] = make_float4(0.f, 0.f, 0.f, 0.f);

  // The keys any row of this tile can see: [lo, hi).
  const int lo = window > 0 ? max(0, q0 - window + 1) : 0;
  const int hi = causal ? min(sk, q0 + q_rows) : sk;
  for (int k0 = lo / BR * BR; k0 < hi; k0 += BR) {
    const int k_rows = min(BR, sk - k0);
    __syncthreads();              // the last tile is done with Ks, Vs, dSs
    load_rows<T, BR, W, ST>(Ks, k + (kv_head * sk + k0) * dh, k_rows, dh);
    load_rows<T, BR, W, ST>(Vs, v + (kv_head * sk + k0) * dh, k_rows, dh);
    __syncthreads();

    float s[R][R], dp[R][R];
    dots2<R, W, ST>(Qs, Ks, dOs, Vs, ty, tx, s, dp);
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int qr = ty + 16 * i;
#pragma unroll
      for (int j = 0; j < R; ++j) {
        const int kc = tx + 16 * j;
        const bool ok = qr < q_rows &&
                        seen(q0 + qr, k0 + kc, sk, causal, window);
        const float p = ok ? expf(s[i][j] * scale - Ls[qr]) : 0.0f;
        dSs[qr * PS + kc] = p * (dp[i][j] - Ds[qr]);
      }
    }
    __syncthreads();

    // dQ[q] += dS[q][k] K[k], k in order.
    for (int kk = 0; kk < k_rows; ++kk) {
      float dsr[R];
#pragma unroll
      for (int i = 0; i < R; ++i) dsr[i] = dSs[(ty + 16 * i) * PS + kk];
#pragma unroll
      for (int c = 0; c < NC4; ++c) {
        const float4 kv =
            *reinterpret_cast<const float4*>(Ks + kk * ST + 4 * tx + 64 * c);
#pragma unroll
        for (int i = 0; i < R; ++i) fma4(dq_acc[i][c], dsr[i], kv);
      }
    }
  }
  store_acc<T, R, NC4>(dq + (head * sq + q0) * dh, dq_acc, q_rows, dh, ty, tx,
                       scale);
}

template <typename T, int BR, int NC4>
int launch(const void* q, const void* k, const void* v, const void* o,
           const void* lse, const void* dout, void* delta, void* dq, void* dk,
           void* dv, int b, int hq, int hkv, int sq, int sk, int dh,
           int causal, int window, float scale, cudaStream_t stream) {
  using S = Shape<BR, NC4>;
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* dot = static_cast<const T*>(dout);
  const float* l = static_cast<const float*>(lse);
  float* d = static_cast<float*>(delta);

  const long long rows = static_cast<long long>(b) * hq * sq;
  const long long blocks = (rows + THREADS / 32 - 1) / (THREADS / 32);
  if (blocks > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
  delta_kernel<T><<<static_cast<unsigned>(blocks), THREADS, 0, stream>>>(
      static_cast<const T*>(o), dot, d, rows, dh);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  const size_t kv_bytes =
      sizeof(float) * (4 * BR * S::ST + 2 * BR * S::PS + 2 * BR);
  auto kv_kern = dkdv_kernel<T, BR, NC4>;
  err = cudaFuncSetAttribute(kv_kern,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(kv_bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  kv_kern<<<dim3((sk + BR - 1) / BR, hkv, b), THREADS, kv_bytes, stream>>>(
      qt, kt, vt, dot, l, d, static_cast<T*>(dk), static_cast<T*>(dv), hq,
      hkv, sq, sk, dh, causal, window, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  const size_t q_bytes = sizeof(float) * (4 * BR * S::ST + BR * S::PS + 2 * BR);
  auto q_kern = dq_kernel<T, BR, NC4>;
  err = cudaFuncSetAttribute(q_kern,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(q_bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  q_kern<<<dim3((sq + BR - 1) / BR, hq, b), THREADS, q_bytes, stream>>>(
      qt, kt, vt, dot, l, d, static_cast<T*>(dq), hq, hkv, sq, sk, dh, causal,
      window, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_type(const void* q, const void* k, const void* v, const void* o,
                const void* lse, const void* dout, void* delta, void* dq,
                void* dk, void* dv, int b, int hq, int hkv, int sq, int sk,
                int dh, int causal, int window, float scale, cudaStream_t s) {
  switch ((dh + 63) / 64) {
    case 1: return launch<T, 64, 1>(q, k, v, o, lse, dout, delta, dq, dk, dv, b, hq, hkv, sq, sk, dh, causal, window, scale, s);
    case 2: return launch<T, 64, 2>(q, k, v, o, lse, dout, delta, dq, dk, dv, b, hq, hkv, sq, sk, dh, causal, window, scale, s);
    case 3: return launch<T, 32, 3>(q, k, v, o, lse, dout, delta, dq, dk, dv, b, hq, hkv, sq, sk, dh, causal, window, scale, s);
    case 4: return launch<T, 32, 4>(q, k, v, o, lse, dout, delta, dq, dk, dv, b, hq, hkv, sq, sk, dh, causal, window, scale, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// window <= 0 means no window; is_bf16 selects bfloat16 over float32.
// delta is a float32 (b, hq, sq) scratch; dq, dk and dv are written whole.
extern "C" int flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* o,
    const void* lse, const void* dout, void* delta, void* dq, void* dk,
    void* dv, int b, int hq, int hkv, int sq, int sk, int dh, int causal,
    int window, int is_bf16, float scale, void* stream) {
  if (b < 1 || hkv < 1 || hq % hkv != 0 || sq < 1 || sk < 1 || dh < 1 ||
      dh > 256 || hq > 65535 || hkv > 65535 || b > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16
      ? launch_type<__nv_bfloat16>(q, k, v, o, lse, dout, delta, dq, dk, dv,
                                   b, hq, hkv, sq, sk, dh, causal, window,
                                   scale, s)
      : launch_type<float>(q, k, v, o, lse, dout, delta, dq, dk, dv, b, hq,
                           hkv, sq, sk, dh, causal, window, scale, s);
}
