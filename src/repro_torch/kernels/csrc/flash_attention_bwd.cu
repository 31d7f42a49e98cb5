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
// (b, hq, sq) natural-log log-sum-exp of each query row's scaled scores
// that B7's forward wrote.  Query head h reads kv head h / (hq / hkv).  With
// s = (q . k) scale and the forward's masks (a key is seen when kpos < sk,
// kpos <= qpos if causal, and qpos - kpos < window if windowed),
//   P  = exp(s - lse)        (0 where the key is not seen)
//   D  = rowsum(dout o)      (one float32 a query row)
//   dV = P^T dout,  dP = dout V^T,  dS = P (dP - D),
//   dQ = scale dS K,  dK = scale dS^T Q,
// the FlashAttention-2 equations.  dK and dV sum over the hq / hkv query
// heads of their kv head.  Sums are float32; the gradients are rounded once
// to the input type.  Its plain version is `ref.flash_attention_bwd_ref`.
//
// Bound on the H100.  The gradient needs five products of 2 dh operations
// a seen (query, key) pair: S, dP, dV, dK and dQ.  At the training layer of
// h2o-danube-3-4b (b 2, 32/8 heads, 4,096 tokens, dh 120, causal) that is
// 6.4e11 operations: 0.65 ms on the bf16 tensor cores (989 TFLOP/s), 9.6 ms
// on the CUDA cores (67 TFLOP/s), against 0.06 ms for the bytes.  Bound by
// operations.
//
// bfloat16 body, dh <= 128 (`tc::dkdv_tc_kernel`, `tc::dq_tc_kernel`,
// Hopper's tensor cores).  13 bf16 products a seen pair, 2.6 times the
// bound's 5 (1.69 ms at danube's layer, 1.81 with dh padded to 128):
//  - dK/dV: one block of two warpgroups (256 threads) per (128-key tile, kv
//    head, batch row); warpgroup w owns keys 64 w .. 64 w + 63, the M
//    dimension of every product.  K and V sit in shared memory for the
//    whole block.  The block walks the query heads of its group in order,
//    and for each the 64-row query tiles that the causal band and the
//    window let see a key of the tile, in order; a warpgroup skips the
//    tiles wholly masked for its own keys.  Each tile's Q, dO, lse and D
//    come by `cp.async` into a ring of two stages while the previous tile
//    computes.  S^T = K Q^T and dP^T = V dO^T are `wgmma` m64n64k16 with
//    both operands in shared memory (K-major); P^T and dS^T are computed in
//    registers on the accumulator fragment (the masks only in edge tiles)
//    and go, split in three bf16 parts, straight into `wgmma`'s register A
//    operand for dV += P^T dO and dK += dS^T Q, with dO and Q the
//    shared-memory B operand read MN-major (transposed): 8 products a
//    pair.  P^T's parts feed dV before dP^T is computed, and dS^T takes P^T
//    back from its parts (hi + mid + lo, exact), so that the float32 dK and
//    dV of the warpgroup's keys stay in registers for the whole block
//    without spilling.
//  - dQ: one warpgroup a block per (64-row query tile, query head, batch
//    row), two blocks an SM (faster than one block of two warpgroups at
//    every bf16 shape of phase 3); Q and dO stay in shared memory, the
//    64-key K/V tiles its rows can see come in order through a two-stage
//    `cp.async` ring; S = Q K^T and dP = dO V^T (shared-memory operands),
//    dS in registers, dQ += dS K with K read MN-major: 5 products a pair
//    (S and dP recomputed).
//  - Both grids start their heaviest tiles under the causal band first
//    (the first key tiles, the last query tiles) for every head and batch
//    row, so the longest blocks do not start in the last wave.
//  - Tiles are bf16 in the 128-byte swizzle that `wgmma` descriptors name,
//    dh padded with zeros to a multiple of 64 (the zeros add exact zeros),
//    rows past sq or sk zero-filled; rows not 16-byte aligned (dh % 8 != 0)
//    are staged by ordinary loads instead.  The helpers are wgmma.cuh's,
//    shared with B7's forward.
// Numerics.  S and dP take bf16 operands, whose products are exact in
// float32, so only the order of the sums changes.  P = exp(s scale - lse)
// is one `ex2.approx.ftz` of s scale log2(e) - lse log2(e); P and dS =
// P (dP - D) are float32 in registers.  Each is split into three bf16 parts,
// hi = bf16(x), mid = bf16(x - hi), lo = bf16(x - hi - mid), whose sum is x
// exactly for |x| >= 2^-100 (`ref.split_bf16x3`); with bf16 dO, Q and K the
// three products' float32 sum is P^T dO, dS^T Q and dS K up to the order of
// the sums.  The tensor cores' float32 accumulation does not round each add
// to nearest, and its bias grows with the number of adds into one
// accumulator (over a whole walk of dK at danube's layer, 3,072 steps, it
// broke the limit).  So each tile's product is summed on the tensor cores
// into a zeroed fragment (12 steps of 16 products a 64-column atom) and
// added to the walk's float32 sum by the CUDA cores, rounded to nearest.
// The held limit is one bf16 ulp of each gradient plus 1e-5 of its largest
// magnitude.
// Determinism.  No atomics: each dK/dV row is summed by one warpgroup over
// the query tiles in a fixed order, each dQ row by one over the key tiles
// in order, so the bits are the same from run to run.
//
// float32 body, and bf16 with dh in (128, 256] (gemma-7b's 256): the first
// design on the CUDA cores, chosen by dtype and shape (a dispatch, not a
// fallback: a failed launch raises).  float32 inputs are not exact on the
// tensor cores, and no float32 attention is on the training path at full
// width.  Three kernels, launched in order by one entry point:
//  - `delta_kernel`: D, one warp a query row (the bf16 body's D too).
//  - `dkdv_kernel`: one block of 256 threads per (BR-key tile, kv head,
//    batch row).  K and V of the tile sit in shared memory as float32
//    (zeros past sk and past dh); the block walks the query heads of its
//    group in order, and for each the BR-row query tiles that can see a key
//    of the tile, in order; dK and dV stay in registers the whole time.
//  - `dq_kernel`: one block per (BR-row query tile, query head, batch row),
//    walking the key tiles its rows can see, in order; dQ in registers.
// No float atomics there either.  Tiles: BR = 64 rows for dh <= 128, 32
// above (shared memory); a thread of the 16 x 16 grid owns rows ty + 16 i
// and columns tx + 16 j of a score tile (BR / 16 each) and, for an
// accumulator, rows ty + 16 i and columns 4 tx + 64 c .. + 3 (NC4 = ceil(dh
// / 64) float4 groups).  Row strides of the staged tiles are 4 (mod 32)
// floats, so a quarter-warp's float4 loads of eight rows fall in distinct
// banks.  Seven products of float32 FMAs a pair (the dQ kernel recomputes S
// and dP).  `tools/flash_attention_bwd_first.cu` keeps this design's bf16
// path at every dh as the yardstick the bf16 body was measured against.
#include <cuda_bf16.h>

#include "common.cuh"
#include "wgmma.cuh"

namespace {

constexpr int THREADS = 256;    // a 16 x 16 grid of threads

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

// D = rowsum(dout o), (b, hq, sq) float32, one warp a row.
template <typename T>
cudaError_t launch_delta(const void* o, const void* dout, float* delta, int b,
                         int hq, int sq, int dh, cudaStream_t stream) {
  const long long rows = static_cast<long long>(b) * hq * sq;
  const long long blocks = (rows + THREADS / 32 - 1) / (THREADS / 32);
  if (blocks > 2147483647LL) return cudaErrorInvalidValue;
  delta_kernel<T><<<static_cast<unsigned>(blocks), THREADS, 0, stream>>>(
      static_cast<const T*>(o), static_cast<const T*>(dout), delta, rows, dh);
  return cudaGetLastError();
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

  cudaError_t err = launch_delta<T>(o, dout, d, b, hq, sq, dh, stream);
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


// ---------------------------------------------------------------------------
// The bfloat16 body on the tensor cores (dh <= 128).
namespace tc {

// Warpgroups (64 rows each) a block: the dK/dV block's two share their Q
// and dO tiles; a dQ block of one leaves room for two blocks an SM, which
// measured faster than one block of two.
constexpr int KV_WGS = 2;
constexpr int Q_WGS = 1;
constexpr int KV_THREADS = 128 * KV_WGS;
constexpr int Q_THREADS = 128 * Q_WGS;
constexpr int BKV = 64 * KV_WGS;  // keys a dK/dV block
constexpr int BQ = 64 * Q_WGS;    // query rows a dQ block
constexpr int BT = 64;            // rows of a walked tile (queries or keys)
constexpr int STAGES = 2;         // walked tiles in the ring
constexpr uint32_t T_ATOM = BT * 128;   // bytes of a walked tile's atom

// Dynamic shared bytes of the two kernels: the block's two 128-row tiles,
// the ring, and (dK/dV) each stage's lse and D.
__host__ __device__ constexpr size_t dkdv_bytes(int na) {
  return ATOM + static_cast<size_t>(na) * 128 * (2 * BKV + STAGES * 2 * BT) +
         STAGES * 2 * BT * sizeof(float);
}
__host__ __device__ constexpr size_t dq_bytes(int na) {
  return ATOM + static_cast<size_t>(na) * 128 * (2 * BQ + STAGES * 2 * BT);
}

// This block's (tile, head, batch row) in an order that starts the tiles
// of index 0 first for every (head, batch row), then those of index 1, and
// so on: the grid runs (roughly) in the order of its linear block index, so
// the heaviest tiles under the causal band, index 0, start in the first
// wave instead of in the last.
__device__ __forceinline__ int3 tile_order() {
  const unsigned yz = gridDim.y * gridDim.z;
  const unsigned lin =
      blockIdx.x + gridDim.x * (blockIdx.y + gridDim.y * blockIdx.z);
  const unsigned x = lin / yz, r = lin - x * yz;
  return make_int3(static_cast<int>(x), static_cast<int>(r % gridDim.y),
                   static_cast<int>(r / gridDim.y));
}

// A zeroed accumulator fragment, pinned before the products that follow.
__device__ __forceinline__ void zero_frag(float (&s)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = 0.0f;
  fence_regs(s);
}

// Issues s += A B^T over the padded head width, 64 x 64: A the
// warpgroup's 64 rows of a block tile (column atoms of `a_atom` bytes), B a
// walked 64-row tile; both K-major in shared memory.
template <int NA>
__device__ __forceinline__ void issue_ss(float (&s)[32], uint32_t a,
                                         uint32_t a_atom, uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < 4 * NA; ++kk) {
    const uint32_t col = (kk & 3) * 32;
    wgmma_ss(s, sw128_desc(a + (kk >> 2) * a_atom + col, 16, ATOM),
             sw128_desc(b + (kk >> 2) * T_ATOM + col, 16, ATOM));
  }
}

// s = A B^T (`issue_ss`), waited for.
template <int NA>
__device__ __forceinline__ void one_product(float (&s)[32], uint32_t a,
                                            uint32_t a_atom, uint32_t b) {
  zero_frag(s);
  wgmma_fence();
  issue_ss<NA>(s, a, a_atom, b);
  wgmma_commit();
  wgmma_wait_all();
  fence_regs(s);
}

// s = A B^T and t = C D^T in one group of products, waited for.
template <int NA>
__device__ __forceinline__ void two_products(float (&s)[32], float (&t)[32],
                                             uint32_t a, uint32_t c,
                                             uint32_t a_atom, uint32_t b,
                                             uint32_t d) {
  zero_frag(s);
  zero_frag(t);
  wgmma_fence();
  issue_ss<NA>(s, a, a_atom, b);
  issue_ss<NA>(t, c, a_atom, d);
  wgmma_commit();
  wgmma_wait_all();
  fence_regs(s);
  fence_regs(t);
}

// A 64 x 64 float32 fragment in three bf16 parts, as register A fragments:
// step kk (columns 16 kk .. 16 kk + 15), register x holds accumulator
// entries 8 kk + 2 x, + 1.
__device__ __forceinline__ void split_frag(const float (&x)[32],
                                           uint32_t (&hi)[4][4],
                                           uint32_t (&mid)[4][4],
                                           uint32_t (&lo)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      split_bf16x3(x[8 * kk + 2 * r], x[8 * kk + 2 * r + 1], hi[kk][r],
                   mid[kk][r], lo[kk][r]);
}

// Entry i of the fragment that `split_frag` split, hi + mid + lo: exactly
// the float32 it was split from (each add is exact).
__device__ __forceinline__ float join_frag(const uint32_t (&hi)[4][4],
                                           const uint32_t (&mid)[4][4],
                                           const uint32_t (&lo)[4][4], int i) {
  const int kk = i >> 3, r = (i >> 1) & 3;
  const int sh = (i & 1) ? 0 : 16;
  const float h = __uint_as_float((hi[kk][r] << sh) & 0xFFFF0000u);
  const float m = __uint_as_float((mid[kk][r] << sh) & 0xFFFF0000u);
  const float l = __uint_as_float((lo[kk][r] << sh) & 0xFFFF0000u);
  return (h + m) + l;
}

// acc += (hi + mid + lo) B, the parts 64 x 64 in registers, B the walked
// 64-row tile at b read MN-major (its rows are the product's K dimension).
// One 64-column atom at a time, the tile's product is summed on the tensor
// cores into a zeroed fragment (the smaller parts first), then added to acc
// in float32, rounded to nearest: the tensor cores' accumulation does not
// round to nearest, and a sum carried over a whole walk would gather its
// bias.
template <int NA>
__device__ __forceinline__ void parts_times_tile(float (&acc)[NA][32],
                                                 const uint32_t (&hi)[4][4],
                                                 const uint32_t (&mid)[4][4],
                                                 const uint32_t (&lo)[4][4],
                                                 uint32_t b) {
#pragma unroll
  for (int a = 0; a < NA; ++a) {
    float t[32];
    zero_frag(t);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t db =
          sw128_desc(b + a * T_ATOM + kk * 2 * ATOM, ATOM, ATOM);
      wgmma_rs(t, lo[kk], db);
      wgmma_rs(t, mid[kk], db);
      wgmma_rs(t, hi[kk], db);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(t);
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[a][i] += t[i];
  }
}

// The warpgroup's accumulator rows rbase and rbase + 8 of 64, times `mul`,
// rounded to bf16 into dst (row 0 of the warpgroup), rows below `rows` and
// columns below dh only.
template <int NA>
__device__ __forceinline__ void store_rows(__nv_bfloat16* __restrict__ dst,
                                           const float (&acc)[NA][32],
                                           int rows, int dh, int rbase,
                                           int cbase, float mul) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = rbase + 8 * r;
    if (row >= rows) continue;
    __nv_bfloat16* d = dst + static_cast<long long>(row) * dh;
#pragma unroll
    for (int a = 0; a < NA; ++a)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = 64 * a + 8 * j + cbase;
        const float x0 = acc[a][4 * j + 2 * r] * mul;
        const float x1 = acc[a][4 * j + 2 * r + 1] * mul;
        if (c + 1 < dh && (dh & 1) == 0) {
          *reinterpret_cast<__nv_bfloat162*>(d + c) =
              __floats2bfloat162_rn(x0, x1);
        } else {
          if (c < dh) d[c] = __float2bfloat16(x0);
          if (c + 1 < dh) d[c + 1] = __float2bfloat16(x1);
        }
      }
  }
}

// NA: 64-column atoms of the padded head width (dh <= 64 NA).
template <int NA>
__global__ void __launch_bounds__(KV_THREADS, 2 / KV_WGS)
dkdv_tc_kernel(const __nv_bfloat16* __restrict__ q,
               const __nv_bfloat16* __restrict__ k,
               const __nv_bfloat16* __restrict__ v,
               const __nv_bfloat16* __restrict__ dout,
               const float* __restrict__ lse, const float* __restrict__ delta,
               __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
               int hq, int hkv, int sq, int sk, int dh, int causal,
               int window, float scale, int async) {
  constexpr uint32_t B_ATOM = BKV * 128;       // bytes of a K or V atom
  constexpr uint32_t TILE = NA * T_ATOM;       // one walked Q or dO tile
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t base = smem_addr(smem_raw);
  const uint32_t ks = (base + ATOM - 1) & ~(ATOM - 1);
  const uint32_t vs = ks + NA * B_ATOM;
  const uint32_t ring = vs + NA * B_ATOM;      // stage s: Q, then dO
  // Stage s's lse and D, BT floats each, after the ring.
  float* rows_s = reinterpret_cast<float*>(smem_raw + (ring - base) +
                                           STAGES * 2 * TILE);

  // Key tile 0 sees the most query tiles under the causal band.
  const int3 blk = tile_order();
  const int k0 = blk.x * BKV, hk = blk.y, b = blk.z;
  const int group = hq / hkv;
  const int k_rows = min(BKV, sk - k0);
  const long long kv_head = static_cast<long long>(b) * hkv + hk;
  const int wg = threadIdx.x >> 7;             // warpgroup
  const int warp = (threadIdx.x >> 5) & 3;     // warp in the warpgroup
  const int lane = threadIdx.x & 31;
  const bool cp = async != 0;

  // The query rows that can see a key of the block, [q_lo, q_hi), walked in
  // n_qt tiles a query head; the warpgroup's keys [wk0, wk0 + wk_rows) and
  // the rows that can see one of them, [wq_lo, wq_hi).
  const int q_lo = causal ? k0 : 0;
  const int q_hi = window > 0 ? min(sq, k0 + k_rows - 1 + window) : sq;
  const int q_first = q_lo / BT * BT;
  const int n_qt = q_hi > q_first ? (q_hi - q_first + BT - 1) / BT : 0;
  const int n_tiles = group * n_qt;
  const int wk0 = k0 + 64 * wg;
  const int wk_rows = min(64, sk - wk0);
  const int wq_lo = causal ? wk0 : 0;
  const int wq_hi = window > 0 ? min(sq, wk0 + wk_rows - 1 + window) : sq;
  // This thread's keys wk0 + rbase (+ 8) and query columns 8 j + cbase (+ 1).
  const int rbase = 16 * warp + (lane >> 2);
  const int cbase = 2 * (lane & 3);

  // Walked tile t (query head hk group + t / n_qt) into stage t % STAGES.
  auto stage_tile = [&](int t) {
    const int g = t / n_qt;
    const int q0 = q_first + (t - g * n_qt) * BT;
    const long long row0 =
        (static_cast<long long>(b) * hq + hk * group + g) * sq + q0;
    const int slot = t % STAGES;
    const uint32_t st = ring + slot * 2 * TILE;
    load_tile<KV_THREADS, NA, BT>(st, q + row0 * dh, sq - q0, dh, cp);
    load_tile<KV_THREADS, NA, BT>(st + TILE, dout + row0 * dh, sq - q0, dh,
                                  cp);
    const int r = threadIdx.x & (BT - 1);
    if (threadIdx.x < 2 * BT && q0 + r < sq)
      cp_async4(smem_addr(rows_s + slot * 2 * BT + threadIdx.x),
                (threadIdx.x < BT ? lse : delta) + row0 + r);
  };
  const long long kv_off = (kv_head * sk + k0) * dh;
  load_tile<KV_THREADS, NA, BKV>(ks, k + kv_off, k_rows, dh, cp);
  load_tile<KV_THREADS, NA, BKV>(vs, v + kv_off, k_rows, dh, cp);
#pragma unroll
  for (int t = 0; t < STAGES - 1; ++t) {
    if (t < n_tiles) stage_tile(t);
    cp_async_commit();            // K and V go with tile 0
  }

  float dka[NA][32], dva[NA][32];
#pragma unroll
  for (int a = 0; a < NA; ++a)
#pragma unroll
    for (int i = 0; i < 32; ++i) dka[a][i] = dva[a][i] = 0.0f;
  const float scale2 = scale * LOG2E;

  for (int t = 0; t < n_tiles; ++t) {
    const int g = t / n_qt;
    const int q0 = q_first + (t - g * n_qt) * BT;
    const int slot = t % STAGES;
    cp_async_wait<STAGES - 2>();  // tile t (and K, V) landed
    fence_proxy_async();
    __syncthreads();              // ... for every thread; tile t - 1 done
    if (t + STAGES - 1 < n_tiles) stage_tile(t + STAGES - 1);
    cp_async_commit();
    if (wk_rows <= 0 || q0 >= wq_hi || q0 + BT <= wq_lo) continue;
    const uint32_t qs = ring + slot * 2 * TILE, dos = qs + TILE;
    const float* ls = rows_s + slot * 2 * BT;
    const float* ds = ls + BT;

    // S^T = K Q^T: keys down, query rows across; P^T in place, the masks
    // only where the tile is not wholly seen by the warpgroup's keys (rows
    // past sq are not seen).
    const bool all_seen = q0 + BT <= sq && wk0 + 64 <= sk &&
                          (!causal || wk0 + 63 <= q0) &&
                          (window <= 0 || q0 + BT - 1 - wk0 < window);
    float s[32];
    one_product<NA>(s, ks + wg * (64 * 128), B_ATOM, qs);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = 8 * j + cbase + e;
        const float l2 = ls[c] * LOG2E;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int i = 4 * j + 2 * r + e;
          const float p = exp2_ftz(fmaf(s[i], scale2, -l2));
          s[i] = all_seen || (q0 + c < sq &&
                              seen(q0 + c, wk0 + rbase + 8 * r, sk, causal,
                                   window))
                     ? p : 0.0f;
        }
      }

    // dV += P^T dO through three bf16 parts; then dP^T = V dO^T and
    // dK += dS^T Q, dS^T = P^T (dP^T - D) with P^T joined from its parts
    // (exact), so that P^T's float32 copy need not stay live.
    uint32_t ph[4][4], pm[4][4], pl[4][4];
    split_frag(s, ph, pm, pl);
    parts_times_tile<NA>(dva, ph, pm, pl, dos);
    float dp[32];
    one_product<NA>(dp, vs + wg * (64 * 128), B_ATOM, dos);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = 8 * j + cbase + e;
        const float dd = ds[c];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int i = 4 * j + 2 * r + e;
          const float d = join_frag(ph, pm, pl, i) * (dp[i] - dd);
          // D past sq is not loaded: keep its rows' zeros.
          dp[i] = all_seen || q0 + c < sq ? d : 0.0f;
        }
      }
    split_frag(dp, ph, pm, pl);
    parts_times_tile<NA>(dka, ph, pm, pl, qs);
  }
  cp_async_wait<0>();             // no copy outlives the block
  if (wk_rows <= 0) return;
  const long long w_off = (kv_head * sk + wk0) * dh;
  store_rows<NA>(dk + w_off, dka, wk_rows, dh, rbase, cbase, scale);
  store_rows<NA>(dv + w_off, dva, wk_rows, dh, rbase, cbase, 1.0f);
}

template <int NA>
__global__ void __launch_bounds__(Q_THREADS, 2 / Q_WGS)
dq_tc_kernel(const __nv_bfloat16* __restrict__ q,
             const __nv_bfloat16* __restrict__ k,
             const __nv_bfloat16* __restrict__ v,
             const __nv_bfloat16* __restrict__ dout,
             const float* __restrict__ lse, const float* __restrict__ delta,
             __nv_bfloat16* __restrict__ dq, int hq, int hkv, int sq, int sk,
             int dh, int causal, int window, float scale, int async) {
  constexpr uint32_t B_ATOM = BQ * 128;        // bytes of a Q or dO atom
  constexpr uint32_t TILE = NA * T_ATOM;       // one walked K or V tile
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t qs = (smem_addr(smem_raw) + ATOM - 1) & ~(ATOM - 1);
  const uint32_t dos = qs + NA * B_ATOM;
  const uint32_t ring = dos + NA * B_ATOM;     // stage s: K, then V

  // The last query tiles see the most keys under the causal band: they
  // start first.
  const int3 blk = tile_order();
  const int q0 = (gridDim.x - 1 - blk.x) * BQ, h = blk.y, b = blk.z;
  const int q_rows = min(BQ, sq - q0);
  const long long head = static_cast<long long>(b) * hq + h;
  const long long kv_head = static_cast<long long>(b) * hkv + h / (hq / hkv);
  const __nv_bfloat16* kg = k + kv_head * sk * dh;
  const __nv_bfloat16* vg = v + kv_head * sk * dh;
  const int wg = threadIdx.x >> 7;
  const int warp = (threadIdx.x >> 5) & 3;
  const int lane = threadIdx.x & 31;
  const bool cp = async != 0;

  // The keys any row of the block can see, [lo, hi); the warpgroup's own
  // rows [wq0, wq0 + w_rows) and keys [wlo, whi).
  const int lo = window > 0 ? max(0, q0 - window + 1) : 0;
  const int hi = causal ? min(sk, q0 + q_rows) : sk;
  const int k_first = lo / BT * BT;
  const int n_tiles = hi > k_first ? (hi - k_first + BT - 1) / BT : 0;
  const int wq0 = q0 + 64 * wg;
  const int w_rows = min(64, sq - wq0);
  const int wlo = window > 0 ? max(0, wq0 - window + 1) : 0;
  const int whi = causal ? min(sk, wq0 + max(w_rows, 0)) : sk;
  // This thread's rows wq0 + rbase (+ 8) and keys 8 j + cbase (+ 1).
  const int rbase = 16 * warp + (lane >> 2);
  const int cbase = 2 * (lane & 3);

  auto stage_tile = [&](int t) {
    const uint32_t st = ring + (t % STAGES) * 2 * TILE;
    const int k0 = k_first + t * BT;
    const long long off = static_cast<long long>(k0) * dh;
    load_tile<Q_THREADS, NA, BT>(st, kg + off, sk - k0, dh, cp);
    load_tile<Q_THREADS, NA, BT>(st + TILE, vg + off, sk - k0, dh, cp);
  };
  const long long q_off = (head * sq + q0) * dh;
  load_tile<Q_THREADS, NA, BQ>(qs, q + q_off, q_rows, dh, cp);
  load_tile<Q_THREADS, NA, BQ>(dos, dout + q_off, q_rows, dh, cp);
#pragma unroll
  for (int t = 0; t < STAGES - 1; ++t) {
    if (t < n_tiles) stage_tile(t);
    cp_async_commit();            // Q and dO go with tile 0
  }

  float l2[2], dd[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = rbase + 8 * r;
    const bool in = row < w_rows;
    l2[r] = in ? lse[head * sq + wq0 + row] * LOG2E : 0.0f;
    dd[r] = in ? delta[head * sq + wq0 + row] : 0.0f;
  }
  float dqa[NA][32];
#pragma unroll
  for (int a = 0; a < NA; ++a)
#pragma unroll
    for (int i = 0; i < 32; ++i) dqa[a][i] = 0.0f;
  const float scale2 = scale * LOG2E;

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = k_first + t * BT;
    cp_async_wait<STAGES - 2>();  // tile t (and Q, dO) landed
    fence_proxy_async();
    __syncthreads();              // ... for every thread; tile t - 1 done
    if (t + STAGES - 1 < n_tiles) stage_tile(t + STAGES - 1);
    cp_async_commit();
    if (w_rows <= 0 || k0 >= whi || k0 + BT <= wlo) continue;
    const uint32_t ks = ring + (t % STAGES) * 2 * TILE, vs = ks + TILE;

    // S = Q K^T and dP = dO V^T: query rows down, keys across.
    float s[32], dp[32];
    two_products<NA>(s, dp, qs + wg * (64 * 128), dos + wg * (64 * 128),
                     B_ATOM, ks, vs);

    // dS in place of dP; the masks only where the tile is not wholly seen
    // by the warpgroup's rows.
    const bool all_seen = k0 + BT <= sk && (!causal || k0 + BT - 1 <= wq0) &&
                          (window <= 0 || wq0 + 63 - k0 < window);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int i = 4 * j + 2 * r + e;
          const float p = exp2_ftz(fmaf(s[i], scale2, -l2[r]));
          float d = p * (dp[i] - dd[r]);
          if (!all_seen) {
            const int qpos = wq0 + rbase + 8 * r;
            const int kpos = k0 + 8 * j + cbase + e;
            d = seen(qpos, kpos, sk, causal, window) ? d : 0.0f;
          }
          dp[i] = d;
        }

    // dQ += dS K through three bf16 parts, K read MN-major.
    uint32_t ph[4][4], pm[4][4], pl[4][4];
    split_frag(dp, ph, pm, pl);
    parts_times_tile<NA>(dqa, ph, pm, pl, ks);
  }
  cp_async_wait<0>();
  if (w_rows <= 0) return;
  store_rows<NA>(dq + (head * sq + wq0) * dh, dqa, w_rows, dh, rbase, cbase,
                 scale);
}

template <int NA>
int launch(const void* q, const void* k, const void* v, const void* o,
           const void* lse, const void* dout, void* delta, void* dq, void* dk,
           void* dv, int b, int hq, int hkv, int sq, int sk, int dh,
           int causal, int window, float scale, cudaStream_t stream) {
  using bf = __nv_bfloat16;
  const bf* qt = static_cast<const bf*>(q);
  const bf* kt = static_cast<const bf*>(k);
  const bf* vt = static_cast<const bf*>(v);
  const bf* dot = static_cast<const bf*>(dout);
  const float* l = static_cast<const float*>(lse);
  float* d = static_cast<float*>(delta);
  cudaError_t err = launch_delta<bf>(o, dout, d, b, hq, sq, dh, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int async =
      dh % 8 == 0 &&
      (reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
       reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(dout)) %
              16 == 0;

  auto kv_kern = dkdv_tc_kernel<NA>;
  err = cudaFuncSetAttribute(kv_kern,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(dkdv_bytes(NA)));
  if (err != cudaSuccess) return static_cast<int>(err);
  kv_kern<<<dim3((sk + BKV - 1) / BKV, hkv, b), KV_THREADS, dkdv_bytes(NA),
            stream>>>(qt, kt, vt, dot, l, d, static_cast<bf*>(dk),
                      static_cast<bf*>(dv), hq, hkv, sq, sk, dh, causal,
                      window, scale, async);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  auto q_kern = dq_tc_kernel<NA>;
  err = cudaFuncSetAttribute(q_kern,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(dq_bytes(NA)));
  if (err != cudaSuccess) return static_cast<int>(err);
  q_kern<<<dim3((sq + BQ - 1) / BQ, hq, b), Q_THREADS, dq_bytes(NA),
           stream>>>(qt, kt, vt, dot, l, d, static_cast<bf*>(dq), hq, hkv, sq,
                     sk, dh, causal, window, scale, async);
  return static_cast<int>(cudaGetLastError());
}

// What a build gives one launch of a kernel: registers a thread, shared
// bytes a block (static + dynamic), blocks resident an SM.
template <typename K>
cudaError_t kernel_info(K kernel, int threads, size_t dyn_bytes, int* info) {
  cudaFuncAttributes a;
  cudaError_t e = cudaFuncGetAttributes(&a, kernel);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(dyn_bytes));
  int blocks = 0;
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel,
                                                      threads, dyn_bytes);
  if (e != cudaSuccess) return e;
  info[0] = a.numRegs;
  info[1] = static_cast<int>(a.sharedSizeBytes + dyn_bytes);
  info[2] = blocks;
  return cudaSuccess;
}

template <int NA>
int info(int* out) {
  cudaError_t e =
      kernel_info(dkdv_tc_kernel<NA>, KV_THREADS, dkdv_bytes(NA), out);
  if (e == cudaSuccess)
    e = kernel_info(dq_tc_kernel<NA>, Q_THREADS, dq_bytes(NA), out + 3);
  return static_cast<int>(e);
}

}  // namespace tc

// bf16: the tensor cores up to dh 128, the CUDA cores above.
int launch_bf16(const void* q, const void* k, const void* v, const void* o,
                const void* lse, const void* dout, void* delta, void* dq,
                void* dk, void* dv, int b, int hq, int hkv, int sq, int sk,
                int dh, int causal, int window, float scale, cudaStream_t s) {
  using bf = __nv_bfloat16;
  switch ((dh + 63) / 64) {
    case 1: return tc::launch<1>(q, k, v, o, lse, dout, delta, dq, dk, dv, b, hq, hkv, sq, sk, dh, causal, window, scale, s);
    case 2: return tc::launch<2>(q, k, v, o, lse, dout, delta, dq, dk, dv, b, hq, hkv, sq, sk, dh, causal, window, scale, s);
    case 3: return launch<bf, 32, 3>(q, k, v, o, lse, dout, delta, dq, dk, dv, b, hq, hkv, sq, sk, dh, causal, window, scale, s);
    case 4: return launch<bf, 32, 4>(q, k, v, o, lse, dout, delta, dq, dk, dv, b, hq, hkv, sq, sk, dh, causal, window, scale, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// window <= 0 means no window; is_bf16 selects bfloat16 over float32 (the
// tensor cores for dh <= 128).  delta is a float32 (b, hq, sq) scratch; dq,
// dk and dv are written whole.
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
      ? launch_bf16(q, k, v, o, lse, dout, delta, dq, dk, dv, b, hq, hkv, sq,
                    sk, dh, causal, window, scale, s)
      : launch_type<float>(q, k, v, o, lse, dout, delta, dq, dk, dv, b, hq,
                           hkv, sq, sk, dh, causal, window, scale, s);
}

// The bf16 body's two kernels at head width dh (<= 128): info[0..2] the
// dK/dV kernel's registers a thread, shared bytes a block and blocks an SM,
// info[3..5] the dQ kernel's.
extern "C" int flash_attention_bwd_info(int dh, int* info) {
  switch ((dh + 63) / 64) {
    case 1: return tc::info<1>(info);
    case 2: return tc::info<2>(info);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
