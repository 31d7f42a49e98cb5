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
// dh 120, causal, window 4,096) has 1.26e8 unmasked (query, key) pairs a
// head.  The bf16 body below does QK^T (2 dh operations a pair) and P V as
// three bf16 products (6 dh), 3.87e12 operations in all on the tensor cores:
// 3.9 ms at 989 TFLOP/s, against 0.19 ms for its 629 MB of bytes.  So it is
// bound by operations.
//
// bfloat16 body (`tc::flash_attention_tc_kernel`, Hopper's tensor cores).
// One block of two warpgroups (256 threads) per (128-row query tile, query
// head, batch row); warpgroup w owns query rows 64 w .. 64 w + 63.  The
// block walks only the 64-key tiles that the causal band and the window
// reach (the "causal grid-skip"), and a warpgroup skips the tiles that are
// wholly masked for its own rows: a tile wholly masked for a row adds
// exp(-1e30 - m) = 0 to it, and one before the row's first key is wiped by
// alpha = exp(-1e30 - m) = 0, so skipping them is exact.
//  - Shared memory holds the query tile and a ring of two K/V tiles, each
//    in bf16 with dh padded with zeros to a multiple of 64 and laid out in
//    the 128-byte swizzle that `wgmma` descriptors name: atoms of 8 rows x
//    64 columns (1,024 bytes), 16-byte chunk c of row r at chunk c ^ (r % 8).
//    The next tile's K and V are copied by `cp.async` (16 bytes a copy,
//    zero-filled past sk and past dh) while the current one is computed.
//    A thread copies one 16-byte column of every row it owns, so its
//    shared offsets and swizzle are fixed and the copy loop unrolls (the
//    loop with index math a copy took more issue slots than the tile's
//    products, `tools/flash_tile_sweep.py`).
//    Rows that are not 16-byte aligned (dh not a multiple of 8) are staged
//    by ordinary loads and stores instead, into the same layout.
//  - S = Q K^T: `wgmma` m64n64k16 with both operands from shared memory
//    (K-major), float32 accumulators in registers.  Products of bf16 inputs
//    are exact, and the zero padding adds exact zeros, so only the order of
//    the sums changes.
//  - Masks and the online softmax act on the accumulator fragment in
//    registers: thread t of warp w holds rows 16 w + t / 4 (+ 8) and
//    columns 8 j + 2 (t % 4) (+ 1); a row's max and sum take the four lanes
//    that share it.  exp(x) is computed as 2^(x log2 e), with log2 e folded
//    into the scale, by one `ex2.approx.ftz` (a p below 2^-126 becomes 0,
//    an absolute error under 1.2e-38).
//  - P V keeps the probabilities float32: each p is split into three bf16
//    parts, hi = bf16(p), mid = bf16(p - hi), lo = bf16(p - hi - mid), whose
//    sum is p exactly (each subtraction is exact; `ref.split_bf16x3`).  V is
//    exact in bf16, so hi V + mid V + lo V accumulated in float32 is P V up
//    to the order of the sums.  The parts go straight from the score
//    fragment into `wgmma`'s register A operand (m64n64k16, the same
//    layout); V's tile is the shared-memory B operand, read transposed
//    (MN-major).
// The tensor cores' float32 accumulation does not round each add as fmaf
// does; the held limit (one bf16 ulp of each output plus 1e-5) covers it.
// The `wgmma`, descriptor, copy, ex2 and split helpers are in wgmma.cuh,
// shared with the backward's bf16 body.
//
// float32 body (`flash_attention_kernel`, the CUDA cores).  float32 inputs
// are not exact on the tensor cores and no float32 attention is on the
// prefill's path (it serves float32 copies of a model and the tests), so it
// keeps the first design: one block of 128 threads per (64-row query tile,
// query head, batch row), the same grid-skip, K and V staged in shared
// memory as float32 (zeros past sk and past dh), the 64 x 64 scores with
// fp32 FMAs (a thread owns 4 rows x 8 interleaved keys), masks and the
// online softmax in registers (row max and sum over the 8 lanes that share
// a row), the probabilities written transposed to shared memory, and P V
// added into 4 rows x (4 x NC4) columns a thread.  Shared-memory strides
// are chosen so that each quarter-warp's 16-byte loads hit distinct banks.
#include <cuda_bf16.h>

#include "common.cuh"
#include "wgmma.cuh"

namespace {

constexpr int BQ = 64;          // query rows per block
constexpr int BK = 64;          // keys per tile
constexpr int THREADS = 128;    // 16 row groups (4 rows) x 8 key groups
constexpr int PST = BQ + 4;     // stride of the transposed probabilities
constexpr float NEG_INF = -1e30f;
static_assert(BQ == BK, "load_tile stages BK rows for the query tile too");

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }

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
                       const T* __restrict__ v, T* __restrict__ out,
                       float* __restrict__ lse, int hq, int hkv, int sq,
                       int sk, int dh, int causal, int window, float scale) {
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
    if (lse != nullptr && cg == 0) lse[head * sq + q0 + r] = m[i] + logf(l[i]);
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
int launch(const void* q, const void* k, const void* v, void* out, float* lse,
           int b, int hq, int hkv, int sq, int sk, int dh, int causal,
           int window, float scale, cudaStream_t stream) {
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
      static_cast<const T*>(v), static_cast<T*>(out), lse, hq, hkv, sq, sk,
      dh, causal, window, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_type(const void* q, const void* k, const void* v, void* out,
                float* lse, int b, int hq, int hkv, int sq, int sk, int dh,
                int causal, int window, float scale, cudaStream_t s) {
  switch ((dh + 31) / 32) {
    case 1: return launch<T, 1>(q, k, v, out, lse, b, hq, hkv, sq, sk, dh, causal, window, scale, s);
    case 2: return launch<T, 2>(q, k, v, out, lse, b, hq, hkv, sq, sk, dh, causal, window, scale, s);
    case 3: return launch<T, 3>(q, k, v, out, lse, b, hq, hkv, sq, sk, dh, causal, window, scale, s);
    case 4: return launch<T, 4>(q, k, v, out, lse, b, hq, hkv, sq, sk, dh, causal, window, scale, s);
    case 5: return launch<T, 5>(q, k, v, out, lse, b, hq, hkv, sq, sk, dh, causal, window, scale, s);
    case 6: return launch<T, 6>(q, k, v, out, lse, b, hq, hkv, sq, sk, dh, causal, window, scale, s);
    case 7: return launch<T, 7>(q, k, v, out, lse, b, hq, hkv, sq, sk, dh, causal, window, scale, s);
    case 8: return launch<T, 8>(q, k, v, out, lse, b, hq, hkv, sq, sk, dh, causal, window, scale, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// ---------------------------------------------------------------------------
// The bfloat16 body on the tensor cores.
namespace tc {

constexpr int BQ = 128;        // query rows a block: two warpgroups of 64
constexpr int BK = 64;         // keys a tile
constexpr int THREADS = 256;
constexpr int STAGES = 2;      // K/V tiles in the ring
constexpr float LN2 = 0.6931471805599453f;

// NA: 64-column atoms of the padded head width (dh <= 64 NA).
template <int NA>
__global__ void __launch_bounds__(THREADS, 1)
flash_attention_tc_kernel(const __nv_bfloat16* __restrict__ q,
                          const __nv_bfloat16* __restrict__ k,
                          const __nv_bfloat16* __restrict__ v,
                          __nv_bfloat16* __restrict__ out,
                          float* __restrict__ lse, int hq, int hkv, int sq,
                          int sk, int dh, int causal, int window, float scale,
                          int async) {
  constexpr uint32_t Q_ATOM = BQ * 128;        // bytes of one Q column atom
  constexpr uint32_t T_ATOM = BK * 128;        // ... of one K or V atom
  constexpr uint32_t TILE = NA * T_ATOM;       // one K or V tile
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t qs = (smem_addr(smem_raw) + ATOM - 1) & ~(ATOM - 1);
  const uint32_t ring = qs + NA * Q_ATOM;      // stage s: K, then V

  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int q_rows = min(BQ, sq - q0);
  const long long head = static_cast<long long>(b) * hq + h;
  const long long kv_head = static_cast<long long>(b) * hkv + h / (hq / hkv);
  const __nv_bfloat16* kg = k + kv_head * sk * dh;
  const __nv_bfloat16* vg = v + kv_head * sk * dh;
  const int wg = threadIdx.x >> 7;             // warpgroup
  const int warp = (threadIdx.x >> 5) & 3;     // warp in the warpgroup
  const int lane = threadIdx.x & 31;
  const bool cp = async != 0;

  // The keys any row of the block can see, [lo, hi); the warpgroup's own
  // rows [wq0, wq0 + w_rows) and keys [wlo, whi).
  const int lo = window > 0 ? max(0, q0 - window + 1) : 0;
  const int hi = causal ? min(sk, q0 + q_rows) : sk;
  const int k_first = lo / BK * BK;
  const int n_tiles = (hi - k_first + BK - 1) / BK;
  const int wq0 = q0 + 64 * wg;
  const int w_rows = min(64, sq - wq0);
  const int wlo = window > 0 ? max(0, wq0 - window + 1) : 0;
  const int whi = causal ? min(sk, wq0 + max(w_rows, 0)) : sk;
  // This thread's two rows: wq0 + rbase and wq0 + rbase + 8.
  const int rbase = 16 * warp + (lane >> 2);
  const int cbase = 2 * (lane & 3);

  // Tile t's K and V into ring stage t % STAGES.
  auto stage_tile = [&](int t) {
    const uint32_t st = ring + (t % STAGES) * 2 * TILE;
    const int k0 = k_first + t * BK;
    const long long off = static_cast<long long>(k0) * dh;
    load_tile<THREADS, NA, BK>(st, kg + off, sk - k0, dh, cp);
    load_tile<THREADS, NA, BK>(st + TILE, vg + off, sk - k0, dh, cp);
  };
  load_tile<THREADS, NA, BQ>(qs, q + (head * sq + q0) * dh, q_rows, dh, cp);
#pragma unroll
  for (int t = 0; t < STAGES - 1; ++t) {
    if (t < n_tiles) stage_tile(t);
    cp_async_commit();            // the query tile goes with tile 0
  }

  float o[NA][32];
#pragma unroll
  for (int a = 0; a < NA; ++a)
#pragma unroll
    for (int i = 0; i < 32; ++i) o[a][i] = 0.0f;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.0f, 0.0f};
  const float scale2 = scale * LOG2E;

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = k_first + t * BK;
    cp_async_wait<STAGES - 2>();  // tile t (and the query tile) landed
    fence_proxy_async();
    __syncthreads();              // ... for every thread; tile t - 1 done
    if (t + STAGES - 1 < n_tiles) stage_tile(t + STAGES - 1);
    cp_async_commit();
    if (w_rows <= 0 || k0 >= whi || k0 + BK <= wlo) continue;
    const uint32_t ks = ring + (t % STAGES) * 2 * TILE, vs = ks + TILE;

    // S = Q K^T over the padded head width, 16 columns a step.
    float s[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = 0.0f;
    fence_regs(s);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4 * NA; ++kk) {
      const uint32_t col = (kk & 3) * 32;
      wgmma_ss(s,
               sw128_desc(qs + (kk >> 2) * Q_ATOM + wg * (64 * 128) + col, 16,
                          ATOM),
               sw128_desc(ks + (kk >> 2) * T_ATOM + col, 16, ATOM));
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(s);

    // Masks (skipped where the tile is wholly visible to the warpgroup's
    // rows) and the online softmax, in the exp2 domain.
    const bool all_seen = k0 + BK <= sk && (!causal || k0 + BK - 1 <= wq0) &&
                          (window <= 0 || wq0 + 63 - k0 < window);
    float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int i = 4 * j + 2 * r + e;
          float x = s[i] * scale2;
          if (!all_seen) {
            const int qpos = wq0 + rbase + 8 * r;
            const int kpos = k0 + 8 * j + cbase + e;
            const bool ok = kpos < sk && (!causal || kpos <= qpos) &&
                            (window <= 0 || qpos - kpos < window);
            x = ok ? x : NEG_INF;
          }
          s[i] = x;
          mx[r] = fmaxf(mx[r], x);
        }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      alpha[r] = exp2_ftz(m[r] - m_new);
      m[r] = m_new;
    }
    float ps[2] = {0.0f, 0.0f};
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int i = 4 * j + 2 * r + e;
          s[i] = exp2_ftz(s[i] - m[r]);
          ps[r] += s[i];
        }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + ps[r];
#pragma unroll
    for (int a = 0; a < NA; ++a)
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          o[a][4 * j + 2 * r] *= alpha[r];
          o[a][4 * j + 2 * r + 1] *= alpha[r];
        }

    // P in three bf16 parts, as register A fragments: step kk (keys 16 kk
    // .. 16 kk + 15), register x holds accumulator entries 8 kk + 2 x, + 1.
    uint32_t ph[4][4], pm[4][4], pl[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int x = 0; x < 4; ++x)
        split_bf16x3(s[8 * kk + 2 * x], s[8 * kk + 2 * x + 1], ph[kk][x],
                     pm[kk][x], pl[kk][x]);

    // O += P V, the smaller parts first.
#pragma unroll
    for (int a = 0; a < NA; ++a) fence_regs(o[a]);
    wgmma_fence();
#pragma unroll
    for (int a = 0; a < NA; ++a)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint64_t dv =
            sw128_desc(vs + a * T_ATOM + kk * 2 * ATOM, ATOM, ATOM);
        wgmma_rs(o[a], pl[kk], dv);
        wgmma_rs(o[a], pm[kk], dv);
        wgmma_rs(o[a], ph[kk], dv);
      }
    wgmma_commit();
    wgmma_wait_all();
#pragma unroll
    for (int a = 0; a < NA; ++a) fence_regs(o[a]);
  }

  if (w_rows <= 0) return;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = rbase + 8 * r;
    if (row >= w_rows) continue;
    const float denom = fmaxf(l[r], 1e-30f);
    // m is in the exp2 domain: ln(sum e^s) = m ln 2 + ln l.
    if (lse != nullptr && (lane & 3) == 0)
      lse[head * sq + wq0 + row] = m[r] * LN2 + logf(l[r]);
    __nv_bfloat16* orow = out + (head * sq + wq0 + row) * dh;
#pragma unroll
    for (int a = 0; a < NA; ++a)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = 64 * a + 8 * j + cbase;
        const float x0 = o[a][4 * j + 2 * r] / denom;
        const float x1 = o[a][4 * j + 2 * r + 1] / denom;
        if (c + 1 < dh && (dh & 1) == 0) {
          *reinterpret_cast<__nv_bfloat162*>(orow + c) =
              __floats2bfloat162_rn(x0, x1);
        } else {
          if (c < dh) orow[c] = __float2bfloat16(x0);
          if (c + 1 < dh) orow[c + 1] = __float2bfloat16(x1);
        }
      }
  }
}

template <int NA>
int launch(const void* q, const void* k, const void* v, void* out, float* lse,
           int b, int hq, int hkv, int sq, int sk, int dh, int causal,
           int window, float scale, cudaStream_t stream) {
  const size_t bytes = ATOM + static_cast<size_t>(NA) * 128 *
                                  (BQ + 2 * STAGES * BK);
  auto kern = flash_attention_tc_kernel<NA>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int async =
      dh % 8 == 0 &&
      (reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
       reinterpret_cast<uintptr_t>(v)) % 16 == 0;
  const dim3 grid((sq + BQ - 1) / BQ, hq, b);
  kern<<<grid, THREADS, bytes, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out),
      lse, hq, hkv, sq, sk, dh, causal, window, scale, async);
  return static_cast<int>(cudaGetLastError());
}

int launch_bf16(const void* q, const void* k, const void* v, void* out,
                float* lse, int b, int hq, int hkv, int sq, int sk, int dh,
                int causal, int window, float scale, cudaStream_t s) {
  switch ((dh + 63) / 64) {
    case 1: return launch<1>(q, k, v, out, lse, b, hq, hkv, sq, sk, dh, causal, window, scale, s);
    case 2: return launch<2>(q, k, v, out, lse, b, hq, hkv, sq, sk, dh, causal, window, scale, s);
    case 3: return launch<3>(q, k, v, out, lse, b, hq, hkv, sq, sk, dh, causal, window, scale, s);
    case 4: return launch<4>(q, k, v, out, lse, b, hq, hkv, sq, sk, dh, causal, window, scale, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace tc

}  // namespace

// window <= 0 means no window; is_bf16 selects bfloat16 over float32.  lse,
// when not null, receives each query row's float32 log-sum-exp of its
// scaled scores, ln sum_k exp(s_k), (b, hq, sq): what the backward
// (flash_attention_bwd.cu) recomputes the probabilities from.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* out, void* lse,
                                      int b, int hq, int hkv, int sq, int sk,
                                      int dh, int causal, int window,
                                      int is_bf16, float scale, void* stream) {
  if (b < 1 || hkv < 1 || hq % hkv != 0 || sq < 1 || sk < 1 || dh < 1 ||
      dh > 256 || hq > 65535 || b > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  return is_bf16 ? tc::launch_bf16(q, k, v, out, l, b, hq, hkv, sq, sk, dh,
                                   causal, window, scale, s)
                 : launch_type<float>(q, k, v, out, l, b, hq, hkv, sq, sk,
                                      dh, causal, window, scale, s);
}
