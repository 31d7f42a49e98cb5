// B8: one query token per sequence against a KV cache (decode attention of
// every attention layer).
//
// Replaces the TPU kernel `decode_attention_pallas` / `_decode_kernel`
// (src/repro/kernels/decode_attention.py), reached through
// `ops.decode_attention` from `layers.attention_decode`.
//
// Function.  q is (b, hq, dh), float32 or bfloat16; k and v are the cache in
// its own layout, (b, s, hkv, dh), float32 or bfloat16 (one type for both);
// the output is (b, hq, dh) in q's type.  Query head h reads kv head
// h / (hq / hkv).  Row i sees the keys kpos < len_i and, with a window,
// len_i - 1 - kpos < window, where len_i = lengths[i] (or `length` for every
// row when lengths is null).  The score is dot(q, k) * scale (scale =
// 1/sqrt(dh), computed by the caller), and the output is
// sum_k exp(s_k - m) v_k / max(sum_k exp(s_k - m), 1e-30) rounded to q's
// type, all in float32, as the TPU kernel's online softmax computes it.
// Keys outside [max(0, len - window), len) are not visited: the TPU kernel
// gives them -1e30, whose exp(-1e30 - m) is exactly 0 once a visible key
// has been seen, so skipping them changes nothing.  The kernel differs from
// its plain version (`ref.decode_attention_ref`) only in the order of the
// sums.
//
// Bound on the H100.  decode_32k's layer (128 rows x 8 kv heads x 4,096
// slots x dh 120, bf16) reads 2.01 GB of cache: 0.60 ms at 3.35 TB/s,
// against 8.1e9 operations, 0.12 ms at the fp32 rate.  So it is bound by
// bytes: each cache byte must be read once, by one block.
//
// Design (simple and right first).  One 128-thread block per (batch row,
// kv head, chunk of G of its query heads, key split).  G is the whole GQA
// group where registers allow (up to 8 heads for dh <= 128, 4 above), so
// each K/V row is read once for the group, as the TPU kernel does.  The
// block's four warps are eight half-warp "streams"; a stream takes every
// eighth key of the block's range, UNROLL keys an iteration with all their
// loads issued first, and registers capped at 128 a thread where G * dh
// allows, so four blocks (16 warps) share an SM: latency is hidden by more
// warps in flight rather than by deeper unrolling, which costs registers
// and blocks.  In a stream each lane holds 8 (dh <= 128) or 16
// (dh <= 256) dims of each row: one 16-byte load of bf16 (two of float32)
// per row, so a half-warp reads a 240-byte row of dh 120 in one go, lane 15
// idle (the padding of dh 120 to 128 lives in registers, as zeros).  The
// lane's q values of the G heads sit in registers as float32; each score is
// the lane's partial dot summed over the half-warp by shuffles.  Each
// stream keeps its own running max m, denominator l and accumulator in
// float32 registers (m' = max(m, s), alpha = exp(m - m'), l = l alpha +
// sum p, acc = acc alpha + sum p v); at the end the eight streams merge
// through shared memory in stream order.  When the batch rows and kv heads
// give fewer blocks than about two per SM (long_500k has 8), the wrapper
// asks for `splits` blocks along the key axis: each writes its (m, l, acc)
// to a float32 workspace and a second kernel merges them in split order,
// so the result does not change from run to run.
#include <cuda_bf16.h>

#include "common.cuh"

namespace {

constexpr int THREADS = 128;
constexpr int STREAMS = THREADS / 16;   // half-warps
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);   // round to nearest even, as torch's cast
}

// Eight consecutive elements of a row, as loaded (raw) and as float32.
template <typename T>
struct Vec8;

template <>
struct Vec8<__nv_bfloat16> {
  uint4 r;
  // `valid` of the 8 elements exist (zeros after); `vec` says the row and
  // the chunk are 16-byte aligned.
  __device__ __forceinline__ void load(const __nv_bfloat16* p, int valid,
                                       bool vec) {
    if (vec && valid >= 8) {
      r = *reinterpret_cast<const uint4*>(p);
      return;
    }
    const unsigned short* ps = reinterpret_cast<const unsigned short*>(p);
    unsigned int h[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) h[e] = e < valid ? ps[e] : 0u;
    r = make_uint4(h[0] | (h[1] << 16), h[2] | (h[3] << 16),
                   h[4] | (h[5] << 16), h[6] | (h[7] << 16));
  }
  __device__ __forceinline__ void zero() { r = make_uint4(0u, 0u, 0u, 0u); }
  __device__ __forceinline__ void get(float* f) const {
    const unsigned int w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f[2 * i] = __uint_as_float(w[i] << 16);            // low half first
      f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
};

template <>
struct Vec8<float> {
  float4 a, b;
  __device__ __forceinline__ void load(const float* p, int valid, bool vec) {
    if (vec && valid >= 8) {
      a = *reinterpret_cast<const float4*>(p);
      b = *reinterpret_cast<const float4*>(p + 4);
      return;
    }
    float f[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) f[e] = e < valid ? p[e] : 0.0f;
    a = make_float4(f[0], f[1], f[2], f[3]);
    b = make_float4(f[4], f[5], f[6], f[7]);
  }
  __device__ __forceinline__ void zero() {
    a = make_float4(0.f, 0.f, 0.f, 0.f);
    b = a;
  }
  __device__ __forceinline__ void get(float* f) const {
    f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
    f[4] = b.x; f[5] = b.y; f[6] = b.z; f[7] = b.w;
  }
};

__device__ __forceinline__ float half_warp_sum(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// G: query heads a block takes; NCH: 8-dim chunks a lane holds (dh <=
// 128 NCH); UNROLL: keys a stream loads per iteration.  Where G * NCH <= 4
// the registers are capped at 128, so that four blocks share an SM.
template <typename TQ, typename TKV, int G, int NCH>
__global__ void __launch_bounds__(THREADS, G * NCH <= 4 ? 4 : 1)
decode_attention_kernel(const TQ* __restrict__ q, const TKV* __restrict__ k,
                        const TKV* __restrict__ v,
                        const int* __restrict__ lengths, int length,
                        TQ* __restrict__ out, float* __restrict__ part,
                        int hq, int hkv, int s, int dh, int window,
                        int splits, int vec, float scale) {
  constexpr int UNROLL = NCH == 1 ? 4 : 2;
  constexpr int D = 8 * NCH;          // dims a lane holds
  constexpr int DPAD = 128 * NCH;     // dims a stream holds
  __shared__ float sm_m[STREAMS][G], sm_l[STREAMS][G];
  __shared__ float sm_acc[STREAMS][G][DPAD];

  const int split = blockIdx.x;
  const int chunks = (hq / hkv) / G;
  const int h = blockIdx.y / chunks;
  const int head0 = h * (hq / hkv) + (blockIdx.y % chunks) * G;
  const int bi = blockIdx.z;
  const int st = threadIdx.x >> 4, lane = threadIdx.x & 15;

  // This block's keys: its share of the visible range [lo, hi).
  const int len = lengths != nullptr ? lengths[bi] : length;
  const int lo = window > 0 ? max(0, len - window) : 0;
  const int per = (len - lo + splits - 1) / splits;
  const int k_lo = lo + split * per;
  const int k_hi = min(len, k_lo + per);

  int d0[NCH], valid[NCH];
#pragma unroll
  for (int j = 0; j < NCH; ++j) {
    d0[j] = 8 * (lane + 16 * j);
    valid[j] = dh - d0[j];
  }
  float qf[G][D];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    const TQ* qrow = q + (static_cast<long long>(bi) * hq + head0 + g) * dh;
#pragma unroll
    for (int j = 0; j < NCH; ++j)
#pragma unroll
      for (int e = 0; e < 8; ++e)
        qf[g][8 * j + e] = e < valid[j] ? to_float(qrow[d0[j] + e]) : 0.0f;
  }

  float m[G], l[G], acc[G][D];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    m[g] = NEG_INF;
    l[g] = 0.0f;
#pragma unroll
    for (int i = 0; i < D; ++i) acc[g][i] = 0.0f;
  }

  const long long row_stride = static_cast<long long>(hkv) * dh;
  const TKV* kb = k + (static_cast<long long>(bi) * s * hkv + h) * dh;
  const TKV* vb = v + (static_cast<long long>(bi) * s * hkv + h) * dh;
  const bool vec_ok = vec != 0;
  for (int base = k_lo; base < k_hi; base += STREAMS * UNROLL) {
    Vec8<TKV> kr[UNROLL][NCH], vr[UNROLL][NCH];
    bool ok[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int kpos = base + st + STREAMS * u;
      ok[u] = kpos < k_hi;
#pragma unroll
      for (int j = 0; j < NCH; ++j) {
        if (ok[u]) {
          kr[u][j].load(kb + kpos * row_stride + d0[j], valid[j], vec_ok);
          vr[u][j].load(vb + kpos * row_stride + d0[j], valid[j], vec_ok);
        } else {
          kr[u][j].zero();
          vr[u][j].zero();
        }
      }
    }
    float sc[UNROLL][G];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      float part_dot[G];
#pragma unroll
      for (int g = 0; g < G; ++g) part_dot[g] = 0.0f;
#pragma unroll
      for (int j = 0; j < NCH; ++j) {
        float kf[8];
        kr[u][j].get(kf);
#pragma unroll
        for (int g = 0; g < G; ++g)
#pragma unroll
          for (int e = 0; e < 8; ++e)
            part_dot[g] = fmaf(qf[g][8 * j + e], kf[e], part_dot[g]);
      }
#pragma unroll
      for (int g = 0; g < G; ++g) {
        // Every lane shuffles, whether or not its stream's key exists.
        const float dot = half_warp_sum(part_dot[g]);
        sc[u][g] = ok[u] ? dot * scale : NEG_INF;
      }
    }
    // Online softmax over this iteration's keys; sc becomes p.
#pragma unroll
    for (int g = 0; g < G; ++g) {
      float mx = m[g];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) mx = fmaxf(mx, sc[u][g]);
      const float alpha = expf(m[g] - mx);
      float ps = 0.0f;
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        sc[u][g] = ok[u] ? expf(sc[u][g] - mx) : 0.0f;
        ps += sc[u][g];
      }
      l[g] = l[g] * alpha + ps;
      m[g] = mx;
#pragma unroll
      for (int i = 0; i < D; ++i) acc[g][i] *= alpha;
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
#pragma unroll
      for (int j = 0; j < NCH; ++j) {
        float vf[8];
        vr[u][j].get(vf);
#pragma unroll
        for (int g = 0; g < G; ++g)
#pragma unroll
          for (int e = 0; e < 8; ++e)
            acc[g][8 * j + e] = fmaf(sc[u][g], vf[e], acc[g][8 * j + e]);
      }
    }
  }

  // Merge the eight streams in stream order.
  if (lane == 0) {
#pragma unroll
    for (int g = 0; g < G; ++g) {
      sm_m[st][g] = m[g];
      sm_l[st][g] = l[g];
    }
  }
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int j = 0; j < NCH; ++j)
#pragma unroll
      for (int e = 0; e < 8; ++e)
        sm_acc[st][g][d0[j] + e] = acc[g][8 * j + e];
  __syncthreads();
  for (int idx = threadIdx.x; idx < G * dh; idx += THREADS) {
    const int g = idx / dh, d = idx - g * dh;
    float mm = NEG_INF;
#pragma unroll
    for (int t = 0; t < STREAMS; ++t) mm = fmaxf(mm, sm_m[t][g]);
    float ll = 0.0f, aa = 0.0f;
#pragma unroll
    for (int t = 0; t < STREAMS; ++t) {
      const float w = expf(sm_m[t][g] - mm);
      ll = fmaf(sm_l[t][g], w, ll);
      aa = fmaf(sm_acc[t][g][d], w, aa);
    }
    const long long row = static_cast<long long>(bi) * hq + head0 + g;
    if (splits == 1) {
      store(out + row * dh + d, aa / fmaxf(ll, 1e-30f));
    } else {
      // part: [row][split] of (m, l, acc[dh]).
      float* rec = part + (row * splits + split) * (dh + 2);
      if (d == 0) {
        rec[0] = mm;
        rec[1] = ll;
      }
      rec[2 + d] = aa;
    }
  }
}

// One block per (batch row, query head): the splits' (m, l, acc) merged in
// split order.
template <typename TQ>
__global__ void __launch_bounds__(THREADS)
merge_splits_kernel(const float* __restrict__ part, TQ* __restrict__ out,
                    int dh, int splits) {
  const long long row = blockIdx.x;
  const float* rec = part + row * splits * (dh + 2);
  float mm = NEG_INF;
  for (int j = 0; j < splits; ++j) mm = fmaxf(mm, rec[j * (dh + 2)]);
  for (int d = threadIdx.x; d < dh; d += THREADS) {
    float ll = 0.0f, aa = 0.0f;
    for (int j = 0; j < splits; ++j) {
      const float* r = rec + j * (dh + 2);
      const float w = expf(r[0] - mm);
      ll = fmaf(r[1], w, ll);
      aa = fmaf(r[2 + d], w, aa);
    }
    store(out + row * dh + d, aa / fmaxf(ll, 1e-30f));
  }
}

template <typename TQ, typename TKV, int G, int NCH>
int launch(const void* q, const void* k, const void* v, const int* lengths,
           int length, void* out, float* part, int b, int hq, int hkv, int s,
           int dh, int window, int splits, int vec, float scale,
           cudaStream_t stream) {
  const dim3 grid(splits, hkv * ((hq / hkv) / G), b);
  decode_attention_kernel<TQ, TKV, G, NCH><<<grid, THREADS, 0, stream>>>(
      static_cast<const TQ*>(q), static_cast<const TKV*>(k),
      static_cast<const TKV*>(v), lengths, length, static_cast<TQ*>(out),
      part, hq, hkv, s, dh, window, splits, vec, scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  merge_splits_kernel<TQ><<<b * hq, THREADS, 0, stream>>>(
      part, static_cast<TQ*>(out), dh, splits);
  return static_cast<int>(cudaGetLastError());
}

template <typename TQ, typename TKV>
int launch_types(const void* q, const void* k, const void* v,
                 const int* lengths, int length, void* out, float* part,
                 int b, int hq, int hkv, int s, int dh, int window, int splits,
                 int vec, float scale, cudaStream_t st) {
  const int group = hq / hkv;
  const int gmax = dh <= 128 ? 8 : 4;
  int g = 1;
  while (g * 2 <= gmax && group % (g * 2) == 0) g *= 2;
#define B8_ARGS q, k, v, lengths, length, out, part, b, hq, hkv, s, dh, \
                window, splits, vec, scale, st
  if (dh <= 128) {
    switch (g) {
      case 8: return launch<TQ, TKV, 8, 1>(B8_ARGS);
      case 4: return launch<TQ, TKV, 4, 1>(B8_ARGS);
      case 2: return launch<TQ, TKV, 2, 1>(B8_ARGS);
      default: return launch<TQ, TKV, 1, 1>(B8_ARGS);
    }
  }
  switch (g) {
    case 4: return launch<TQ, TKV, 4, 2>(B8_ARGS);
    case 2: return launch<TQ, TKV, 2, 2>(B8_ARGS);
    default: return launch<TQ, TKV, 1, 2>(B8_ARGS);
  }
#undef B8_ARGS
}

}  // namespace

// lengths: a (b,) int32 device array, or null for `length` on every row.
// window <= 0 means no window.  part: splits > 1 needs b * hq * splits *
// (dh + 2) floats of workspace.  q_bf16 / kv_bf16 select bfloat16 over
// float32 for q (and the output) and for the cache.
extern "C" int decode_attention_launch(const void* q, const void* k,
                                       const void* v, const void* lengths,
                                       int length, void* out, void* part,
                                       int b, int hq, int hkv, int s, int dh,
                                       int window, int splits, int q_bf16,
                                       int kv_bf16, float scale,
                                       void* stream) {
  if (b < 1 || b > 65535 || hkv < 1 || hq % hkv != 0 || s < 1 || dh < 1 ||
      dh > 256 || splits < 1 || (splits > 1 && part == nullptr) ||
      (lengths == nullptr && (length < 1 || length > s)))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t elt = kv_bf16 ? 2 : 4;
  const int vec = (dh * elt) % 16 == 0 &&
                  (reinterpret_cast<uintptr_t>(k) |
                   reinterpret_cast<uintptr_t>(v)) % 16 == 0;
  const int* len = static_cast<const int*>(lengths);
  float* pw = static_cast<float*>(part);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (q_bf16) {
    return kv_bf16
        ? launch_types<__nv_bfloat16, __nv_bfloat16>(
              q, k, v, len, length, out, pw, b, hq, hkv, s, dh, window,
              splits, vec, scale, st)
        : launch_types<__nv_bfloat16, float>(
              q, k, v, len, length, out, pw, b, hq, hkv, s, dh, window,
              splits, vec, scale, st);
  }
  return kv_bf16
      ? launch_types<float, __nv_bfloat16>(q, k, v, len, length, out, pw, b,
                                           hq, hkv, s, dh, window, splits,
                                           vec, scale, st)
      : launch_types<float, float>(q, k, v, len, length, out, pw, b, hq, hkv,
                                   s, dh, window, splits, vec, scale, st);
}
