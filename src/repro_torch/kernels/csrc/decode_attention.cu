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
// Design.  One 128-thread block per (batch row, kv head, chunk of G of its
// query heads, key split).  G is the whole GQA group where registers allow
// (up to 8 heads for dh <= 128, 4 above), so each K/V row is read once for
// the group, as the TPU kernel does.
//  - The block's keys stream through a ring of STAGES tiles in shared
//    memory, TK keys of K and of V a tile.  At the top of each tile the
//    block issues the copy of the tile STAGES - 1 ahead by `cp.async` (16
//    bytes a copy, zero-filled past the block's keys; rows of dh 120 in bf16
//    are 240 bytes, 16-byte aligned at the cache's 1,920-byte key stride),
//    so two tiles are in flight while the scores and the softmax of the
//    current one run.  Rows that are not 16-byte aligned (dh 36 in bf16,
//    say) are staged by ordinary loads and stores into the same ring.
//  - The four warps are eight half-warp "streams"; a stream takes every
//    eighth key of a tile.  In a stream each lane holds 8 (dh <= 128) or 16
//    (dh <= 256) dims of each row: one 16-byte shared load of bf16 (two of
//    float32) a row, lane 15 idle at dh 120 (the padding to 128 lives in
//    registers, as zeros).  The lane's q values of the G heads sit in
//    registers as float32, times scale x log2(e), so scores come in log2
//    units and exp(x) is taken as exp2.  A key's G dots come from the
//    lanes' partials in G - 1 + log2(16 / G) shuffles (5 for G = 4, where
//    summing each head apart takes 16), each lane ending with one head's.
//    That lane keeps the head's running max m and denominator l in float32
//    (m' = max(m, s), alpha = 2^(m - m'), l = l alpha + sum p), so the
//    softmax runs once a head and not once a lane; every lane takes the
//    heads' p by shuffle into its float32 accumulators (acc = acc alpha +
//    sum p v; the rescale is skipped when no max of the warp moved).  At
//    the end the eight streams merge through shared memory (the ring's
//    space) in stream order.  Registers are capped at 128 a thread where
//    G * dh allows, and the ring of decode_32k's layer takes 45 KB, so four
//    blocks share an SM.
//  - When the batch rows and kv heads give less than one wave of blocks
//    (four an SM; long_500k has 8), the wrapper cuts each row's keys into
//    `splits` blocks (long_500k: 32 of 128 keys).  Each writes its (m, l,
//    acc) to a float32 workspace and a second kernel merges them in split
//    order, so the result does not change from run to run.  decode_32k's
//    1,024 (row, kv head) blocks fill 528 slots in 1.94 waves; cutting them
//    into 2 to 8 splits (up to 15.5 waves) measured no faster on the H100
//    (`tools/decode_ring_sweep.py`): the blocks are bound by their loads,
//    not by the tail, and a load-only copy of the kernel takes 0.78 ms of
//    its 0.81.
#include <cuda_bf16.h>

#include <algorithm>

#include "common.cuh"

namespace {

constexpr int THREADS = 128;
constexpr int STREAMS = THREADS / 16;   // half-warps
constexpr int STAGES = 3;               // K/V tiles in the ring
constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);   // round to nearest even, as torch's cast
}

// Eight consecutive elements of a row of the ring, as loaded (raw) and as
// float32.
template <typename T>
struct Vec8;

template <>
struct Vec8<__nv_bfloat16> {
  uint4 r;
  // `valid` of the 8 elements exist (zeros after); p is 16-byte aligned.
  __device__ __forceinline__ void load(const __nv_bfloat16* p, int valid) {
    if (valid >= 8) {
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
  __device__ __forceinline__ void load(const float* p, int valid) {
    if (valid >= 8) {
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
  __device__ __forceinline__ void get(float* f) const {
    f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
    f[4] = b.x; f[5] = b.y; f[6] = b.z; f[7] = b.w;
  }
};

// The half-warp's dots of G heads from each lane's partial dots, in
// G - 1 + log2(16 / G) shuffles where summing each head over the 16 lanes
// takes 4 G: at each of the first log2(G) steps a lane keeps half of its
// heads and adds its partner's partials of them; the last steps add over
// the 16 / G lanes that keep the same head.  Lane i ends with the dot of
// head i / (16 / G).
template <int G>
__device__ __forceinline__ float head_dot(const float (&d)[G], int lane) {
  float v[G];
#pragma unroll
  for (int g = 0; g < G; ++g) v[g] = d[g];
  int o = 8;
#pragma unroll
  for (int n = G; n > 1; n >>= 1, o >>= 1) {
    const bool upper = (lane & o) != 0;
#pragma unroll
    for (int i = 0; i < n / 2; ++i) {
      const float send = upper ? v[i] : v[i + n / 2];
      const float keep = upper ? v[i + n / 2] : v[i];
      v[i] = keep + __shfl_xor_sync(0xffffffffu, send, o);
    }
  }
#pragma unroll
  for (; o > 0; o >>= 1) v[0] += __shfl_xor_sync(0xffffffffu, v[0], o);
  return v[0];
}

// Keys a tile: STREAMS x UNROLL (UNROLL keys a stream).
__host__ __device__ constexpr int tile_keys(int nch) {
  return STREAMS * (nch == 1 ? 4 : 2);
}

// Shared row length in elements: dh rounded up to 16 bytes.
__host__ __device__ __forceinline__ int ring_row(int dh, int elt) {
  return (dh * elt + 15) / 16 * 16 / elt;
}

// G: query heads a block takes; NCH: 8-dim chunks a lane holds (dh <=
// 128 NCH).  Where G * NCH <= 4 the registers are capped at 128, so that
// four blocks share an SM.
template <typename TQ, typename TKV, int G, int NCH>
__global__ void __launch_bounds__(THREADS, G * NCH <= 4 ? 4 : 1)
decode_attention_kernel(const TQ* __restrict__ q, const TKV* __restrict__ k,
                        const TKV* __restrict__ v,
                        const int* __restrict__ lengths, int length,
                        TQ* __restrict__ out, float* __restrict__ part,
                        int hq, int hkv, int s, int dh, int window,
                        int splits, int vec, float scale) {
  constexpr int UNROLL = NCH == 1 ? 4 : 2;
  constexpr int TK = tile_keys(NCH);
  constexpr int D = 8 * NCH;          // dims a lane holds
  constexpr int DPAD = 128 * NCH;     // dims a stream holds
  constexpr int CE = 16 / sizeof(TKV);   // elements a 16-byte copy
  __shared__ float sm_m[STREAMS][G], sm_l[STREAMS][G];
  extern __shared__ uint4 smem[];
  TKV* ring = reinterpret_cast<TKV*>(smem);   // [STAGES][K, V][TK][srow]

  const int split = blockIdx.y;
  const int chunks = (hq / hkv) / G;
  const int h = blockIdx.x / chunks;
  const int head0 = h * (hq / hkv) + (blockIdx.x % chunks) * G;
  const int bi = blockIdx.z;
  const int st = threadIdx.x >> 4, lane = threadIdx.x & 15;
  const int srow = ring_row(dh, sizeof(TKV));
  const int cpr = srow / CE;          // 16-byte chunks a row

  // This block's keys: its share of the visible range [lo, hi).
  const int len = lengths != nullptr ? lengths[bi] : length;
  const int lo = window > 0 ? max(0, len - window) : 0;
  const int per = (len - lo + splits - 1) / splits;
  const int k_lo = lo + split * per;
  const int k_hi = min(len, k_lo + per);
  const int n_tiles = k_hi > k_lo ? (k_hi - k_lo + TK - 1) / TK : 0;

  const long long row_stride = static_cast<long long>(hkv) * dh;
  const TKV* kb = k + (static_cast<long long>(bi) * s * hkv + h) * dh;
  const TKV* vb = v + (static_cast<long long>(bi) * s * hkv + h) * dh;
  const bool vec_ok = vec != 0;
  // This thread's first chunk of a tile, and its step (THREADS chunks).
  const int r_first = threadIdx.x / cpr, c_first = threadIdx.x % cpr;
  const int r_step = THREADS / cpr, c_step = THREADS % cpr;
  // Tile t's K rows then V rows into ring stage t % STAGES.
  auto stage_tile = [&](int t) {
    TKV* dst = ring + (t % STAGES) * 2 * TK * srow;
    const int base = k_lo + t * TK;
    int r = r_first, c = c_first;
    for (int e = threadIdx.x; e < 2 * TK * cpr; e += THREADS) {
      const int kpos = base + (r < TK ? r : r - TK);
      const TKV* src = (r < TK ? kb : vb) + kpos * row_stride + c * CE;
      TKV* d = dst + r * srow + c * CE;
      const bool ok = kpos < k_hi;
      if (vec_ok) {
        cp_async16(smem_addr(d), ok ? src : kb, ok ? 16 : 0);
      } else {
#pragma unroll
        for (int x = 0; x < CE; ++x)
          d[x] = (ok && c * CE + x < dh) ? src[x] : TKV();
      }
      r += r_step;
      c += c_step;
      if (c >= cpr) {
        c -= cpr;
        ++r;
      }
    }
  };
#pragma unroll
  for (int t = 0; t < STAGES - 1; ++t) {
    if (t < n_tiles) stage_tile(t);
    cp_async_commit();
  }

  int d0[NCH], valid[NCH];
#pragma unroll
  for (int j = 0; j < NCH; ++j) {
    d0[j] = 8 * (lane + 16 * j);
    valid[j] = dh - d0[j];
  }
  // q in float32 with scale x log2(e) folded in: scores in log2 units.
  const float qscale = scale * LOG2E;
  float qf[G][D];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    const TQ* qrow = q + (static_cast<long long>(bi) * hq + head0 + g) * dh;
#pragma unroll
    for (int j = 0; j < NCH; ++j)
#pragma unroll
      for (int e = 0; e < 8; ++e)
        qf[g][8 * j + e] =
            e < valid[j] ? to_float(qrow[d0[j] + e]) * qscale : 0.0f;
  }

  // The stream's running max and denominator of head `mine` (each lane
  // keeps one head's: the lanes 16 / G apart share it), and its
  // accumulator of every head.
  const int mine = lane / (16 / G);
  float m = NEG_INF, l = 0.0f, acc[G][D];
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int i = 0; i < D; ++i) acc[g][i] = 0.0f;

  for (int t = 0; t < n_tiles; ++t) {
    cp_async_wait<STAGES - 2>();     // this thread's copies of tile t landed
    __syncthreads();                 // everyone's; tile t - 1's stage free
    if (t + STAGES - 1 < n_tiles) stage_tile(t + STAGES - 1);
    cp_async_commit();
    const TKV* ks = ring + (t % STAGES) * 2 * TK * srow;
    const TKV* vs = ks + TK * srow;
    const int base = k_lo + t * TK;
    bool ok[UNROLL];
    float sc[UNROLL];                // head `mine`'s scores, then its p
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int row = st + STREAMS * u;
      ok[u] = base + row < k_hi;
      float part_dot[G];
#pragma unroll
      for (int g = 0; g < G; ++g) part_dot[g] = 0.0f;
#pragma unroll
      for (int j = 0; j < NCH; ++j) {
        Vec8<TKV> kr;
        kr.load(ks + row * srow + d0[j], valid[j]);
        float kf[8];
        kr.get(kf);
#pragma unroll
        for (int g = 0; g < G; ++g)
#pragma unroll
          for (int e = 0; e < 8; ++e)
            part_dot[g] = fmaf(qf[g][8 * j + e], kf[e], part_dot[g]);
      }
      // Every lane shuffles, whether or not its stream's key exists.
      const float dot = head_dot<G>(part_dot, lane);
      sc[u] = ok[u] ? dot : NEG_INF;
    }
    // Online softmax of head `mine` over this tile's keys of the stream.
    float mx = m;
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) mx = fmaxf(mx, sc[u]);
    const float alpha = exp2f(m - mx);
    float ps = 0.0f;
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      sc[u] = ok[u] ? exp2f(sc[u] - mx) : 0.0f;
      ps += sc[u];
    }
    l = l * alpha + ps;
    m = mx;
    // Rescale the accumulators only where some head's max moved.
    if (__any_sync(0xffffffffu, alpha != 1.0f)) {
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const float ag = __shfl_sync(0xffffffffu, alpha, g * (16 / G), 16);
#pragma unroll
        for (int i = 0; i < D; ++i) acc[g][i] *= ag;
      }
    }
    // Keys past the block's range are zeros in the ring, with p = 0.
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int row = st + STREAMS * u;
      float pg[G];
#pragma unroll
      for (int g = 0; g < G; ++g)
        pg[g] = __shfl_sync(0xffffffffu, sc[u], g * (16 / G), 16);
#pragma unroll
      for (int j = 0; j < NCH; ++j) {
        Vec8<TKV> vr;
        vr.load(vs + row * srow + d0[j], valid[j]);
        float vf[8];
        vr.get(vf);
#pragma unroll
        for (int g = 0; g < G; ++g)
#pragma unroll
          for (int e = 0; e < 8; ++e)
            acc[g][8 * j + e] = fmaf(pg[g], vf[e], acc[g][8 * j + e]);
      }
    }
  }

  // Merge the eight streams in stream order, through the ring's space.
  cp_async_wait<0>();
  __syncthreads();
  float* sm_acc = reinterpret_cast<float*>(smem);   // [STREAMS][G][DPAD]
  if (lane % (16 / G) == 0) {
    sm_m[st][mine] = m;
    sm_l[st][mine] = l;
  }
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int j = 0; j < NCH; ++j)
#pragma unroll
      for (int e = 0; e < 8; ++e)
        sm_acc[(st * G + g) * DPAD + d0[j] + e] = acc[g][8 * j + e];
  __syncthreads();
  for (int idx = threadIdx.x; idx < G * dh; idx += THREADS) {
    const int g = idx / dh, d = idx - g * dh;
    float mm = NEG_INF;
#pragma unroll
    for (int t = 0; t < STREAMS; ++t) mm = fmaxf(mm, sm_m[t][g]);
    float ll = 0.0f, aa = 0.0f;
#pragma unroll
    for (int t = 0; t < STREAMS; ++t) {
      const float w = exp2f(sm_m[t][g] - mm);
      ll = fmaf(sm_l[t][g], w, ll);
      aa = fmaf(sm_acc[(t * G + g) * DPAD + d], w, aa);
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
      const float w = exp2f(r[0] - mm);
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
  const int srow = ring_row(dh, sizeof(TKV));
  const size_t bytes = std::max(
      sizeof(TKV) * STAGES * 2 * tile_keys(NCH) * srow,
      sizeof(float) * STREAMS * G * 128 * NCH);
  auto kern = decode_attention_kernel<TQ, TKV, G, NCH>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  // Heads vary fastest, so the blocks that run together read neighbouring
  // slices of the same cache rows.
  const dim3 grid(hkv * ((hq / hkv) / G), splits, b);
  kern<<<grid, THREADS, bytes, stream>>>(
      static_cast<const TQ*>(q), static_cast<const TKV*>(k),
      static_cast<const TKV*>(v), lengths, length, static_cast<TQ*>(out),
      part, hq, hkv, s, dh, window, splits, vec, scale);
  err = cudaGetLastError();
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
