// B2: best split per node (paper eq. (4)) from per-node histograms.
//
// Replaces the TPU kernel `split_scan_pallas` (src/repro/kernels/split_kernel.py).
//
// Function.  hist is (nodes, m, B, C): channels [0, C-1) are sketched
// gradient sums, channel C-1 the row counts.  For every node, feature f and
// threshold bin b (left = bins <= b):
//   gain = 0.5 * (|G_l|^2 / (c_l + lam) + |G_r|^2 / (c_r + lam)
//                 - |G|^2 / (c + lam)),
// illegal (-inf) for the last bin, for c_l or c_r below min_data, and for
// masked features.  Output per node: the largest gain and its flat index
// f * B + b, the LOWEST index among equal gains (jnp.argmax's rule), and
// (-inf, 0) when no candidate is legal.
//
// Bound on the H100.  The kernel reads each histogram once (4 nodes m B C
// bytes, about 20 MB at the main path's deepest level) and does about
// 4 C + 12 operations per candidate, so it is bound by bytes.
//
// Design (C <= 64).  One warp a (node, feature), so a level of `nodes`
// nodes runs nodes * m warps: 100 at the root of a level-wise tree, 200 for
// a leaf-wise expansion.  The warp copies the feature's contiguous B x C
// slab to shared memory with coalesced loads (16 bytes a lane where the
// slab is aligned), padded so that each lane's run of bins starts on its
// own bank.  Lane q owns the R = ceil(B / 32) consecutive bins [qR, qR + R):
//   1. it sums its run bin by bin, per channel, from 0;
//   2. the lanes' sums are joined by a Kogge-Stone scan over the warp
//      (shuffle-up by 1, 2, 4, 8, 16; a lane's value is added after the
//      one it receives), which gives each lane the sum of all runs before
//      its own (the scan of lane q - 1, 0 for lane 0) and, from lane 31,
//      the total;
//   3. it walks its run again from that prefix, adding bin by bin, and
//      scores every bin but the last with right = total - left, as the
//      plain version does (|G_l|^2 is the sum over the C - 1 gradient
//      channels of the squared left sums: the TPU kernel's
//      sum_c s_c^2 - count^2 shortcut, split_kernel.py:53-60, cancels);
//   4. each lane keeps its first maximum (strict >, bins ascending), and a
//      shuffle butterfly keeps the larger gain, the lower index on ties.
// The order of every sum is fixed in the source; the counts are integers,
// so the min_data tests see the plain version's counts exactly.  A second
// kernel, `split_pick_kernel` (shared with the wide entry point), takes
// each node's best over its features in ascending order (strict >), so
// ties go to the lowest index.  No atomics: the result is the same on every
// run.  `tests/test_torch_split_order.py` replays this order in numpy.
//
// Wide histograms (C > 64: SketchBoost Full, d + 1 channels) do not fit a
// thread's registers; they have their own entry point
// (split_scan_wide_launch) and two kernels.  In the first, one block owns
// one (node, feature) and walks its bins in order with the channels spread
// over the threads (up to WIDE_PER each), reducing |G_l|^2, |G_r|^2 and the
// left count over the block at every bin; thread 0 keeps the feature's
// first maximum.  `split_pick_kernel` then picks each node's best, as
// above.
#include <climits>
#include <cmath>

#include "common.cuh"

namespace {

constexpr int THREADS = 128;
constexpr unsigned FULL = 0xffffffffu;
constexpr int SCAN_WARPS = 4;   // (node, feature) units a block, at most

// Slab layout in shared memory: lane q's run of R bins (R * C floats)
// starts at q * stride, stride = R * C rounded up to an odd count.
__host__ __device__ __forceinline__ int slab_stride(int run, int C) {
  return run * C + ((run * C) % 2 == 0 ? 1 : 0);
}

__device__ __forceinline__ void keep_better(float& g, int& i, float g2,
                                            int i2) {
  if (g2 > g || (g2 == g && i2 < i)) {
    g = g2;
    i = i2;
  }
}

// Warp per (node, feature) unit u = node * m + f: its first maximum over
// bins into part_gain[u], part_idx[u] ((-inf, 0) if none is legal).
template <int MAXC>
__global__ void __launch_bounds__(SCAN_WARPS * 32)
split_unit_kernel(const float* __restrict__ hist,
                  const float* __restrict__ mask,
                  float* __restrict__ part_gain,
                  int32_t* __restrict__ part_idx, int units, int m, int B,
                  int C, float lam, float min_data, int vec) {
  extern __shared__ float s_slab[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int u = blockIdx.x * (blockDim.x >> 5) + warp;
  if (u >= units) return;                      // whole warps only
  const int f = u % m;
  if (!(mask[f] > 0.0f)) {
    if (lane == 0) {
      part_gain[u] = -INFINITY;
      part_idx[u] = 0;
    }
    return;
  }
  const int run = (B + 31) / 32, runC = run * C;
  const int stride = slab_stride(run, C), pad = stride - runC;
  float* slab = s_slab + warp * 32 * stride;
  const float* h = hist + static_cast<long long>(u) * B * C;
  const int nel = B * C;
  // Element e of the slab goes to slab[e + (e / runC) * pad]; q tracks
  // e / runC as e grows.
  if (vec) {
    int q = 0;
    for (int v = lane; 4 * v < nel; v += 32) {
      const float4 x = __ldg(reinterpret_cast<const float4*>(h) + v);
      const float xs[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int e = 4 * v + j;
        while (e >= (q + 1) * runC) ++q;
        slab[e + q * pad] = xs[j];
      }
    }
  } else {
    int q = 0;
    for (int e = lane; e < nel; e += 32) {
      while (e >= (q + 1) * runC) ++q;
      slab[e + q * pad] = __ldg(h + e);
    }
  }
  __syncwarp();

  const float* mine = slab + lane * stride;
  const int b0 = lane * run;
  const int nb = max(0, min(run, B - b0));     // bins in this lane's run
  float p[MAXC];
#pragma unroll
  for (int c = 0; c < MAXC; ++c) p[c] = 0.0f;
  for (int j = 0; j < nb; ++j) {
#pragma unroll
    for (int c = 0; c < MAXC; ++c)
      if (c < C) p[c] += mine[j * C + c];
  }
  // Inclusive scan of the runs' sums over the lanes.
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
#pragma unroll
    for (int c = 0; c < MAXC; ++c) {
      if (c < C) {
        const float t = __shfl_up_sync(FULL, p[c], off);
        if (lane >= off) p[c] = t + p[c];
      }
    }
  }
  float tot[MAXC], cs[MAXC];
#pragma unroll
  for (int c = 0; c < MAXC; ++c) {
    if (c < C) {
      tot[c] = __shfl_sync(FULL, p[c], 31);
      const float before = __shfl_up_sync(FULL, p[c], 1);
      cs[c] = lane == 0 ? 0.0f : before;
    } else {
      tot[c] = cs[c] = 0.0f;
    }
  }
  float tot_sq = 0.0f, ct = 0.0f;
#pragma unroll
  for (int c = 0; c < MAXC; ++c) {
    if (c < C - 1) tot_sq += tot[c] * tot[c];
    if (c == C - 1) ct = tot[c];
  }
  const float s_parent = tot_sq / (ct + lam);
  float best = -INFINITY;
  int best_idx = INT_MAX;
  for (int j = 0; j < nb; ++j) {
    const int b = b0 + j;
    float sl = 0.0f, sr = 0.0f, cl = 0.0f;
#pragma unroll
    for (int c = 0; c < MAXC; ++c) {
      if (c < C) cs[c] += mine[j * C + c];
      if (c < C - 1) {
        const float r = tot[c] - cs[c];
        sl += cs[c] * cs[c];
        sr += r * r;
      }
      if (c == C - 1) cl = cs[c];
    }
    if (b >= B - 1) break;
    const float cr = ct - cl;
    const float gain = 0.5f * (sl / (cl + lam) + sr / (cr + lam) - s_parent);
    if (cl >= min_data && cr >= min_data && gain > best) {
      best = gain;
      best_idx = f * B + b;
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float g2 = __shfl_xor_sync(FULL, best, off);
    const int i2 = __shfl_xor_sync(FULL, best_idx, off);
    keep_better(best, best_idx, g2, i2);
  }
  if (lane == 0) {
    part_gain[u] = best;
    part_idx[u] = best > -INFINITY ? best_idx : 0;
  }
}

template <int MAXC>
int launch_units(const float* h, const float* mk, float* pg, int32_t* pi,
                 int units, int m, int B, int C, float lam, float min_data,
                 cudaStream_t s) {
  int dev = 0, limit = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int run = (B + 31) / 32;
  const long long per_warp = 4LL * 32 * slab_stride(run, C);
  if (per_warp > limit) return static_cast<int>(cudaErrorInvalidValue);
  const int warps = static_cast<int>(
      per_warp * SCAN_WARPS <= limit ? SCAN_WARPS : limit / per_warp);
  const size_t smem = static_cast<size_t>(per_warp * warps);
  if (smem > 48 * 1024) {
    e = cudaFuncSetAttribute(split_unit_kernel<MAXC>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int vec = (reinterpret_cast<uintptr_t>(h) % 16 == 0) &&
                  (B * C) % 4 == 0;
  split_unit_kernel<MAXC><<<(units + warps - 1) / warps, 32 * warps, smem,
                            s>>>(h, mk, pg, pi, units, m, B, C, lam, min_data,
                                 vec);
  return static_cast<int>(cudaGetLastError());
}

constexpr int WIDE_PER = 8;   // channels per thread: C <= 8 * THREADS
constexpr int WARPS = THREADS / 32;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

// Sums (a, b, c) over the block into thread 0, through one of two shared
// buffers (alternate calls use alternate buffers, so one barrier a call
// suffices).
__device__ __forceinline__ void block_sum3(float (*part)[WARPS][3], int& parity,
                                           float& a, float& b, float& c) {
  a = warp_sum(a);
  b = warp_sum(b);
  c = warp_sum(c);
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  if (lane == 0) {
    part[parity][w][0] = a;
    part[parity][w][1] = b;
    part[parity][w][2] = c;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    a = b = c = 0.0f;
    for (int j = 0; j < WARPS; ++j) {
      a += part[parity][j][0];
      b += part[parity][j][1];
      c += part[parity][j][2];
    }
  }
  parity ^= 1;
}

__global__ void __launch_bounds__(THREADS)
split_scan_wide_kernel(const float* __restrict__ hist,
                       const float* __restrict__ mask,
                       float* __restrict__ part_gain,
                       int32_t* __restrict__ part_idx, int m, int B, int C,
                       float lam, float min_data) {
  __shared__ float part[2][WARPS][3];
  const int f = blockIdx.x, node = blockIdx.y;
  const int t = threadIdx.x;
  const long long out = static_cast<long long>(node) * m + f;
  int parity = 0;
  float best = -INFINITY;   // thread 0's
  int best_idx = 0;
  if (!(mask[f] > 0.0f)) {
    if (t == 0) {
      part_gain[out] = best;
      part_idx[out] = best_idx;
    }
    return;
  }
  const float* h = hist + out * B * C;
  float tot[WIDE_PER];
#pragma unroll
  for (int i = 0; i < WIDE_PER; ++i) tot[i] = 0.0f;
  for (int b = 0; b < B; ++b) {
#pragma unroll
    for (int i = 0; i < WIDE_PER; ++i) {
      const int c = t + i * THREADS;
      if (c < C) tot[i] += h[b * C + c];
    }
  }
  float tot_sq = 0.0f, ct = 0.0f, unused = 0.0f;
#pragma unroll
  for (int i = 0; i < WIDE_PER; ++i) {
    const int c = t + i * THREADS;
    if (c < C - 1) tot_sq += tot[i] * tot[i];
    if (c == C - 1) ct = tot[i];
  }
  block_sum3(part, parity, tot_sq, ct, unused);
  const float s_parent = tot_sq / (ct + lam);
  float cs[WIDE_PER];
#pragma unroll
  for (int i = 0; i < WIDE_PER; ++i) cs[i] = 0.0f;
  for (int b = 0; b < B - 1; ++b) {
    float sl = 0.0f, sr = 0.0f, cl = 0.0f;
#pragma unroll
    for (int i = 0; i < WIDE_PER; ++i) {
      const int c = t + i * THREADS;
      if (c < C) cs[i] += h[b * C + c];
      if (c < C - 1) {
        const float r = tot[i] - cs[i];
        sl += cs[i] * cs[i];
        sr += r * r;
      }
      if (c == C - 1) cl = cs[i];
    }
    block_sum3(part, parity, sl, sr, cl);
    if (t == 0) {
      const float cr = ct - cl;
      const float gain = 0.5f * (sl / (cl + lam) + sr / (cr + lam) - s_parent);
      if (cl >= min_data && cr >= min_data && gain > best) {
        best = gain;
        best_idx = f * B + b;
      }
    }
  }
  if (t == 0) {
    part_gain[out] = best;
    part_idx[out] = best_idx;
  }
}

// One thread a node: its features' maxima in ascending order, first wins.
__global__ void split_pick_kernel(const float* __restrict__ part_gain,
                                  const int32_t* __restrict__ part_idx,
                                  float* __restrict__ gain_out,
                                  int32_t* __restrict__ idx_out, int n_nodes,
                                  int m) {
  const int node = blockIdx.x * blockDim.x + threadIdx.x;
  if (node >= n_nodes) return;
  float best = -INFINITY;
  int best_idx = 0;
  for (int f = 0; f < m; ++f) {
    const long long j = static_cast<long long>(node) * m + f;
    if (part_gain[j] > best) {
      best = part_gain[j];
      best_idx = part_idx[j];
    }
  }
  gain_out[node] = best;
  idx_out[node] = best_idx;
}

}  // namespace

// Channel counts up to 64 in registers: sketch width k <= 63, or d <= 63
// unsketched.  part_gain and part_idx are (n_nodes, m) scratch for the
// per-feature maxima.
extern "C" int split_scan_launch(const void* hist, const void* mask,
                                 void* gain, void* idx, void* part_gain,
                                 void* part_idx, int n_nodes, int m, int B,
                                 int C, float lam, float min_data,
                                 void* stream) {
  if (C < 2 || C > 64 || B < 1 || m < 1) return cudaErrorInvalidValue;
  if (n_nodes < 1) return 0;
  auto s = static_cast<cudaStream_t>(stream);
  auto h = static_cast<const float*>(hist);
  auto mk = static_cast<const float*>(mask);
  auto pg = static_cast<float*>(part_gain);
  auto pi = static_cast<int32_t*>(part_idx);
  const long long units = static_cast<long long>(n_nodes) * m;
  if (units > INT_MAX) return cudaErrorInvalidValue;
  const int u = static_cast<int>(units);
  int err;
  if (C <= 8)
    err = launch_units<8>(h, mk, pg, pi, u, m, B, C, lam, min_data, s);
  else if (C <= 16)
    err = launch_units<16>(h, mk, pg, pi, u, m, B, C, lam, min_data, s);
  else if (C <= 32)
    err = launch_units<32>(h, mk, pg, pi, u, m, B, C, lam, min_data, s);
  else
    err = launch_units<64>(h, mk, pg, pi, u, m, B, C, lam, min_data, s);
  if (err != 0) return err;
  split_pick_kernel<<<(n_nodes + THREADS - 1) / THREADS, THREADS, 0, s>>>(
      pg, pi, static_cast<float*>(gain), static_cast<int32_t*>(idx), n_nodes,
      m);
  return static_cast<int>(cudaGetLastError());
}

// Wide histograms: 65 to 1,024 channels, spread over a block.  part_gain
// and part_idx are (n_nodes, m) scratch for the per-feature maxima.
extern "C" int split_scan_wide_launch(const void* hist, const void* mask,
                                      void* gain, void* idx, void* part_gain,
                                      void* part_idx, int n_nodes, int m,
                                      int B, int C, float lam, float min_data,
                                      void* stream) {
  if (C <= 64 || C > WIDE_PER * THREADS || n_nodes > 65535)
    return cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  auto pg = static_cast<float*>(part_gain);
  auto pi = static_cast<int32_t*>(part_idx);
  split_scan_wide_kernel<<<dim3(m, n_nodes), THREADS, 0, s>>>(
      static_cast<const float*>(hist), static_cast<const float*>(mask), pg, pi,
      m, B, C, lam, min_data);
  split_pick_kernel<<<(n_nodes + THREADS - 1) / THREADS, THREADS, 0, s>>>(
      pg, pi, static_cast<float*>(gain), static_cast<int32_t*>(idx), n_nodes,
      m);
  return static_cast<int>(cudaGetLastError());
}
