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
// Design.  One block per node; each thread owns whole features and walks
// their 256 bins in order, a sequential cumulative sum over bins x C
// channels held in registers.  |G_l|^2 is the sum over the C-1 gradient
// channels of the squared left sums, as the reference computes it: the TPU
// kernel's  sum_c s_c^2 - count^2  shortcut (split_kernel.py:53-60) cancels
// and is not used.  Each thread keeps its first maximum (strict >, features
// and bins ascending); a block reduction then picks the larger gain, the
// lower index on ties.  No atomics: the result is the same on every run.
//
// Wide histograms (C > 64: SketchBoost Full, d + 1 channels) do not fit a
// thread's registers; they have their own entry point
// (split_scan_wide_launch) and two kernels.  In the first, one block owns
// one (node, feature) and walks its bins in order with the channels spread
// over the threads (up to WIDE_PER each), reducing |G_l|^2, |G_r|^2 and the
// left count over the block at every bin; thread 0 keeps the feature's
// first maximum.  The second picks each node's best over its features in
// ascending order (strict >), so ties again go to the lowest index.
#include <cmath>

#include "common.cuh"

namespace {

constexpr int THREADS = 128;

template <int MAXC>
__global__ void __launch_bounds__(THREADS)
split_scan_kernel(const float* __restrict__ hist, const float* __restrict__ mask,
                  float* __restrict__ gain_out, int32_t* __restrict__ idx_out,
                  int m, int B, int C, float lam, float min_data) {
  const int node = blockIdx.x;
  float best = -INFINITY;
  int best_idx = 0;
  for (int f = threadIdx.x; f < m; f += THREADS) {
    if (!(mask[f] > 0.0f)) continue;
    const float* h = hist + (static_cast<long long>(node) * m + f) * B * C;
    float tot[MAXC];
#pragma unroll
    for (int c = 0; c < MAXC; ++c) tot[c] = 0.0f;
    for (int b = 0; b < B; ++b) {
#pragma unroll
      for (int c = 0; c < MAXC; ++c)
        if (c < C) tot[c] += h[b * C + c];
    }
    float ct = 0.0f, tot_sq = 0.0f;
#pragma unroll
    for (int c = 0; c < MAXC; ++c) {
      if (c < C - 1) tot_sq += tot[c] * tot[c];
      if (c == C - 1) ct = tot[c];
    }
    const float s_parent = tot_sq / (ct + lam);
    float cs[MAXC];
#pragma unroll
    for (int c = 0; c < MAXC; ++c) cs[c] = 0.0f;
    for (int b = 0; b < B - 1; ++b) {
      float sl = 0.0f, sr = 0.0f, cl = 0.0f;
#pragma unroll
      for (int c = 0; c < MAXC; ++c) {
        if (c < C) cs[c] += h[b * C + c];
        if (c < C - 1) {
          const float r = tot[c] - cs[c];
          sl += cs[c] * cs[c];
          sr += r * r;
        }
        if (c == C - 1) cl = cs[c];
      }
      const float cr = ct - cl;
      const float gain = 0.5f * (sl / (cl + lam) + sr / (cr + lam) - s_parent);
      if (cl >= min_data && cr >= min_data && gain > best) {
        best = gain;
        best_idx = f * B + b;
      }
    }
  }

  __shared__ float s_gain[THREADS];
  __shared__ int s_idx[THREADS];
  s_gain[threadIdx.x] = best;
  s_idx[threadIdx.x] = best_idx;
  __syncthreads();
  for (int stride = THREADS / 2; stride > 0; stride /= 2) {
    if (threadIdx.x < stride) {
      const float g2 = s_gain[threadIdx.x + stride];
      const int i2 = s_idx[threadIdx.x + stride];
      const float g1 = s_gain[threadIdx.x];
      const int i1 = s_idx[threadIdx.x];
      if (g2 > g1 || (g2 == g1 && i2 < i1)) {
        s_gain[threadIdx.x] = g2;
        s_idx[threadIdx.x] = i2;
      }
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    gain_out[node] = s_gain[0];
    idx_out[node] = s_idx[0];
  }
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
// unsketched.
extern "C" int split_scan_launch(const void* hist, const void* mask,
                                 void* gain, void* idx, int n_nodes, int m,
                                 int B, int C, float lam, float min_data,
                                 void* stream) {
  if (C < 2 || C > 64) return cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  auto h = static_cast<const float*>(hist);
  auto mk = static_cast<const float*>(mask);
  auto g = static_cast<float*>(gain);
  auto i = static_cast<int32_t*>(idx);
  if (C <= 8)
    split_scan_kernel<8><<<n_nodes, THREADS, 0, s>>>(h, mk, g, i, m, B, C, lam, min_data);
  else if (C <= 16)
    split_scan_kernel<16><<<n_nodes, THREADS, 0, s>>>(h, mk, g, i, m, B, C, lam, min_data);
  else
    split_scan_kernel<64><<<n_nodes, THREADS, 0, s>>>(h, mk, g, i, m, B, C, lam, min_data);
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
