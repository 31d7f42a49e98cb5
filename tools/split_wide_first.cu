// B2-wide's first design: the wide entry point of
// src/repro_torch/kernels/csrc/split.cu as it stood before its redesign
// (the code below is copied verbatim), for `chip_smoke.py` and
// `tools/split_wide_sweep.py` to time beside the current one on the same
// inputs.  Same function as B2 (split.cu's header).
//
// Wide histograms (C > 64: SketchBoost Full, d + 1 channels) do not fit a
// thread's registers; they have their own entry point
// (split_scan_wide_launch) and two kernels.  In the first, one block owns
// one (node, feature) and walks its bins in order with the channels spread
// over the threads (up to WIDE_PER each), reducing |G_l|^2, |G_r|^2 and the
// left count over the block at every bin; thread 0 keeps the feature's
// first maximum.  `split_pick_kernel` then picks each node's best over its
// features in ascending order (strict >), so ties go to the lowest index.
#include <climits>
#include <cmath>

#include "common.cuh"

namespace {

constexpr int THREADS = 128;
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
