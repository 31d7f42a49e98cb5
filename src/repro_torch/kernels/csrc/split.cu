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
// Design (C <= 32).  One warp a (node, feature), so a level of `nodes`
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
// Wide histograms (C > 32: wider sketches, and SketchBoost Full's d + 1
// channels, 513 on the paper's configuration) do not fit a thread's
// registers well (64 channels took 254 registers, 3 warps an SM).  Their
// entry point, split_scan_wide_launch, runs three kernels and no block
// barrier a bin:
//   1. split_wide_scan_kernel: a block of W warps a (node, feature, span of
//      `chunks` x 32 gradient channels).  The block copies each chunk of
//      32 channels x B bins into shared memory once, double-buffered, with
//      4-byte cp.async copies: one instruction copies one bin's 32
//      channels, 128 contiguous bytes (a bin's row is 4 C bytes, not a
//      multiple of 16 at odd C; the histogram is read as B1 wrote it).  The
//      chunk is stored transposed and swizzled so that lane q's bins
//      [qR, qR + R) sit on their own banks.  Warp w takes 32 / W channels
//      of every chunk; for each, in order, lane q does what the narrow
//      kernel does (sums its run, joins the runs by the Kogge-Stone scan,
//      walks its run from the prefix) and adds cs^2 and (T - cs)^2 into its
//      R bins' partial sums, from 0 in channel order.  Each warp is one
//      group of channels: it writes (sum cs^2, sum (T - cs)^2) a bin into
//      the scratch (nodes, m, G, B, 2), G = W x spans; bin B - 1, never a
//      candidate, carries the group's sum of T^2 in their place.  One block
//      barrier a chunk of 32 channels, none a bin.
//   2. split_wide_score_kernel: one warp a (node, feature).  Lane q folds
//      its bins' partials over the groups in group order from 0, scans the
//      count channel as the narrow kernel does, scores each bin with
//      right = total - left and keeps its first maximum; a shuffle
//      butterfly keeps the larger gain, the lower index on ties.
//   3. split_pick_kernel, as above.
// Every sum runs in an order fixed by the source and the wrapper's W and
// chunks (the narrow kernel is the case of one group), so the result is
// the same on every run; `tests/test_torch_split_order.py` replays it in
// numpy.  Bound: the histogram read once (1.68 GB at Full's level 5, 0.50
// ms at 3.35 TB/s); the scratch, 8 bytes a (node, feature, group, bin)
// written once and read once, adds 12.5% to that traffic at 32 channels a
// group.
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

constexpr int kSpan = 32;          // channels a staged chunk: a lane each
constexpr int kMaxRun = 8;         // bins a lane: B <= 256
constexpr int MAX_WIDE_WARPS = 8;  // warps a scan block
constexpr int SCORE_WARPS = 4;     // warps a score block
constexpr int MAX_WIDE_CHANNELS = 1024;

// Shared-memory slot of channel k (0..31), bin q * run + j of a chunk:
// each channel's bins in lane-major order, the lane bits XORed with k, so
// that a copy (one bin, 32 channels) and a read (one channel, 32 lanes)
// each meet 32 banks.
__device__ __forceinline__ int chunk_slot(int k, int q, int j, int run) {
  return (k * run + j) * 32 + (q ^ k);
}

// Block per (node, feature, span of `chunks` x 32 gradient channels); the
// W = blockDim.x / 32 warps stage each chunk of 32 channels x B bins
// together, double-buffered, and warp w scans channels [w P, w P + P) of
// every chunk, P = 32 / W.  Its partial sums are group g = s W + w of the
// (node, feature), G groups in all.
__global__ void __launch_bounds__(MAX_WIDE_WARPS * 32)
split_wide_scan_kernel(const float* __restrict__ hist,
                       const float* __restrict__ mask,
                       float2* __restrict__ part, int m, int B, int C, int G,
                       int chunks) {
  extern __shared__ float s_chunk[];
  const int W = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int spans = G / W;
  const long long nf = blockIdx.x / spans;
  const int span = static_cast<int>(blockIdx.x - nf * spans);
  if (!(mask[nf % m] > 0.0f)) return;          // the whole block; the score
                                               // kernel skips the feature
  const int c0 = span * chunks * kSpan;        // first channel of the span
  const int nch = min(chunks * kSpan, C - 1 - c0);
  const int nchunks = (nch + kSpan - 1) / kSpan;
  const int per = kSpan / W;
  const int run = (B + 31) / 32;
  const int b0 = lane * run;
  const int nb = max(0, min(run, B - b0));     // bins in this lane's run
  const int buf_floats = kSpan * 32 * run;
  const float* h = hist + nf * B * C + c0;
  // Warp w copies bins w, w + W, ... of channel c0 + 32 chunk + lane.
  auto stage = [&](int chunk) {
    if (chunk * kSpan + lane >= nch) return;
    float* buf = s_chunk + (chunk & 1) * buf_floats;
    int q = warp / run, j = warp - q * run;
    for (int b = warp; b < B; b += W) {
      cp_async4(smem_addr(buf + chunk_slot(lane, q, j, run)),
                h + static_cast<long long>(b) * C + chunk * kSpan + lane);
      for (j += W; j >= run; j -= run) ++q;
    }
  };
  float sl[kMaxRun], sr[kMaxRun];
#pragma unroll
  for (int j = 0; j < kMaxRun; ++j) sl[j] = sr[j] = 0.0f;
  float tsq = 0.0f;
  stage(0);
  cp_async_commit();
  for (int ch = 0; ch < nchunks; ++ch) {
    cp_async_wait<0>();
    __syncthreads();             // chunk ch is in, chunk ch - 1 is done with
    if (ch + 1 < nchunks) stage(ch + 1);
    cp_async_commit();
    const float* buf = s_chunk + (ch & 1) * buf_floats;
    const int k0 = warp * per;
    const int k1 = min(k0 + per, nch - ch * kSpan);
    for (int k = k0; k < k1; ++k) {
      float v[kMaxRun];
      float p = 0.0f;
#pragma unroll
      for (int j = 0; j < kMaxRun; ++j) {
        if (j < nb) {
          v[j] = buf[chunk_slot(k, lane, j, run)];
          p += v[j];
        }
      }
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float t = __shfl_up_sync(FULL, p, off);
        if (lane >= off) p = t + p;
      }
      const float tot = __shfl_sync(FULL, p, 31);
      const float before = __shfl_up_sync(FULL, p, 1);
      float cs = lane == 0 ? 0.0f : before;
      tsq += tot * tot;
#pragma unroll
      for (int j = 0; j < kMaxRun; ++j) {
        if (j < nb) {
          cs += v[j];
          const float r = tot - cs;
          sl[j] += cs * cs;
          sr[j] += r * r;
        }
      }
    }
  }
  float2* out = part + (nf * G + span * W + warp) * B + b0;
#pragma unroll
  for (int j = 0; j < kMaxRun; ++j)
    if (j < nb)
      out[j] = b0 + j == B - 1 ? make_float2(tsq, 0.0f)
                               : make_float2(sl[j], sr[j]);
}

// Warp per (node, feature) unit u = node * m + f: its first maximum over
// bins into part_gain[u], part_idx[u] ((-inf, 0) if none is legal).
__global__ void __launch_bounds__(SCORE_WARPS * 32)
split_wide_score_kernel(const float* __restrict__ hist,
                        const float* __restrict__ mask,
                        const float2* __restrict__ part,
                        float* __restrict__ part_gain,
                        int32_t* __restrict__ part_idx, int units, int m,
                        int B, int C, int G, float lam, float min_data) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int u = blockIdx.x * SCORE_WARPS + warp;
  if (u >= units) return;                      // whole warps only
  const int f = u % m;
  if (!(mask[f] > 0.0f)) {
    if (lane == 0) {
      part_gain[u] = -INFINITY;
      part_idx[u] = 0;
    }
    return;
  }
  const int run = (B + 31) / 32;
  const int b0 = lane * run;
  const int nb = max(0, min(run, B - b0));
  // The count channel, scanned as the narrow kernel scans a channel.
  const float* hc = hist + static_cast<long long>(u) * B * C + (C - 1);
  float cnt[kMaxRun];
  float p = 0.0f;
#pragma unroll
  for (int j = 0; j < kMaxRun; ++j) {
    if (j < nb) {
      cnt[j] = __ldg(hc + static_cast<long long>(b0 + j) * C);
      p += cnt[j];
    }
  }
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float t = __shfl_up_sync(FULL, p, off);
    if (lane >= off) p = t + p;
  }
  const float ct = __shfl_sync(FULL, p, 31);
  const float before = __shfl_up_sync(FULL, p, 1);
  float cl = lane == 0 ? 0.0f : before;
  // The groups' partials, folded in group order from 0.
  const float2* pu = part + static_cast<long long>(u) * G * B;
  float sl[kMaxRun], sr[kMaxRun];
#pragma unroll
  for (int j = 0; j < kMaxRun; ++j) sl[j] = sr[j] = 0.0f;
  float tot_sq = 0.0f;
  for (int g = 0; g < G; ++g) {
    const float2* pg = pu + static_cast<long long>(g) * B;
#pragma unroll
    for (int j = 0; j < kMaxRun; ++j) {
      if (j < nb) {
        const float2 x = pg[b0 + j];
        sl[j] += x.x;
        sr[j] += x.y;
      }
    }
    tot_sq += pg[B - 1].x;
  }
  const float s_parent = tot_sq / (ct + lam);
  float best = -INFINITY;
  int best_idx = INT_MAX;
#pragma unroll
  for (int j = 0; j < kMaxRun; ++j) {
    if (j < nb) {
      const int b = b0 + j;
      cl += cnt[j];
      if (b < B - 1) {
        const float cr = ct - cl;
        const float gain =
            0.5f * (sl[j] / (cl + lam) + sr[j] / (cr + lam) - s_parent);
        if (cl >= min_data && cr >= min_data && gain > best) {
          best = gain;
          best_idx = f * B + b;
        }
      }
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

// Channel counts up to 32 in registers: sketch width k <= 31, or d <= 31
// unsketched.  part_gain and part_idx are (n_nodes, m) scratch for the
// per-feature maxima.
extern "C" int split_scan_launch(const void* hist, const void* mask,
                                 void* gain, void* idx, void* part_gain,
                                 void* part_idx, int n_nodes, int m, int B,
                                 int C, float lam, float min_data,
                                 void* stream) {
  if (C < 2 || C > 32 || B < 1 || m < 1) return cudaErrorInvalidValue;
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
  else
    err = launch_units<32>(h, mk, pg, pi, u, m, B, C, lam, min_data, s);
  if (err != 0) return err;
  split_pick_kernel<<<(n_nodes + THREADS - 1) / THREADS, THREADS, 0, s>>>(
      pg, pi, static_cast<float*>(gain), static_cast<int32_t*>(idx), n_nodes,
      m);
  return static_cast<int>(cudaGetLastError());
}

// Wide histograms: 2 to 1,024 channels (the wrapper sends those above 32)
// and at most 256 bins.  part_gain and part_idx are (n_nodes, m) scratch
// for the per-feature maxima; scan_part is (n_nodes, m, G, B) float2
// scratch for the groups' partial sums, G = warps * ceil((C - 1) /
// (32 * chunks)): a scan block of `warps` warps (1, 2, 4 or 8) takes
// `chunks` chunks of 32 gradient channels.
extern "C" int split_scan_wide_launch(const void* hist, const void* mask,
                                      void* gain, void* idx, void* part_gain,
                                      void* part_idx, void* scan_part,
                                      int n_nodes, int m, int B, int C,
                                      int warps, int chunks, float lam,
                                      float min_data, void* stream) {
  if (C < 2 || C > MAX_WIDE_CHANNELS || B < 1 || B > 32 * kMaxRun ||
      m < 1 || warps < 1 || warps > MAX_WIDE_WARPS || 32 % warps != 0 ||
      chunks < 1)
    return cudaErrorInvalidValue;
  if (n_nodes < 1) return 0;
  const long long units = static_cast<long long>(n_nodes) * m;
  const int spans = (C - 2) / (chunks * kSpan) + 1;
  if (units * spans > INT_MAX) return cudaErrorInvalidValue;
  const int G = spans * warps;
  auto s = static_cast<cudaStream_t>(stream);
  auto mk = static_cast<const float*>(mask);
  auto h = static_cast<const float*>(hist);
  auto sp = static_cast<float2*>(scan_part);
  auto pg = static_cast<float*>(part_gain);
  auto pi = static_cast<int32_t*>(part_idx);
  // Two chunk buffers a block: 64 KB at 256 bins.
  const int smem = 2 * 4 * kSpan * 32 * ((B + 31) / 32);
  cudaError_t e = cudaSuccess;
  if (smem > 48 * 1024) {
    e = cudaFuncSetAttribute(split_wide_scan_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  split_wide_scan_kernel<<<static_cast<int>(units * spans), warps * 32, smem,
                           s>>>(h, mk, sp, m, B, C, G, chunks);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const int u = static_cast<int>(units);
  split_wide_score_kernel<<<(u + SCORE_WARPS - 1) / SCORE_WARPS,
                            SCORE_WARPS * 32, 0, s>>>(
      h, mk, sp, pg, pi, u, m, B, C, G, lam, min_data);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  split_pick_kernel<<<(n_nodes + THREADS - 1) / THREADS, THREADS, 0, s>>>(
      pg, pi, static_cast<float*>(gain), static_cast<int32_t*>(idx), n_nodes,
      m);
  return static_cast<int>(cudaGetLastError());
}
