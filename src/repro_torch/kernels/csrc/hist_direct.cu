// B4: the direct engine's whole-level histograms.
//
// Replaces the TPU kernel `histogram_pallas` / `_hist_kernel`
// (src/repro/kernels/hist_kernel.py:70, :46), reached through
// `ops.histogram` and `ops.histogram_splits` (src/repro/kernels/ops.py:65,
// :122).
//
// Function.  Rows stay in dataset order.  out[v, f, b, c] is the sum of
// stats[i, c0 + c] over the rows i with node_pos[i] == v and
// codes_t[f, i] == b, added one at a time in row order starting from 0.0f:
// the order of the plain version `ref.histogram_ref`, so the two agree bit
// for bit, and the result is the same on every run.
//
// Bound on the H100.  Bytes: the codes (m n), node_pos (4 n), the stats
// (4 n C) and the output (4 nodes m B C), about 288 MB at level 5 of the
// paper's configuration, 0.086 ms at 3.35 TB/s; the m n C additions are
// far below the fp32 rate, so the function is bound by bytes.  This first
// kernel is bound by its per-tile bookkeeping instead (five barriers and a
// counting sort per 256 rows), and every block reads all n rows.
//
// Design.  The TPU built a one-hot of node * B + bin over nb_chunk columns
// for every row tile and contracted it on the MXU, with channels padded to
// 128 lanes; its work grows with the node count.  Here one block owns one
// feature and a chunk of nodes (as many as fit: nc * cw * B floats of
// shared memory; all 32 nodes of level 5 at C = 6), one thread per bin.
// Each 256-row tile is staged in shared memory and stably sorted by bin
// (ranks within a warp from __match_any_sync, warps in order), so thread
// b then walks only its own rows, in row order, adding them into its
// cells of the chunk's histogram.  No two threads add into one cell and
// there are no atomics, global or shared.  Rows of other chunks are
// skipped when staged.  A launch handles at most CW channels (from c0);
// the wrapper launches once per window.
#include <algorithm>

#include "common.cuh"

namespace {

constexpr int TILE = 256;            // rows per tile, threads, largest bin count
constexpr int WARPS = TILE / 32;
constexpr int CW = 8;                // channels per launch

struct Smem {
  float* hist;      // [nc][cw][n_bins]
  float* stats;     // [TILE][CW]
  int* node;        // [TILE] node within the chunk
  int* wcount;      // [WARPS][TILE] rows per (warp, bin), then offsets
  int* bstart;      // [TILE] first sorted slot of each bin
  int* btotal;      // [TILE] rows of each bin in the tile
  int* wsum;        // [WARPS]
  uint8_t* sorted;  // [TILE] tile slots in (bin, row) order
};

__host__ __device__ size_t smem_bytes(int nc, int cw, int n_bins) {
  return sizeof(float) * (static_cast<size_t>(nc) * cw * n_bins + TILE * CW) +
         sizeof(int) * (TILE + WARPS * TILE + 2 * TILE + WARPS) + TILE;
}

__device__ Smem carve(unsigned char* base, int nc, int cw, int n_bins) {
  Smem s;
  s.hist = reinterpret_cast<float*>(base);
  s.stats = s.hist + static_cast<size_t>(nc) * cw * n_bins;
  s.node = reinterpret_cast<int*>(s.stats + TILE * CW);
  s.wcount = s.node + TILE;
  s.bstart = s.wcount + WARPS * TILE;
  s.btotal = s.bstart + TILE;
  s.wsum = s.btotal + TILE;
  s.sorted = reinterpret_cast<uint8_t*>(s.wsum + WARPS);
  return s;
}

__global__ void __launch_bounds__(TILE)
hist_direct_kernel(const uint8_t* __restrict__ codes_t,
                   const int32_t* __restrict__ node_pos,
                   const float* __restrict__ stats, float* __restrict__ out,
                   long long n, int m, int n_nodes, int n_bins, int C, int c0,
                   int cw, int nc_max) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const Smem s = carve(smem_raw, nc_max, cw, n_bins);
  const int chunk0 = blockIdx.x * nc_max;
  const int nc = min(nc_max, n_nodes - chunk0);
  const int f = blockIdx.y;
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int w = t >> 5;
  const int hist_len = nc * cw * n_bins;
  for (int i = t; i < hist_len; i += TILE) s.hist[i] = 0.0f;
  const uint8_t* col = codes_t + static_cast<long long>(f) * n;

  for (long long r0 = 0; r0 < n; r0 += TILE) {
    // Stage the tile; key is the row's bin, or -1 for a row this block
    // does not count (past n, or in another chunk's node).
    const long long r = r0 + t;
    int key = -1;
    if (r < n) {
      const int v = node_pos[r] - chunk0;
      if (v >= 0 && v < nc) {
        key = col[r];
        s.node[t] = v;
        const float* src = stats + r * C + c0;
#pragma unroll
        for (int c = 0; c < CW; ++c) s.stats[t * CW + c] = c < cw ? src[c] : 0.0f;
      }
    }
#pragma unroll
    for (int j = 0; j < WARPS; ++j) s.wcount[j * TILE + t] = 0;
    __syncthreads();

    // Stable rank of the row among its warp's rows of the same bin.
    const unsigned peers = __match_any_sync(0xffffffffu, key);
    const int rank = __popc(peers & ((1u << lane) - 1u));
    if (key >= 0 && rank == 0) s.wcount[w * TILE + key] = __popc(peers);
    __syncthreads();

    // Thread t, as bin t: each warp's offset within the bin, the bin's
    // total, and the bin's first slot (an exclusive scan over bins).
    int total = 0;
#pragma unroll
    for (int j = 0; j < WARPS; ++j) {
      const int cnt = s.wcount[j * TILE + t];
      s.wcount[j * TILE + t] = total;
      total += cnt;
    }
    s.btotal[t] = total;
    int incl = total;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += y;
    }
    if (lane == 31) s.wsum[w] = incl;
    __syncthreads();
    int before = 0;
    for (int j = 0; j < w; ++j) before += s.wsum[j];
    s.bstart[t] = before + incl - total;
    __syncthreads();

    if (key >= 0)
      s.sorted[s.bstart[key] + s.wcount[w * TILE + key] + rank] =
          static_cast<uint8_t>(t);
    __syncthreads();

    // Thread b adds its bin's rows, in row order.
    if (t < n_bins) {
      const int beg = s.bstart[t];
      const int end = beg + s.btotal[t];
      for (int i = beg; i < end; ++i) {
        const int slot = s.sorted[i];
        float* h = s.hist + s.node[slot] * cw * n_bins + t;
        const float* sv = s.stats + slot * CW;
#pragma unroll
        for (int c = 0; c < CW; ++c)
          if (c < cw) h[c * n_bins] += sv[c];
      }
    }
    __syncthreads();
  }

  if (t < n_bins) {
    for (int v = 0; v < nc; ++v) {
      float* o = out + ((static_cast<long long>(chunk0 + v) * m + f) * n_bins + t) * C + c0;
      for (int c = 0; c < cw; ++c) o[c] = s.hist[(v * cw + c) * n_bins + t];
    }
  }
}

}  // namespace

extern "C" int hist_direct_launch(const void* codes_t, const void* node_pos,
                                  const void* stats, void* out, long long n,
                                  int m, int n_nodes, int n_bins, int C, int c0,
                                  int cw, void* stream) {
  if (n_bins < 2 || n_bins > TILE || cw < 1 || cw > CW || n_nodes < 1 || m < 1)
    return cudaErrorInvalidValue;
  // The largest node chunk whose histogram fits in a block's shared memory.
  int dev = 0, optin = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long per_node = static_cast<long long>(sizeof(float)) * cw * n_bins;
  const long long room = static_cast<long long>(optin) - smem_bytes(0, cw, n_bins);
  if (room < per_node) return cudaErrorInvalidValue;
  const int nc_max = static_cast<int>(std::min<long long>(n_nodes, room / per_node));
  const size_t smem = smem_bytes(nc_max, cw, n_bins);
  if (smem > 48 * 1024) {
    e = cudaFuncSetAttribute(hist_direct_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  dim3 grid((n_nodes + nc_max - 1) / nc_max, m);
  hist_direct_kernel<<<grid, TILE, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(codes_t), static_cast<const int32_t*>(node_pos),
      static_cast<const float*>(stats), static_cast<float*>(out), n, m, n_nodes,
      n_bins, C, c0, cw, nc_max);
  return static_cast<int>(cudaGetLastError());
}
