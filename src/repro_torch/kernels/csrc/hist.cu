// B1: per-node gradient histograms of node-contiguous rows.
//
// Replaces the TPU kernel `hist_tiles_pallas` (src/repro/kernels/hist_kernel.py)
// together with the tile->node segment_sum epilogue of
// `ops.histogram_splits_level` (src/repro/kernels/ops.py:247).
//
// Function.  Rows are kept sorted by tree node (`order`, a stable partition),
// and `stats_p` holds each row's statistics in that partition order.  For
// node v the rows [start_v, start_v + build_counts[v]) of its segment
// (start_v = sum of counts[0:v]) are cut into 256-row tiles from the
// segment's start; out[v, f, b, c] = sum over those rows with
// codes_t[f, order[p]] == b of stats_p[p, c].
//
// Bound on the H100.  Bytes: the gathered uint8 codes (m * S), `order`
// (4 S), the stats (4 S C) and the output (4 nodes m B C); the operations
// (m S C additions) are far below the fp32 rate, so the function is bound by
// bytes, about 0.1 ms at the main path's level 0.  This first kernel is
// bound by its instruction count instead: every thread scans every row of
// its tile (see below), 256 compares per row and feature.
//
// Design.  The TPU wrote (m, S/256, B, C) per-tile histograms to HBM (about
// 5 GB at level 0 of the full configuration) and summed them afterwards.
// Here one block owns one (node, feature) histogram and never writes a
// per-tile result: four groups of 256 threads stage four tiles in shared
// memory; in each group thread b owns bin b and sums, in row order, the
// rows of its tile whose code is b; the four tile partials are then folded
// into the node's running sum in tile order.  There are no atomics, global
// or shared, so the summation order is fixed and the result is the same
// bit for bit on every run: the partition's stable order pins it, as the
// deterministic kill+resume of training requires.  Codes are read as uint8.
// A launch handles at most CW channels (from c0); the wrapper launches once
// per window of CW channels.
#include "common.cuh"

namespace {

constexpr int TILE = 256;   // rows per tile, and the largest bin count
constexpr int GROUPS = 4;   // tiles in flight per block
constexpr int CW = 8;       // channels per launch

__global__ void __launch_bounds__(TILE * GROUPS)
hist_nodes_kernel(const uint8_t* __restrict__ codes_t,
                  const int32_t* __restrict__ order,
                  const float* __restrict__ stats_p,
                  const int32_t* __restrict__ counts,
                  const int32_t* __restrict__ build_counts,
                  float* __restrict__ out, int n, int m, int n_bins, int C,
                  int c0, int cw) {
  const int node = blockIdx.x;
  const int f = blockIdx.y;
  const int g = threadIdx.x / TILE;
  const int b = threadIdx.x % TILE;
  __shared__ uint8_t s_code[GROUPS][TILE];
  __shared__ float s_buf[GROUPS][TILE][CW];  // staged stats, then partials
  __shared__ long long s_start;
  if (threadIdx.x == 0) {
    long long start = 0;
    for (int v = 0; v < node; ++v) start += counts[v];
    s_start = start;
  }
  __syncthreads();
  const long long start = s_start;
  const int count = build_counts[node];
  const int n_tiles = (count + TILE - 1) / TILE;
  const uint8_t* col = codes_t + static_cast<long long>(f) * n;

  float node_acc[CW];
#pragma unroll
  for (int c = 0; c < CW; ++c) node_acc[c] = 0.0f;

  for (int t0 = 0; t0 < n_tiles; t0 += GROUPS) {
    const int t = t0 + g;
    const int row0 = t * TILE;
    const int len = t < n_tiles ? min(TILE, count - row0) : 0;
    if (b < len) {
      const long long p = start + row0 + b;
      s_code[g][b] = col[order[p]];
      const float* s = stats_p + p * C + c0;
#pragma unroll
      for (int c = 0; c < CW; ++c) s_buf[g][b][c] = c < cw ? s[c] : 0.0f;
    }
    __syncthreads();

    float acc[CW];
#pragma unroll
    for (int c = 0; c < CW; ++c) acc[c] = 0.0f;
    if (b < n_bins) {
      for (int r = 0; r < len; ++r) {
        if (s_code[g][r] == b) {
#pragma unroll
          for (int c = 0; c < CW; ++c) acc[c] += s_buf[g][r][c];
        }
      }
    }
    __syncthreads();
#pragma unroll
    for (int c = 0; c < CW; ++c) s_buf[g][b][c] = acc[c];
    __syncthreads();
    if (g == 0) {
      const int nt = min(GROUPS, n_tiles - t0);
      for (int j = 0; j < nt; ++j) {
#pragma unroll
        for (int c = 0; c < CW; ++c) node_acc[c] += s_buf[j][b][c];
      }
    }
    __syncthreads();
  }

  if (g == 0 && b < n_bins) {
    float* o = out + ((static_cast<long long>(node) * m + f) * n_bins + b) * C + c0;
#pragma unroll
    for (int c = 0; c < CW; ++c)
      if (c < cw) o[c] = node_acc[c];
  }
}

}  // namespace

extern "C" int hist_nodes_launch(const void* codes_t, const void* order,
                                 const void* stats_p, const void* counts,
                                 const void* build_counts, void* out, int n,
                                 int m, int n_nodes, int n_bins, int C, int c0,
                                 int cw, void* stream) {
  if (n_bins > TILE || cw > CW || cw < 1) return cudaErrorInvalidValue;
  dim3 grid(n_nodes, m);
  hist_nodes_kernel<<<grid, TILE * GROUPS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(codes_t), static_cast<const int32_t*>(order),
      static_cast<const float*>(stats_p), static_cast<const int32_t*>(counts),
      static_cast<const int32_t*>(build_counts), static_cast<float*>(out), n,
      m, n_bins, C, c0, cw);
  return static_cast<int>(cudaGetLastError());
}
