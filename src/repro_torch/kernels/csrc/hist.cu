// B1: per-node gradient histograms of node-contiguous rows.
//
// Replaces the TPU kernel `hist_tiles_pallas` (src/repro/kernels/hist_kernel.py)
// together with the tile->node segment_sum epilogue of
// `ops.histogram_splits_level` (src/repro/kernels/ops.py:247).
//
// Function.  Rows are kept sorted by tree node (`order`, a stable partition),
// and `stats_p` holds each row's statistics in that partition order.  Node
// v contributes the rows [start_v, start_v + build_counts[v]) of its segment
// (start_v = sum of counts[0:v]), cut into tiles of kTileRows rows from the
// segment's start; out[v, f, b, c] = sum over those rows with
// codes_t[f, order[p]] == b of stats_p[p, c], in the order of
// hist_common.cuh: row order within a tile from 0.0f, tiles folded in
// order from 0.0f (the plain version `ref.hist_nodes_ref`).
//
// Bound on the H100.  Bytes: the gathered uint8 codes (m * S), `order`
// (4 S), the stats (4 S C) and the output (4 nodes m B C); the m S C
// additions are far below the fp32 rate, so the function is bound by
// bytes, about 0.04 ms at the main path's level 1.  This kernel is bound by
// latency instead: a block's rows go through one dependent read-modify-write
// of a shared cell per (row, feature, channel) at 3 blocks of 2 warps an SM
// (shared memory holds no more histograms), and each tile's fold waits for
// the tile before it.
//
// Design (hist_common.cuh).  The unit of work is a tile of a node's
// segment, so a node of a million rows spreads over about 60 tiles x the
// groups of (feature, channel) pairs, and every block adds its rows into
// private per-thread histograms, then folds them into the output in tile
// order.  All C channels go in one launch; a block reads its tile's `order`
// and its group's codes and statistics once.  Blocks take tile tickets in
// start order; a ticket is (tile, group) with groups innermost, and warp 0
// maps the tile to its node by a scan over the node counts.
//
// B1-bf16 (`hist_nodes_bf16_launch`) replaces the same TPU kernel with
// `hist_dtype="bfloat16"` (src/repro/kernels/hist_kernel.py:150), whose
// contract is bf16 inputs with float32 accumulation.  It is this kernel body
// instantiated for `__nv_bfloat16` statistics: each value is widened exactly
// with `__bfloat162float` as it is staged, and every sum is the float32 sum
// of B1 in B1's order.  So it is bit for bit fp32 B1 run on the statistics
// rounded to bf16, and it reads half of B1's statistics bytes (2 C bytes a
// row instead of 4 C).  No bf16 tensor-core product: that would change the
// order of the sums, and the tie to fp32 B1 with it.
#include "hist_common.cuh"

namespace {

using namespace hist;

struct Tile {
  int node, k, len;
  long long p0;   // first partition position
};

// Warp 0 finds the node and position of tile `tile` (node-major, each node
// cut into ceil(build_counts[v] / kTileRows) tiles); node -1 if the tile is
// past the last one.
__device__ Tile find_tile(int tile, const int32_t* __restrict__ counts,
                          const int32_t* __restrict__ build_counts,
                          int n_nodes) {
  __shared__ Tile s_tile;
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    if (lane == 0) s_tile.node = -1;
    __syncwarp();
    long long seg = 0;   // rows of the nodes before this round
    int tiles = 0;       // tiles of the nodes before this round
    for (int v0 = 0; v0 < n_nodes; v0 += 32) {
      const int v = v0 + lane;
      const int cnt = v < n_nodes ? counts[v] : 0;
      const int bc = v < n_nodes ? build_counts[v] : 0;
      const int nt = (bc + kTileRows - 1) / kTileRows;
      long long seg_incl = cnt;
      int tiles_incl = nt;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const long long a = __shfl_up_sync(0xffffffffu, seg_incl, o);
        const int b = __shfl_up_sync(0xffffffffu, tiles_incl, o);
        if (lane >= o) {
          seg_incl += a;
          tiles_incl += b;
        }
      }
      const int first = tiles + tiles_incl - nt;
      const bool hit = v < n_nodes && tile >= first && tile < first + nt;
      if (hit) {
        const int k = tile - first;
        s_tile.node = v;
        s_tile.k = k;
        s_tile.len = min(kTileRows, bc - k * kTileRows);
        s_tile.p0 = seg + seg_incl - cnt + static_cast<long long>(k) * kTileRows;
      }
      if (__any_sync(0xffffffffu, hit)) break;
      seg += __shfl_sync(0xffffffffu, seg_incl, 31);
      tiles += __shfl_sync(0xffffffffu, tiles_incl, 31);
    }
  }
  __syncthreads();
  return s_tile;
}

template <typename T>
__global__ void __launch_bounds__(kPairs)
hist_nodes_kernel(const uint8_t* __restrict__ codes_t,
                  const int32_t* __restrict__ order,
                  const T* __restrict__ stats_p,
                  const int32_t* __restrict__ counts,
                  const int32_t* __restrict__ build_counts,
                  float* __restrict__ out, int* __restrict__ scratch, int n,
                  int m, int n_nodes, int n_bins, int C, int G) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int ticket = take_ticket(scratch);
  const Tile tl = find_tile(ticket / G, counts, build_counts, n_nodes);
  if (tl.node < 0) return;
  const int g = ticket % G;
  const Group gr = group_of(g, m, C);
  const Body s = carve_body(smem_raw, C, n_bins);
  const long long p0 = tl.p0;
  tile_body(s, gr, codes_t, n, stats_p, C, n_bins, tl.len,
            [=](int i, int* srow, int* crow) {
              *srow = static_cast<int>(p0) + i;
              *crow = order[p0 + i];
            });
  float* node_out = out + static_cast<long long>(tl.node) * m * n_bins * C;
  fold(s, gr, node_out, n_bins, C,
       scratch + 1 + (static_cast<long long>(tl.node) * G + g) * kSlices, tl.k,
       kSliceBins);
}

template <typename T>
int launch(const void* codes_t, const void* order, const void* stats_p,
           const void* counts, const void* build_counts, void* out,
           void* scratch, int scratch_ints, int n, int s, int m, int n_nodes,
           int n_bins, int C, void* stream) {
  if (n_bins < 2 || n_bins > kMaxBins || C < 1 || m < 1 || n_nodes < 1 ||
      s < 0)
    return cudaErrorInvalidValue;
  const int G = n_groups(m, C);
  if (scratch_ints < 1 + static_cast<long long>(n_nodes) * G * kSlices)
    return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t smem = body_bytes(C, n_bins);
  cudaError_t e = allow_smem(hist_nodes_kernel<T>, smem);
  if (e == cudaSuccess)
    e = cudaMemsetAsync(out, 0, sizeof(float) * n_nodes * m * n_bins *
                                    static_cast<size_t>(C), st);
  if (e == cudaSuccess)
    e = cudaMemsetAsync(scratch, 0, sizeof(int) * static_cast<size_t>(scratch_ints), st);
  if (e != cudaSuccess) return static_cast<int>(e);
  // At most floor(S / R) full tiles plus one partial tile a node.
  const long long tiles = s / kTileRows + n_nodes;
  hist_nodes_kernel<T><<<static_cast<unsigned>(tiles * G), kPairs, smem, st>>>(
      static_cast<const uint8_t*>(codes_t), static_cast<const int32_t*>(order),
      static_cast<const T*>(stats_p), static_cast<const int32_t*>(counts),
      static_cast<const int32_t*>(build_counts), static_cast<float*>(out),
      static_cast<int*>(scratch), n, m, n_nodes, n_bins, C, G);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int hist_nodes_launch(const void* codes_t, const void* order,
                                 const void* stats_p, const void* counts,
                                 const void* build_counts, void* out,
                                 void* scratch, int scratch_ints, int n,
                                 int s, int m, int n_nodes, int n_bins, int C,
                                 void* stream) {
  return launch<float>(codes_t, order, stats_p, counts, build_counts, out,
                       scratch, scratch_ints, n, s, m, n_nodes, n_bins, C,
                       stream);
}

extern "C" int hist_nodes_bf16_launch(const void* codes_t, const void* order,
                                      const void* stats_p, const void* counts,
                                      const void* build_counts, void* out,
                                      void* scratch, int scratch_ints, int n,
                                      int s, int m, int n_nodes, int n_bins,
                                      int C, void* stream) {
  return launch<__nv_bfloat16>(codes_t, order, stats_p, counts, build_counts,
                               out, scratch, scratch_ints, n, s, m, n_nodes,
                               n_bins, C, stream);
}

// The int32 scratch a launch takes: the ticket counter and kSlices fold
// flags a (node, group).
extern "C" int hist_nodes_scratch_ints(int n_nodes, int m, int C) {
  return 1 + n_nodes * n_groups(m, C) * kSlices;
}

// Registers a thread, shared bytes a block and blocks an SM of the fp32
// (bf16 = 0) or bf16 (bf16 = 1) build at C channels and n_bins bins.
extern "C" int hist_nodes_info(int bf16, int C, int n_bins, int* info) {
  const size_t smem = body_bytes(C, n_bins);
  return bf16 ? launch_info(hist_nodes_kernel<__nv_bfloat16>, smem, info)
              : launch_info(hist_nodes_kernel<float>, smem, info);
}
