// B4: the direct engine's whole-level histograms.
//
// Replaces the TPU kernel `histogram_pallas` / `_hist_kernel`
// (src/repro/kernels/hist_kernel.py:70, :46), reached through
// `ops.histogram` and `ops.histogram_splits` (src/repro/kernels/ops.py:65,
// :122).
//
// Function.  Rows stay in dataset order, cut into chunks of kTileRows rows.
// out[v, f, b, c] is the sum of stats[i, c] over the rows i with
// node_pos[i] == v and codes_t[f, i] == b: within a chunk each cell adds its
// rows one at a time in row order from 0.0f, and the chunks' partial sums
// are added into the cell in chunk order from 0.0f (hist_common.cuh).  The
// plain version `ref.histogram_ref` keeps the same order, so the two agree
// bit for bit, and the result is the same on every run.
//
// Bound on the H100.  Bytes: the codes (m n), node_pos (4 n), the stats
// (4 n C) and the output (4 nodes m B C), about 288 MB at level 5 of the
// paper's configuration, 0.086 ms at 3.35 TB/s; the m n C additions are
// far below the fp32 rate, so the function is bound by bytes.  This kernel
// is bound by its fold instead: each chunk adds a partial of every node it
// holds into the output, about 20 MB a chunk at level 5, read and written
// at L2, by (chunk, node, group) blocks whose bodies take about as long as
// their folds.
//
// Design.  One launch, two kinds of block, by ticket (hist_common.cuh).
// The first n_chunks tickets partition a chunk's rows by node, stably:
// each warp takes a contiguous slice of the chunk and ranks its rows within
// 32-row rounds with __match_any_sync (warps in order, rounds in order), so
// every node's rows keep their row order; the chunk's sorted rows and node
// offsets go to scratch, and a flag says the chunk is ready.  Every later
// ticket is a (chunk, node, group of (feature, channel) pairs) block: it
// waits for its chunk's partition, runs B1's tile body over the node's rows
// of the chunk, and folds the partial into the node's output in chunk
// order.  A block with no rows only passes the node's turn on.  All C
// channels go in one launch.
#include <algorithm>

#include "hist_common.cuh"

namespace {

using namespace hist;

constexpr int kWarps = kPairs / 32;
constexpr int kNodeWindow = 1024;  // nodes partitioned at a time
constexpr int kRoundBatch = 8;     // 32-row rounds loaded at once
constexpr unsigned kFull = 0xffffffffu;

// The partition's shared memory (in the body's place): per-warp node
// counts, then write offsets, and the window's row count.
size_t smem_bytes(int C, int n_bins) {
  const size_t part = sizeof(int) * (kWarps * kNodeWindow + 1);
  return std::max(body_bytes(C, n_bins), part);
}

// Scratch (int32): the ticket counter, a ready flag a chunk, a fold flag a
// (node, group) (B4 folds a node's bins in one slice), then each chunk's
// node offsets (n_nodes + 1) and its rows sorted by node (kTileRows a
// chunk).
struct Scratch {
  int* ticket;
  int* ready;
  int* flags;
  int* offs;
  int* rows;
};

__host__ __device__ inline long long zeroed_ints(long long chunks, int n_nodes,
                                                 int G) {
  return 1 + chunks + static_cast<long long>(n_nodes) * G;
}

__host__ __device__ inline long long scratch_ints(long long chunks, int n_nodes,
                                                  int G) {
  return zeroed_ints(chunks, n_nodes, G) + chunks * (n_nodes + 1) +
         chunks * kTileRows;
}

__device__ inline Scratch carve_scratch(int* base, long long chunks,
                                        int n_nodes, int G) {
  Scratch s;
  s.ticket = base;
  s.ready = base + 1;
  s.flags = s.ready + chunks;
  s.offs = s.flags + static_cast<long long>(n_nodes) * G;
  s.rows = s.offs + chunks * (n_nodes + 1);
  return s;
}

// The window's node of row r of the chunk (rows below hi), or -1.
__device__ __forceinline__ int key_of(const int32_t* __restrict__ node_pos,
                                      long long r0, int r, int hi, int v0,
                                      int nw) {
  if (r >= hi) return -1;
  const int v = node_pos[r0 + r] - v0;
  return v >= 0 && v < nw ? v : -1;
}

// Stable partition of chunk c's rows by node into sc.rows, with its node
// offsets in sc.offs; then the chunk's ready flag.
__device__ void partition_chunk(unsigned char* smem, const Scratch& sc,
                                const int32_t* __restrict__ node_pos,
                                long long n, int n_nodes, int c) {
  int* wcnt_all = reinterpret_cast<int*>(smem);     // [kWarps][kNodeWindow]
  int* total = wcnt_all + kWarps * kNodeWindow;     // the window's rows
  const long long r0 = static_cast<long long>(c) * kTileRows;
  const int len = static_cast<int>(min(static_cast<long long>(kTileRows), n - r0));
  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  const int lo = len * w / kWarps;
  const int hi = len * (w + 1) / kWarps;
  int* wcnt = wcnt_all + w * kNodeWindow;
  int* offs = sc.offs + static_cast<long long>(c) * (n_nodes + 1);
  int* rows = sc.rows + r0;
  int base = 0;   // rows placed for earlier windows
  for (int v0 = 0; v0 < n_nodes; v0 += kNodeWindow) {
    const int nw = min(kNodeWindow, n_nodes - v0);
    for (int i = threadIdx.x; i < kWarps * kNodeWindow; i += kPairs) wcnt_all[i] = 0;
    __syncthreads();
    for (int b = lo; b < hi; b += 32 * kRoundBatch) {
      int key[kRoundBatch];
#pragma unroll
      for (int u = 0; u < kRoundBatch; ++u)
        key[u] = key_of(node_pos, r0, b + u * 32 + lane, hi, v0, nw);
#pragma unroll
      for (int u = 0; u < kRoundBatch; ++u) {
        if (b + u * 32 < hi) {
          const unsigned peers = __match_any_sync(kFull, key[u]);
          if (key[u] >= 0 && lane == __ffs(peers) - 1) wcnt[key[u]] += __popc(peers);
          __syncwarp();
        }
      }
    }
    __syncthreads();
    // Warp 0: each node's first slot, and each warp's first slot within it.
    if (w == 0) {
      int run = 0;
      for (int c0 = 0; c0 < nw; c0 += 32) {
        const int v = c0 + lane;
        int tot = 0;
        if (v < nw) {
          for (int j = 0; j < kWarps; ++j) {
            const int x = wcnt_all[j * kNodeWindow + v];
            wcnt_all[j * kNodeWindow + v] = tot;
            tot += x;
          }
        }
        int incl = tot;
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
          const int y = __shfl_up_sync(kFull, incl, o);
          if (lane >= o) incl += y;
        }
        const int first = base + run + incl - tot;
        if (v < nw) {
          offs[v0 + v] = first;
          for (int j = 0; j < kWarps; ++j) wcnt_all[j * kNodeWindow + v] += first;
        }
        run += __shfl_sync(kFull, incl, 31);
      }
      if (lane == 0) *total = run;
    }
    __syncthreads();
    for (int b = lo; b < hi; b += 32 * kRoundBatch) {
      int key[kRoundBatch];
#pragma unroll
      for (int u = 0; u < kRoundBatch; ++u)
        key[u] = key_of(node_pos, r0, b + u * 32 + lane, hi, v0, nw);
#pragma unroll
      for (int u = 0; u < kRoundBatch; ++u) {
        if (b + u * 32 < hi) {
          const unsigned peers = __match_any_sync(kFull, key[u]);
          if (key[u] >= 0)
            rows[wcnt[key[u]] + __popc(peers & ((1u << lane) - 1u))] =
                static_cast<int>(r0) + b + u * 32 + lane;
          __syncwarp();
          if (key[u] >= 0 && lane == __ffs(peers) - 1) wcnt[key[u]] += __popc(peers);
          __syncwarp();
        }
      }
    }
    base += *total;
    __syncthreads();
  }
  if (threadIdx.x == 0) offs[n_nodes] = base;
  __syncthreads();
  if (threadIdx.x == 0) store_release(sc.ready + c, 1);
}

__global__ void __launch_bounds__(kPairs)
hist_direct_kernel(const uint8_t* __restrict__ codes_t,
                   const int32_t* __restrict__ node_pos,
                   const float* __restrict__ stats, float* __restrict__ out,
                   int* __restrict__ scratch, long long n, int m, int n_nodes,
                   int n_bins, int C, int G, int chunks) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const Scratch sc = carve_scratch(scratch, chunks, n_nodes, G);
  const int ticket = take_ticket(sc.ticket);
  if (ticket < chunks) {
    partition_chunk(smem_raw, sc, node_pos, n, n_nodes, ticket);
    return;
  }
  const long long job = ticket - chunks;
  const int c = static_cast<int>(job / (static_cast<long long>(n_nodes) * G));
  const int v = static_cast<int>(job / G % n_nodes);
  const int g = static_cast<int>(job % G);
  int* flag = sc.flags + static_cast<long long>(v) * G + g;
  wait_turn(sc.ready + c, 1);
  const int* offs = sc.offs + static_cast<long long>(c) * (n_nodes + 1);
  const int beg = __ldcg(offs + v);
  const int cnt = __ldcg(offs + v + 1) - beg;
  if (cnt == 0) {
    pass_turn(flag, c);
    return;
  }
  const Group gr = group_of(g, m, C);
  const Body s = carve_body(smem_raw, C, n_bins);
  const int* rows = sc.rows + static_cast<long long>(c) * kTileRows + beg;
  tile_body(s, gr, codes_t, n, stats, C, n_bins, cnt,
            [=](int i, int* srow, int* crow) {
              *srow = *crow = __ldcg(rows + i);
            });
  fold(s, gr, out + static_cast<long long>(v) * m * n_bins * C, n_bins, C,
       flag, c, n_bins);
}

}  // namespace

extern "C" int hist_direct_launch(const void* codes_t, const void* node_pos,
                                  const void* stats, void* out, void* scratch,
                                  long long scratch_ints_given, long long n,
                                  int m, int n_nodes, int n_bins, int C,
                                  void* stream) {
  if (n_bins < 2 || n_bins > kMaxBins || C < 1 || n_nodes < 1 || m < 1 ||
      n < 0)
    return cudaErrorInvalidValue;
  const int G = n_groups(m, C);
  // One chunk at least, so that an empty level still runs its (empty) turns.
  const long long chunks = n > 0 ? (n + kTileRows - 1) / kTileRows : 1;
  if (scratch_ints_given < scratch_ints(chunks, n_nodes, G))
    return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t smem = smem_bytes(C, n_bins);
  cudaError_t e = allow_smem(hist_direct_kernel, smem);
  if (e == cudaSuccess)
    e = cudaMemsetAsync(out, 0, sizeof(float) * n_nodes * m * n_bins *
                                    static_cast<size_t>(C), st);
  if (e == cudaSuccess)
    e = cudaMemsetAsync(scratch, 0, sizeof(int) * zeroed_ints(chunks, n_nodes, G), st);
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long blocks = chunks * (1 + static_cast<long long>(n_nodes) * G);
  hist_direct_kernel<<<static_cast<unsigned>(blocks), kPairs, smem, st>>>(
      static_cast<const uint8_t*>(codes_t), static_cast<const int32_t*>(node_pos),
      static_cast<const float*>(stats), static_cast<float*>(out),
      static_cast<int*>(scratch), n, m, n_nodes, n_bins, C, G,
      static_cast<int>(chunks));
  return static_cast<int>(cudaGetLastError());
}

// The int32 scratch a launch over n rows takes (see Scratch).
extern "C" int hist_direct_scratch_ints(int n, int m, int n_nodes, int C) {
  const long long chunks = n > 0 ? (n + kTileRows - 1) / kTileRows : 1;
  return static_cast<int>(scratch_ints(chunks, n_nodes, n_groups(m, C)));
}

// Registers a thread, shared bytes a block and blocks an SM at C channels
// and n_bins bins.
extern "C" int hist_direct_info(int C, int n_bins, int* info) {
  return launch_info(hist_direct_kernel, smem_bytes(C, n_bins), info);
}
