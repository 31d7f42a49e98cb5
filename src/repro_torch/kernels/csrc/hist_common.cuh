// Shared by B1 (hist.cu) and B4 (hist_direct.cu): the tile contract, the
// block's share of the (feature, channel) pairs, the per-tile histogram
// body and the ordered fold of tile partials into a node's histogram.
//
// The contract.  Rows are cut into tiles of at most kTileRows rows: B1 cuts
// each node's segment of the partition from its start, B4 cuts the dataset
// order into chunks.  Within a tile each cell (node, feature, bin, channel)
// adds its rows one at a time in row order, starting from 0.0f; the tiles'
// partial sums are then added into the node's cell in tile order, starting
// from 0.0f.  kTileRows is a constant of the contract (the plain versions'
// `ref.TILE_ROWS`), never derived from the card, so the result is the same
// bit for bit on every card and every run.
//
// The body.  A block owns one tile and kPairs (feature, channel) pairs, one
// a thread: up to kGroupChannels channels of several features, so that a
// staged row's statistics serve several features and its codes several
// channels.  Each thread keeps a private float32 histogram of n_bins cells
// in shared memory, laid out [bin][thread], so a warp's 32 histograms lie in
// 32 banks and each (row, pair) is one conflict-free read-modify-write: no
// compare loop over bins, no atomics.  The tile's rows, codes and
// statistics are staged kStage rows at a time, each thread loading whole
// batches before storing any so that many loads are in flight.  A thread
// then walks the staged rows four at a time, loading the four cells before
// storing any (a row whose bin repeats an earlier one of the four takes
// that row's new value instead of the stale load), which keeps four reads in
// flight and the row order of every cell.
//
// The fold.  The tile's partial histogram goes straight into the output,
// in tile order, with no scratch: blocks take tickets in the order they
// start (an atomic counter), and the block of a node's k-th tile adds its
// partial into the node's cells (out = out + partial, out zeroed before the
// launch; each thread its own pair's cells) one slice of bins at a time:
// it waits for the slice's flag to reach k, adds, and sets the flag to
// k + 1, so that B1's next tile folds a slice as soon as this one has left
// it.  A block waits only on blocks with smaller tickets, which have
// started, so every wait ends.  The atomics order the blocks; none touches
// a sum.
#pragma once
#include <cuda_bf16.h>

#include "common.cuh"

namespace hist {

constexpr int kTileRows = 16384;   // rows a tile: ref.TILE_ROWS
constexpr int kPairs = 64;         // (feature, channel) pairs a block
constexpr int kGroupChannels = 8;  // channels a block takes at most
constexpr int kStage = 256;        // rows staged at a time
constexpr int kRowsPerThread = kStage / kPairs;
constexpr int kStride = kStage + 4;  // a staged row of codes or stats, padded
constexpr int kMaxBins = 256;
constexpr int kSliceBins = 64;     // bins a slice of B1's fold
constexpr int kSlices = kMaxBins / kSliceBins;  // fold flags a (node, group)
constexpr int kFoldBatch = 64;     // cells in flight a thread in the fold
constexpr int kCodeBatch = 8;      // features a batch of staged codes

// The block's pairs: features [f0, f0 + nf) x channels [c0, c0 + nc).  With
// C <= kGroupChannels a block takes every channel of kPairs / C features;
// wider, kGroupChannels channels of kPairs / kGroupChannels features, with
// the channel blocks outermost so that blocks running together share the
// tile's statistics in L2.
struct Group {
  int f0, nf, c0, nc;
};

__host__ __device__ inline int group_channels(int C) {
  return C < kGroupChannels ? C : kGroupChannels;
}

__host__ __device__ inline int group_features(int C) {
  return kPairs / group_channels(C);
}

__host__ __device__ inline int n_groups(int m, int C) {
  const int gc = group_channels(C);
  const int gf = group_features(C);
  return ((m + gf - 1) / gf) * ((C + gc - 1) / gc);
}

__device__ inline Group group_of(int g, int m, int C) {
  const int gc = group_channels(C);
  const int gf = group_features(C);
  const int n_fg = (m + gf - 1) / gf;
  Group gr;
  gr.f0 = (g % n_fg) * gf;
  gr.nf = min(gf, m - gr.f0);
  gr.c0 = (g / n_fg) * gc;
  gr.nc = min(gc, C - gr.c0);
  return gr;
}

// Dynamic shared memory of the body: the histograms, then the staged stats
// (channel-major), then the staged codes (feature-major), each staged row
// padded to kStride so that threads of different features or channels read
// different banks.
struct Body {
  float* hist;     // [n_bins][kPairs]
  float* stat;     // [group_channels][kStride]
  uint8_t* code;   // [group_features][kStride]
};

__host__ __device__ inline size_t body_bytes(int C, int n_bins) {
  return sizeof(float) * (static_cast<size_t>(n_bins) * kPairs +
                          static_cast<size_t>(group_channels(C)) * kStride) +
         static_cast<size_t>(group_features(C)) * kStride;
}

__device__ inline Body carve_body(unsigned char* base, int C, int n_bins) {
  Body b;
  b.hist = reinterpret_cast<float*>(base);
  b.stat = b.hist + n_bins * kPairs;
  b.code = reinterpret_cast<uint8_t*>(b.stat + group_channels(C) * kStride);
  return b;
}

// Statistics widen exactly to float32 as they are staged.
__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ inline void zero_hist(const Body& s, int n_bins) {
  float4* h = reinterpret_cast<float4*>(s.hist);
  const float4 z = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  for (int i = threadIdx.x; i < n_bins * kPairs / 4; i += kPairs) h[i] = z;
}

// Stage `len` (<= kStage) rows of the tile from its row `base`.  Thread t
// takes the tile's rows base + t, base + t + kPairs, ...; `rows(i, &srow,
// &crow)` gives the row of `stats` and the column of `codes_t` of the
// tile's i-th row.  A thread loads its rows' statistics in one batch and
// their codes kCodeBatch features at a time, each batch in flight before
// any of it is stored.  Rows len .. len rounded up to 4 are padding:
// statistic +0.0f into bin 0, which changes no cell (a cell that starts
// from +0.0f is never -0.0f).
template <typename T, typename Rows>
__device__ inline void stage(const Body& s, const Group& gr,
                             const uint8_t* __restrict__ codes_t, long long n,
                             const T* __restrict__ stats, int C, int base,
                             int len, Rows rows) {
  const int len4 = (len + 3) & ~3;
  int srow[kRowsPerThread], crow[kRowsPerThread];
#pragma unroll
  for (int j = 0; j < kRowsPerThread; ++j) {
    const int i = threadIdx.x + j * kPairs;
    srow[j] = -1;
    crow[j] = 0;
    if (i < len) rows(base + i, &srow[j], &crow[j]);
  }
  float v[kRowsPerThread][kGroupChannels];
#pragma unroll
  for (int j = 0; j < kRowsPerThread; ++j)
#pragma unroll
    for (int c = 0; c < kGroupChannels; ++c)
      v[j][c] = srow[j] >= 0 && c < gr.nc
                    ? widen(stats[static_cast<long long>(srow[j]) * C + gr.c0 + c])
                    : 0.0f;
#pragma unroll
  for (int j = 0; j < kRowsPerThread; ++j) {
    const int i = threadIdx.x + j * kPairs;
    if (i < len4) {
#pragma unroll
      for (int c = 0; c < kGroupChannels; ++c)
        if (c < gr.nc) s.stat[c * kStride + i] = v[j][c];
    }
  }
  for (int f0 = 0; f0 < gr.nf; f0 += kCodeBatch) {
    uint8_t b[kCodeBatch][kRowsPerThread];
#pragma unroll
    for (int f = 0; f < kCodeBatch; ++f)
#pragma unroll
      for (int j = 0; j < kRowsPerThread; ++j)
        b[f][j] = srow[j] >= 0 && f0 + f < gr.nf
                      ? codes_t[static_cast<long long>(gr.f0 + f0 + f) * n + crow[j]]
                      : 0;
#pragma unroll
    for (int f = 0; f < kCodeBatch; ++f)
#pragma unroll
      for (int j = 0; j < kRowsPerThread; ++j) {
        const int i = threadIdx.x + j * kPairs;
        if (f0 + f < gr.nf && i < len4) s.code[(f0 + f) * kStride + i] = b[f][j];
      }
  }
}

// Add the staged rows into the thread's histogram, in row order.  The
// next four rows' codes and stats are read before this four's cells are
// written, so that their reads need not wait for the writes.
__device__ inline void accumulate(const Body& s, const Group& gr, int len) {
  const int t = threadIdx.x;
  if (t >= gr.nf * gr.nc) return;
  const int f = t / gr.nc;
  const int c = t - f * gr.nc;
  const uint32_t* code = reinterpret_cast<const uint32_t*>(s.code + f * kStride);
  const float4* st = reinterpret_cast<const float4*>(s.stat + c * kStride);
  float* h = s.hist + t;
  const int quads = (len + 3) >> 2;
  uint32_t w = code[0];
  float4 x = st[0];
  for (int q = 0; q < quads; ++q) {
    // One past the last quad reads the row padding: unused.
    const uint32_t w_next = code[q + 1];
    const float4 x_next = st[q + 1];
    const int b0 = (w & 0xff) * kPairs;
    const int b1 = ((w >> 8) & 0xff) * kPairs;
    const int b2 = ((w >> 16) & 0xff) * kPairs;
    const int b3 = (w >> 24) * kPairs;
    const float h0 = h[b0], h1 = h[b1], h2 = h[b2], h3 = h[b3];
    const float v0 = __fadd_rn(h0, x.x);
    const float v1 = __fadd_rn(b1 == b0 ? v0 : h1, x.y);
    const float v2 = __fadd_rn(b2 == b1 ? v1 : (b2 == b0 ? v0 : h2), x.z);
    const float v3 = __fadd_rn(
        b3 == b2 ? v2 : (b3 == b1 ? v1 : (b3 == b0 ? v0 : h3)), x.w);
    h[b0] = v0;
    h[b1] = v1;
    h[b2] = v2;
    h[b3] = v3;
    w = w_next;
    x = x_next;
  }
}

// Zero the histograms, then stage and add the tile's `len` rows, kStage at
// a time.  Ends with each thread's last rows added, before any barrier.
template <typename T, typename Rows>
__device__ inline void tile_body(const Body& s, const Group& gr,
                                 const uint8_t* __restrict__ codes_t,
                                 long long n, const T* __restrict__ stats,
                                 int C, int n_bins, int len, Rows rows) {
  zero_hist(s, n_bins);
  for (int off = 0; off < len; off += kStage) {
    const int sub = min(kStage, len - off);
    __syncthreads();
    stage(s, gr, codes_t, n, stats, C, off, sub, rows);
    __syncthreads();
    accumulate(s, gr, sub);
  }
}

__device__ __forceinline__ int load_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.s32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void store_release(int* p, int v) {
  asm volatile("st.release.gpu.global.s32 [%0], %1;" :: "l"(p), "r"(v) : "memory");
}

// Spin until the flag reaches k.  Every wait ends (see the fold above), so
// one that outlasts about ten seconds is a fault: trap, and the launch
// fails instead of hanging the card.
__device__ inline void spin_until(const int* flag, int k) {
  for (long long i = 0; load_acquire(flag) < k; ++i) {
    if (i > (1LL << 24)) __trap();
    __nanosleep(64);
  }
}

// Thread 0 waits until the flag reaches k, then the block goes on together.
__device__ inline void wait_turn(const int* flag, int k) {
  if (threadIdx.x == 0) spin_until(flag, k);
  __syncthreads();
}

// The block's turn in the node's fold, `slice_bins` bins at a time: for
// slice j, wait until flags[j] reaches k, add the slice into the node's
// cells (`node_out` = &out[v, 0, 0, 0]; each thread its own pair's cells,
// kFoldBatch bins in flight), and move flags[j] to k + 1 once the whole
// block has written it (a barrier, then a release store: the pattern of a
// serial split-K reduction).  Cells are read and written at L2 (__ldcg,
// __stcg), past any stale L1 line.
__device__ inline void fold(const Body& s, const Group& gr,
                            float* __restrict__ node_out, int n_bins, int C,
                            int* flags, int k, int slice_bins) {
  const int t = threadIdx.x;
  const bool mine = t < gr.nf * gr.nc;
  const int f = mine ? t / gr.nc : 0;
  const int c = t - f * gr.nc;
  float* o = node_out + static_cast<long long>(gr.f0 + f) * n_bins * C + gr.c0 + c;
  const float* h = s.hist + t;
  for (int b0 = 0, j = 0; b0 < n_bins; b0 += slice_bins, ++j) {
    wait_turn(flags + j, k);
    const int b1 = min(n_bins, b0 + slice_bins);
    for (int bb = b0; mine && bb < b1; bb += kFoldBatch) {
      float run[kFoldBatch];
#pragma unroll
      for (int u = 0; u < kFoldBatch; ++u)
        if (bb + u < b1) run[u] = __ldcg(o + static_cast<long long>(bb + u) * C);
#pragma unroll
      for (int u = 0; u < kFoldBatch; ++u)
        if (bb + u < b1)
          __stcg(o + static_cast<long long>(bb + u) * C,
                 __fadd_rn(run[u], h[(bb + u) * kPairs]));
    }
    __syncthreads();
    if (t == 0) store_release(flags + j, k + 1);
  }
}

// A turn with nothing to add (B4: no row of the node in this chunk); B4
// folds in one slice, so one flag.
__device__ inline void pass_turn(int* flag, int k) {
  if (threadIdx.x == 0) {
    spin_until(flag, k);
    store_release(flag, k + 1);
  }
}

// The block's ticket: blocks take them in the order they start.
__device__ inline int take_ticket(int* counter) {
  __shared__ int s_ticket;
  if (threadIdx.x == 0) s_ticket = atomicAdd(counter, 1);
  __syncthreads();
  return s_ticket;
}

template <typename K>
inline cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

// What a build gives one launch: registers a thread, shared bytes a block
// (static + dynamic), blocks resident an SM.
template <typename K>
inline int launch_info(K kernel, size_t dyn_bytes, int* info) {
  cudaFuncAttributes a;
  cudaError_t e = cudaFuncGetAttributes(&a, kernel);
  if (e == cudaSuccess) e = allow_smem(kernel, dyn_bytes);
  int blocks = 0;
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, kPairs,
                                                      dyn_bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  info[0] = a.numRegs;
  info[1] = static_cast<int>(a.sharedSizeBytes + dyn_bytes);
  info[2] = blocks;
  return 0;
}

}  // namespace hist
