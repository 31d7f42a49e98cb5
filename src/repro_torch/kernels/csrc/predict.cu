// B3 and B5: packed-forest traversal, F[:, out_col_t : out_col_t + W] += lr * leaf.
//
// B3 replaces the TPU kernel `forest_traverse_pallas`, B5 the TPU kernel
// `forest_traverse_quant_pallas` (both src/repro/kernels/predict_kernel.py).
//
// Function.  Trees in the pointer layout of `PackedForest`: per tree t and
// node i, feat/thr/left/right (terminal nodes self-loop) and a leaf block
// leaf[t, i, 0:W].  Every row walks every tree for `depth` steps (go right
// iff code > thr) and adds lr * leaf[t, pos] at columns [out_col[t],
// out_col[t] + W) of F, tree after tree in index order.  B3 stores int32
// thresholds and float32 leaves.  B5 stores uint8 thresholds (bin codes, so
// the walk takes the same branches) and int8 or bfloat16 leaves with a
// per-tree float32 scale: the added value is lr * (float(leaf) * scale[t]).
//
// What bounds it on the H100.  Bytes, in two regimes (its 2 or 3 n T W
// operations outlast the bytes only for B5's small leaves at a few
// thousand rows of many trees: 9.4 us at the fp32 rate for 4,096 rows of
// 100 trees at W = 512):
//  - large n, few trees (predict, the fit's eval): F read and written once,
//    8 n D bytes (1.07 GB for 262,144 rows x 512 outputs).  What threatens
//    that bound is the leaf gathers, n T W s bytes through L2 (4.3 GB for 8
//    trees at that shape), and re-walking the trees;
//  - small n, many trees (a 256-row serving window of a 100-tree model):
//    the forest's bytes, T N (16 + s W), read once (26 MB in float32), and
//    the latency of T walks of `depth` dependent steps each.  A design
//    that walks the trees one after another in one block pays T times that
//    chain; one that gives a window few blocks leaves most of the card idle.
//
// Design.  A block owns a tile of kRows rows x kCols columns of F (a
// compile-time tile, listed in PREDICT_TILES; `dispatch` picks one per
// call from n, D and the card's SM count):
//  - F in registers.  Each of the 256 threads owns fixed vectors of kVec
//    columns of the tile, loads them once, adds every tree into them in
//    index order and stores them once.  There is no F tile in shared
//    memory, so several blocks fit on an SM.
//  - Walk apart from add.  The block stages its rows' codes in shared
//    memory once, in 16-byte words, the partial words at either end byte
//    by byte (rows x M bytes; read from device memory where they would not
//    fit).  Trees go in groups of kGroup: one thread
//    per (row, tree) walks the group at once, reading the node arrays
//    through the read-only cache (__ldg: one small forest is shared by
//    every block) and its row's codes from shared memory, and writes the
//    leaf's index to shared memory (int32, so any N).  Then each thread
//    adds the group's leaves into its vectors, tree after tree, the loads
//    of several trees in flight (they are independent once the positions
//    are known).  The positions are double-buffered: the walk of the next
//    group runs beside the adds of this one, with one barrier a group.
//  - Vectors.  Where a tree's window starts on a whole vector (W and
//    out_col multiples of kVec, the leaves aligned), a thread loads kVec
//    leaf values in one instruction (16 bytes of float32, 8 of bf16, 4 of
//    int8); F likewise where D is a multiple of kVec.  Elsewhere (the
//    one-vs-all layout, W = 1) it goes element by element.  The leaf
//    gathers are instruction-bound without them: per element a load, its
//    address and its tests against two or three arithmetic instructions.
//  - Trees that miss the tile.  The block first lists, in index order, the
//    trees whose [out_col, out_col + W) meets its columns (a ballot over
//    256 trees at a time), and walks and adds only those: a one-vs-all
//    forest (W = 1) costs a column tile only its own trees.
//  - A grid that fills the card.  The grid is (row tiles, column tiles),
//    row tiles fastest.  Both tiles are 8 rows with groups of 32 trees.
//    A call takes the widest tile whose grid still gives every SM two
//    blocks and whose columns D fills at least half of, else the narrowest:
//    a 256-row serving window at D = 512 takes the 64-column tile (256
//    blocks on 132 SMs), large batches the 512-column one, which walks each
//    (row, tree) once.  The narrow tile walks the rows again in each column tile:
//    T rows depth steps a tile against T rows kCols adds.  The wide tile's
//    registers are capped for 6 blocks an SM (the large shapes are bound
//    by latency, and occupancy hides it).
// The adds use __fmul_rn / __fadd_rn and the file builds with -fmad=false:
// B3 rounds twice (lr * v, then the sum), B5 three times (float(v) *
// scale, lr * that, the sum), as the plain versions do, and each element
// takes its trees in index order, so each kernel is bitwise equal to its
// plain version and B5 to B3 on the dequantized forest.  No atomics: an
// element belongs to one thread.  One template serves all three entry
// points.
#include <cuda_bf16.h>

#include <atomic>
#include <cstring>

#include "common.cuh"

// The tiles built, as TILE(rows, columns, tree group, columns a vector,
// blocks an SM the build must fit), narrowest first.
#ifndef PREDICT_TILES
#define PREDICT_TILES TILE(8, 64, 32, 2, 1) TILE(8, 512, 32, 4, 6)
#endif

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

struct Args {
  float* F;
  const uint8_t* codes;
  const int32_t* feat;
  const void* thr;
  const int32_t* left;
  const int32_t* right;
  const void* leaf;
  const float* leaf_scale;
  const int32_t* out_col;
  float lr;
  int n, D, M, T, N, W, depth;
  int flags;   // kStageCodes | kVecF | kVecLeaf, set by `dispatch`
};

// What `dispatch` found: the rows' codes fit a block's shared memory; F's
// rows, and the leaf rows, start on whole vectors of the tile.
constexpr int kStageCodes = 1, kVecF = 2, kVecLeaf = 4;
// The rows' codes are staged in shared memory up to this size.
constexpr size_t kCodesSmemMax = 48 * 1024;

// Loads and stores of V elements as one word.
template <int kBytes> struct Word;
template <> struct Word<1> { using T = unsigned char; };
template <> struct Word<2> { using T = unsigned short; };
template <> struct Word<4> { using T = unsigned int; };
template <> struct Word<8> { using T = uint2; };
template <> struct Word<16> { using T = uint4; };

template <int V, typename E>
__device__ __forceinline__ void load_leaves(const E* p, E (&out)[V]) {
  using Wd = typename Word<sizeof(E) * V>::T;
  const Wd w = __ldg(reinterpret_cast<const Wd*>(p));
  memcpy(out, &w, sizeof(Wd));
}
template <int V>
__device__ __forceinline__ void load_f(const float* p, float (&out)[V]) {
  using Wd = typename Word<4 * V>::T;
  const Wd w = *reinterpret_cast<const Wd*>(p);
  memcpy(out, &w, sizeof(Wd));
}
template <int V>
__device__ __forceinline__ void store_f(float* p, const float (&in)[V]) {
  using Wd = typename Word<4 * V>::T;
  Wd w;
  memcpy(&w, in, sizeof(Wd));
  *reinterpret_cast<Wd*>(p) = w;
}

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(int8_t v) { return static_cast<float>(v); }
__device__ __forceinline__ float widen(__nv_bfloat16 v) { return __bfloat162float(v); }

// Dynamic shared memory of a block: the positions of two tree groups, then
// the rows' codes when staged, copied in 16-byte words from the one below
// their first byte (so one word more).
__host__ __device__ constexpr size_t pos_bytes(int rows, int group) {
  return sizeof(int32_t) * 2 * rows * group;
}
__host__ __device__ constexpr size_t codes_bytes(int rows, int M) {
  return 16 * ((static_cast<size_t>(rows) * M + 15) / 16 + 1);
}

template <int kRows, int kCols, int kGroup, int kVec, int kMinBlocks,
          typename ThrT, typename LeafT, bool kScaled>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
forest_kernel(const Args a) {
  constexpr int kRowVecs = kCols / kVec;
  static_assert(kCols % kVec == 0 && kRows * kRowVecs % kThreads == 0,
                "whole vectors a thread");
  static_assert(kRows * kGroup % 2 == 0, "the codes start on 16 bytes");
  constexpr int kPer = kRows * kRowVecs / kThreads;   // vectors a thread
  // Trees unrolled in the adds: about 16 leaf loads in flight a thread.
  constexpr int kUnroll = kPer >= 16 ? 1 : 16 / kPer;
  extern __shared__ __align__(16) uint8_t smem[];
  int32_t* s_pos = reinterpret_cast<int32_t*>(smem);   // 2 x kGroup x kRows
  uint8_t* s_codes = smem + pos_bytes(kRows, kGroup);   // kRows x M
  __shared__ int32_t s_tree[kThreads];                  // the trees listed
  __shared__ int32_t s_col[kThreads];
  __shared__ float s_scale[kScaled ? kThreads : 1];
  __shared__ int32_t s_warp[kWarps];

  const ThrT* thr = static_cast<const ThrT*>(a.thr);
  const LeafT* leaf = static_cast<const LeafT*>(a.leaf);
  const long long r0 = static_cast<long long>(blockIdx.x) * kRows;
  const int c0 = blockIdx.y * kCols;
  const int rows = static_cast<int>(min(static_cast<long long>(kRows), a.n - r0));
  const int cols = min(kCols, a.D - c0);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long N = a.N;
  const int M = a.M, W = a.W;

  // The rows' codes: the 16-byte words from the aligned one at or below
  // their first byte up to the one holding their last, one load a thread
  // in flight; a word that reaches past either end is copied byte by byte,
  // so that no read leaves the codes.
  const uint8_t* cbase = a.codes + r0 * M;
  if (a.flags & kStageCodes) {
    const uintptr_t first = reinterpret_cast<uintptr_t>(cbase);
    const uintptr_t end = first + static_cast<uintptr_t>(rows) * M;
    const uintptr_t word0 = first & ~static_cast<uintptr_t>(15);
    const int words = static_cast<int>((end - word0 + 15) / 16);
    for (int i = tid; i < words; i += kThreads) {
      const uintptr_t lo = word0 + 16 * static_cast<uintptr_t>(i);
      if (lo >= first && lo + 16 <= end) {
        reinterpret_cast<uint4*>(s_codes)[i] =
            __ldg(reinterpret_cast<const uint4*>(lo));
      } else {
        for (int b = 0; b < 16; ++b)
          if (lo + b >= first && lo + b < end)
            s_codes[16 * i + b] = __ldg(reinterpret_cast<const uint8_t*>(lo + b));
      }
    }
    cbase = s_codes + (first - word0);
  }

  // Thread tid owns vectors tid + k kThreads of the tile: row r, columns
  // [c, c + kVec).  A warp covers consecutive vectors of a row.
  const bool vec_f = a.flags & kVecF;
  float acc[kPer][kVec];
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int q = tid + k * kThreads, r = q / kRowVecs, c = q % kRowVecs * kVec;
    const float* f = a.F + (r0 + r) * a.D + c0 + c;
    if (vec_f && r < rows && c < cols) {
      load_f<kVec>(f, acc[k]);
    } else {
#pragma unroll
      for (int v = 0; v < kVec; ++v)
        acc[k][v] = (r < rows && c + v < cols) ? f[v] : 0.0f;
    }
  }

  // One thread per (row, tree) of group g walks into buffer `buf`.
  auto walk = [&](int g, int count, int buf) {
    const int size = min(kGroup, count - g) * kRows;
    for (int p = tid; p < size; p += kThreads) {
      const int j = p / kRows, r = p % kRows;
      if (r >= rows) continue;
      const long long tn = s_tree[g + j] * N;
      const uint8_t* crow = cbase + r * M;
      int pos = 0;
      for (int s = 0; s < a.depth; ++s) {
        const long long i = tn + pos;
        const int f = __ldg(a.feat + i);
        const int th = static_cast<int>(__ldg(thr + i));
        const int lf = __ldg(a.left + i), rt = __ldg(a.right + i);
        pos = static_cast<int>(crow[f]) > th ? rt : lf;
      }
      s_pos[buf * kGroup * kRows + p] = pos;
    }
  };
  // Every thread adds group g's leaves into its elements, tree by tree:
  // a vector at once where the tree's window starts on a whole vector
  // (then a vector lies all in it or all out), else element by element.
  auto add_one = [&](float& acc_v, LeafT x, float scale) {
    float v = widen(x);
    if constexpr (kScaled) v = __fmul_rn(v, scale);
    acc_v = __fadd_rn(acc_v, __fmul_rn(a.lr, v));
  };
  const bool vec_leaf = a.flags & kVecLeaf;
  auto add = [&](int g, int count, int buf) {
    const int size = min(kGroup, count - g);
    const int32_t* pos = s_pos + buf * kGroup * kRows;
#pragma unroll (kUnroll)
    for (int j = 0; j < size; ++j) {
      const long long tn = s_tree[g + j] * N;
      const int col = s_col[g + j];
      float scale = 1.0f;
      if constexpr (kScaled) scale = s_scale[g + j];
      const bool whole = vec_leaf && col % kVec == 0;
#pragma unroll
      for (int k = 0; k < kPer; ++k) {
        const int q = tid + k * kThreads, r = q / kRowVecs;
        const int c = q % kRowVecs * kVec, j_col = c0 + c - col;
        if (r >= rows) continue;
        const LeafT* lp = leaf + (tn + pos[j * kRows + r]) * W;
        if (whole) {
          if (c < cols && j_col >= 0 && j_col < W) {
            LeafT x[kVec];
            load_leaves<kVec>(lp + j_col, x);
#pragma unroll
            for (int v = 0; v < kVec; ++v) add_one(acc[k][v], x[v], scale);
          }
        } else {
#pragma unroll
          for (int v = 0; v < kVec; ++v)
            if (c + v < cols && j_col + v >= 0 && j_col + v < W)
              add_one(acc[k][v], __ldg(lp + j_col + v), scale);
        }
      }
    }
  };

  for (int base = 0; base < a.T; base += kThreads) {
    // List this chunk's trees that meet the tile's columns, in index order.
    const int t = base + tid;
    int col = 0;
    bool hit = false;
    if (t < a.T) {
      col = a.out_col[t];
      hit = col < c0 + cols && col + W > c0;
    }
    const unsigned ballot = __ballot_sync(0xffffffffu, hit);
    if (lane == 0) s_warp[warp] = __popc(ballot);
    __syncthreads();   // also: the codes are staged
    int count = 0, at = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      at += w < warp ? s_warp[w] : 0;
      count += s_warp[w];
    }
    if (hit) {
      const int i = at + __popc(ballot & ((1u << lane) - 1u));
      s_tree[i] = t;
      s_col[i] = col;
      if constexpr (kScaled) s_scale[i] = a.leaf_scale[t];
    }
    __syncthreads();
    if (count == 0) continue;
    walk(0, count, 0);
    __syncthreads();
    for (int g = 0, buf = 0; g < count; g += kGroup, buf ^= 1) {
      if (g + kGroup < count) walk(g + kGroup, count, buf ^ 1);
      add(g, count, buf);
      __syncthreads();   // group g's positions and the list are free again
    }
  }

#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int q = tid + k * kThreads, r = q / kRowVecs, c = q % kRowVecs * kVec;
    float* f = a.F + (r0 + r) * a.D + c0 + c;
    if (vec_f && r < rows && c < cols) {
      store_f<kVec>(f, acc[k]);
    } else {
#pragma unroll
      for (int v = 0; v < kVec; ++v)
        if (r < rows && c + v < cols) f[v] = acc[k][v];
    }
  }
}

// Launch one tile's kernel, or with `info` report what its build gives a
// launch: registers a thread, shared bytes a block (static + dynamic),
// blocks resident an SM.
template <int kRows, int kCols, int kGroup, int kVec, int kMinBlocks,
          typename ThrT, typename LeafT, bool kScaled>
int run(const Args& a, cudaStream_t stream, int* info) {
  auto kernel = forest_kernel<kRows, kCols, kGroup, kVec, kMinBlocks, ThrT,
                              LeafT, kScaled>;
  const size_t smem = pos_bytes(kRows, kGroup) +
                      ((a.flags & kStageCodes) ? codes_bytes(kRows, a.M) : 0);
  cudaError_t e = cudaSuccess;
  // Above 48 KB with the static arrays (at most 3.1 KB) only by opting in.
  if (smem + 4096 > 48 * 1024)
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  if (info != nullptr) {
    cudaFuncAttributes attr{};
    int blocks = 0;
    e = cudaFuncGetAttributes(&attr, kernel);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel,
                                                        kThreads, smem);
    info[0] = attr.numRegs;
    info[1] = static_cast<int>(attr.sharedSizeBytes + smem);
    info[2] = blocks;
    info[3] = static_cast<int>(attr.localSizeBytes);
    return static_cast<int>(e);
  }
  dim3 grid((a.n + kRows - 1) / kRows, (a.D + kCols - 1) / kCols);
  kernel<<<grid, kThreads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

struct Tile { int rows, cols, group, vec; };
#define TILE(R, C, G, V, B) Tile{R, C, G, V},
constexpr Tile kTiles[] = {PREDICT_TILES};
#undef TILE
constexpr int kNumTiles = sizeof(kTiles) / sizeof(kTiles[0]);

// SMs of the current card, read once a card.
cudaError_t sm_count(int* out) {
  constexpr int kMaxCards = 64;
  static std::atomic<int> cached[kMaxCards];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  int sms = dev < kMaxCards ? cached[dev].load(std::memory_order_relaxed) : 0;
  if (sms == 0) {
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return e;
    if (dev < kMaxCards) cached[dev].store(sms, std::memory_order_relaxed);
  }
  *out = sms;
  return cudaSuccess;
}

// The tile of a call: the widest whose grid still gives every SM two
// blocks and whose columns D fills at least half of, else the narrowest.
// A wider tile walks the trees for fewer column tiles; a 256-row serving
// window needs the narrow one to fill the card.  No tile changes a bit of
// the result: each element adds its trees in index order.
int pick_tile(long long n, int D, int sms) {
  int best = 0;
  for (int i = 1; i < kNumTiles; ++i) {
    const Tile& t = kTiles[i];
    const long long blocks =
        (n + t.rows - 1) / t.rows * ((D + t.cols - 1) / t.cols);
    if (blocks >= 2LL * sms && t.cols <= 2 * D) best = i;
  }
  return best;
}

template <typename LeafT>
int launch_flags(const Args& a, const Tile& t) {
  const auto aligned = [](const void* p, size_t bytes) {
    return reinterpret_cast<uintptr_t>(p) % bytes == 0;
  };
  return (codes_bytes(t.rows, a.M) <= kCodesSmemMax ? kStageCodes : 0) |
         (a.D % t.vec == 0 && aligned(a.F, 4 * t.vec) ? kVecF : 0) |
         (a.W % t.vec == 0 && aligned(a.leaf, sizeof(LeafT) * t.vec)
              ? kVecLeaf : 0);
}

// Pick the tile and the flags, then launch, or with `info` report the
// build (`run`) and the tile: info[4..7] rows, columns, tree group and
// columns a vector, info[8] 1 where the codes are staged.
template <typename ThrT, typename LeafT, bool kScaled>
int dispatch(Args a, void* stream, int* info) {
  int sms = 0;
  const cudaError_t e = sm_count(&sms);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int pick = pick_tile(a.n, a.D, sms);
  const Tile& t = kTiles[pick];
  a.flags = launch_flags<LeafT>(a, t);
  if (info != nullptr) {
    info[4] = t.rows;
    info[5] = t.cols;
    info[6] = t.group;
    info[7] = t.vec;
    info[8] = a.flags & kStageCodes ? 1 : 0;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int k = 0;
#define TILE(R, C, G, V, B)                                      \
  if (pick == k)                                                 \
    return run<R, C, G, V, B, ThrT, LeafT, kScaled>(a, s, info); \
  ++k;
  PREDICT_TILES
#undef TILE
  return static_cast<int>(cudaErrorInvalidValue);
}

Args make_args(void* F, const void* codes, const void* feat, const void* thr,
               const void* left, const void* right, const void* leaf,
               const void* leaf_scale, const void* out_col, float lr, int n,
               int D, int M, int T, int N, int W, int depth) {
  return Args{static_cast<float*>(F), static_cast<const uint8_t*>(codes),
              static_cast<const int32_t*>(feat), thr,
              static_cast<const int32_t*>(left),
              static_cast<const int32_t*>(right), leaf,
              static_cast<const float*>(leaf_scale),
              static_cast<const int32_t*>(out_col), lr, n, D, M, T, N, W,
              depth, 0};
}

}  // namespace

// B3: int32 thresholds, float32 leaves.
extern "C" int forest_traverse_launch(
    void* F, const void* codes, const void* feat, const void* thr,
    const void* left, const void* right, const void* leaf, const void* out_col,
    float lr, int n, int D, int M, int T, int N, int W, int depth,
    void* stream) {
  return dispatch<int32_t, float, false>(
      make_args(F, codes, feat, thr, left, right, leaf, nullptr, out_col, lr,
                n, D, M, T, N, W, depth),
      stream, nullptr);
}

// B5: uint8 thresholds, int8 leaves with a per-tree float32 scale.
extern "C" int forest_traverse_quant_int8_launch(
    void* F, const void* codes, const void* feat, const void* thr,
    const void* left, const void* right, const void* leaf,
    const void* leaf_scale, const void* out_col, float lr, int n, int D,
    int M, int T, int N, int W, int depth, void* stream) {
  return dispatch<uint8_t, int8_t, true>(
      make_args(F, codes, feat, thr, left, right, leaf, leaf_scale, out_col,
                lr, n, D, M, T, N, W, depth),
      stream, nullptr);
}

// B5: uint8 thresholds, bfloat16 leaves with a per-tree float32 scale.
extern "C" int forest_traverse_quant_bf16_launch(
    void* F, const void* codes, const void* feat, const void* thr,
    const void* left, const void* right, const void* leaf,
    const void* leaf_scale, const void* out_col, float lr, int n, int D,
    int M, int T, int N, int W, int depth, void* stream) {
  return dispatch<uint8_t, __nv_bfloat16, true>(
      make_args(F, codes, feat, thr, left, right, leaf, leaf_scale, out_col,
                lr, n, D, M, T, N, W, depth),
      stream, nullptr);
}

// What a launch of one entry point (0 B3, 1 B5 int8, 2 B5 bf16) at F (n,
// D) with M codes a row takes on the current card: info[0] registers a
// thread, info[1] shared bytes a block, info[2] blocks an SM, info[3] local
// (spill) bytes a thread of the tile's build; info[4..8] the tile and
// whether the codes are staged (`dispatch`).  Launches nothing.
extern "C" int forest_traverse_info(int kind, int n, int D, int M,
                                    int* info) {
  Args a{};
  a.n = n;
  a.D = D;
  a.M = M;
  if (kind == 0) return dispatch<int32_t, float, false>(a, nullptr, info);
  if (kind == 1) return dispatch<uint8_t, int8_t, true>(a, nullptr, info);
  return dispatch<uint8_t, __nv_bfloat16, true>(a, nullptr, info);
}
