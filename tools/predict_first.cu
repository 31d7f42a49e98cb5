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
// Bound on the H100.  The function must read F and write it once (8 n D
// bytes: 1.07 GB for 262,144 rows x 512 outputs), read the uint8 codes
// (n M) and the trees (T N (16 + 4 W) bytes for B3, T N (13 + s W) for B5
// with s-byte leaves); its arithmetic (2 or 3 n T W operations) is two
// orders below the fp32 rate, so it is bound by bytes, and F's bytes
// dominate: B5's smaller leaves move little.  A kernel that updates F tree
// by tree in device memory moves 8 n D bytes PER TREE; this one keeps a
// tile of F in shared memory across all trees and moves it once.
//
// Design.  A block owns ROWS rows and a window of at most DC output
// columns, held in shared memory from the first tree to the last.  For each
// tree in index order it stages the node arrays in shared memory (B5's
// uint8 thresholds are widened there, so the forest is never copied), lets
// one thread per row walk the tree, and then adds the leaf block into the
// tile, one thread per element.  The adds use __fmul_rn / __fadd_rn and the
// file builds with -fmad=false: B3 rounds twice (lr * v, then the sum), B5
// three times (float(v) * scale, lr * that, the sum), as the plain versions
// do, so each kernel is bitwise equal to its plain version and B5 to B3 on
// the dequantized forest.  One template serves both; each leaf type is its
// own entry point.
#include <cuda_bf16.h>

#include "common.cuh"

namespace {

constexpr int ROWS = 16;
constexpr int DC = 512;
constexpr int THREADS = 256;

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(int8_t v) { return static_cast<float>(v); }
__device__ __forceinline__ float widen(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename ThrT, typename LeafT, bool kScaled>
__global__ void __launch_bounds__(THREADS)
forest_kernel(float* __restrict__ F, const uint8_t* __restrict__ codes,
              const int32_t* __restrict__ feat, const ThrT* __restrict__ thr,
              const int32_t* __restrict__ left, const int32_t* __restrict__ right,
              const LeafT* __restrict__ leaf, const float* __restrict__ leaf_scale,
              const int32_t* __restrict__ out_col, float lr, int n, int D,
              int M, int T, int N, int W, int depth) {
  extern __shared__ float smem[];
  float* tile = smem;                                   // ROWS x DC
  int32_t* s_feat = reinterpret_cast<int32_t*>(tile + ROWS * DC);
  int32_t* s_thr = s_feat + N;
  int32_t* s_left = s_thr + N;
  int32_t* s_right = s_left + N;
  int32_t* s_pos = s_right + N;                         // ROWS

  const long long r0 = static_cast<long long>(blockIdx.x) * ROWS;
  const int c0 = blockIdx.y * DC;
  const int dc = min(DC, D - c0);
  const int rows = static_cast<int>(min(static_cast<long long>(ROWS), n - r0));
  const int tid = threadIdx.x;

  for (int i = tid; i < rows * dc; i += THREADS) {
    const int r = i / dc, j = i % dc;
    tile[r * DC + j] = F[(r0 + r) * D + c0 + j];
  }
  for (int t = 0; t < T; ++t) {
    __syncthreads();   // the previous tree is done with the staged arrays
    const long long tn = static_cast<long long>(t) * N;
    for (int i = tid; i < N; i += THREADS) {
      s_feat[i] = feat[tn + i];
      s_thr[i] = static_cast<int32_t>(thr[tn + i]);
      s_left[i] = left[tn + i];
      s_right[i] = right[tn + i];
    }
    __syncthreads();
    if (tid < rows) {
      const uint8_t* crow = codes + (r0 + tid) * M;
      int pos = 0;
      for (int s = 0; s < depth; ++s) {
        const int code = crow[s_feat[pos]];
        pos = code > s_thr[pos] ? s_right[pos] : s_left[pos];
      }
      s_pos[tid] = pos;
    }
    __syncthreads();
    const int col = out_col[t];
    const int lo = max(col, c0);
    const int width = min(col + W, c0 + dc) - lo;
    if (width <= 0) continue;
    float scale = 1.0f;
    if constexpr (kScaled) scale = leaf_scale[t];
    for (int i = tid; i < rows * width; i += THREADS) {
      const int r = i / width, j = lo + i % width;
      float v = widen(leaf[(tn + s_pos[r]) * W + (j - col)]);
      if constexpr (kScaled) v = __fmul_rn(v, scale);
      float* a = tile + r * DC + (j - c0);
      *a = __fadd_rn(*a, __fmul_rn(lr, v));
    }
  }
  __syncthreads();
  for (int i = tid; i < rows * dc; i += THREADS) {
    const int r = i / dc, j = i % dc;
    F[(r0 + r) * D + c0 + j] = tile[r * DC + j];
  }
}

template <typename ThrT, typename LeafT, bool kScaled>
int launch(void* F, const void* codes, const void* feat, const void* thr,
           const void* left, const void* right, const void* leaf,
           const void* leaf_scale, const void* out_col, float lr, int n, int D,
           int M, int T, int N, int W, int depth, void* stream) {
  auto kernel = forest_kernel<ThrT, LeafT, kScaled>;
  const size_t smem = sizeof(float) * ROWS * DC + sizeof(int32_t) * (4 * N + ROWS);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  dim3 grid((n + ROWS - 1) / ROWS, (D + DC - 1) / DC);
  kernel<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(F), static_cast<const uint8_t*>(codes),
      static_cast<const int32_t*>(feat), static_cast<const ThrT*>(thr),
      static_cast<const int32_t*>(left), static_cast<const int32_t*>(right),
      static_cast<const LeafT*>(leaf), static_cast<const float*>(leaf_scale),
      static_cast<const int32_t*>(out_col), lr, n, D, M, T, N, W, depth);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// B3: int32 thresholds, float32 leaves.
extern "C" int forest_traverse_launch(void* F, const void* codes,
                                      const void* feat, const void* thr,
                                      const void* left, const void* right,
                                      const void* leaf, const void* out_col,
                                      float lr, int n, int D, int M, int T,
                                      int N, int W, int depth, void* stream) {
  return launch<int32_t, float, false>(F, codes, feat, thr, left, right, leaf,
                                       nullptr, out_col, lr, n, D, M, T, N, W,
                                       depth, stream);
}

// B5: uint8 thresholds, int8 leaves with a per-tree float32 scale.
extern "C" int forest_traverse_quant_int8_launch(
    void* F, const void* codes, const void* feat, const void* thr,
    const void* left, const void* right, const void* leaf,
    const void* leaf_scale, const void* out_col, float lr, int n, int D,
    int M, int T, int N, int W, int depth, void* stream) {
  return launch<uint8_t, int8_t, true>(F, codes, feat, thr, left, right, leaf,
                                       leaf_scale, out_col, lr, n, D, M, T, N,
                                       W, depth, stream);
}

// B5: uint8 thresholds, bfloat16 leaves with a per-tree float32 scale.
extern "C" int forest_traverse_quant_bf16_launch(
    void* F, const void* codes, const void* feat, const void* thr,
    const void* left, const void* right, const void* leaf,
    const void* leaf_scale, const void* out_col, float lr, int n, int D,
    int M, int T, int N, int W, int depth, void* stream) {
  return launch<uint8_t, __nv_bfloat16, true>(F, codes, feat, thr, left, right,
                                              leaf, leaf_scale, out_col, lr, n,
                                              D, M, T, N, W, depth, stream);
}
