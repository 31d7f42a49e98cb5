// B6: path-dependent multioutput TreeSHAP over the path slots of a forest.
//
// Replaces the TPU kernel `shap_pallas` (src/repro/kernels/shap_kernel.py).
//
// Function.  A forest comes as per-(tree t, path l, slot s) tables from
// `explain.paths.build_path_pack`: a slot's feature sf (-1 on padding), its
// bin interval lo < code <= hi, its zero-fraction z, and per path a leaf
// block leaf[t, l, 0:W] placed at output columns [out_col[t], out_col[t] + W).
// For every row and tree, in tree order:
//   o_s = lo < code[max(sf, 0)] <= hi,  a_ls = (o_s - z_s) * Psi_s
// with Psi the division-free EXTEND/UNWIND sums of `ref.path_unwind_psis`,
//   res[f, c] = sum over paths l, ascending, of a_l(f) * leaf[t, l, c]
// (a_l(f): the slots of path l on feature f, summed in slot order), and
//   phi[row, f, out_col + c] = phi + lr * res[f, c].
//
// Bound on the H100.  The function writes phi once (4 n M d bytes: 839 MB for
// 4,096 rows x 100 features x 512 outputs) and reads the codes and the
// tables; its arithmetic is 2 n W per real (path, slot) of each tree for the
// scatter-contraction plus O(D^2) per (row, path) for Psi.  At the main
// path's shape (8 depth-6 trees, L = 64, D = 6) the bytes of phi set the
// bound; with many trees the scatter's operations do.  The TPU kernel did
// the scatter as a dense (rows * M, L) x (L, W) product in which all but <= D
// entries of each path are zero; here only the real slots are touched.
//
// Design.  A block owns one row and a chunk of `ch` output columns, one
// column a thread, and keeps phi[row, :, chunk] in shared memory from the
// first tree to the last, so phi is written to device memory once and no
// two threads ever add into the same element (no atomics: the same bits run
// to run).  For each tree whose block overlaps the chunk, the first L threads
// compute the factors a_ls of one path each, then each thread sums its column
// of res over the paths in ascending order into a second shared tile and
// folds it into phi for the features this tree uses.  A path's kept slots
// are distinct features, so its D updates of res are independent: they are
// loaded, added and stored together, and only path after path waits on
// shared memory; leaf values are loaded LB paths at a time.  The kernel is
// compiled for each path depth D from 1 to KMAX, so the polynomial
// coefficients and a path's updates live in registers; deeper paths (up to
// MAXD slots) take a build with per-thread local arrays.  Every product and
// sum rounds once, in the plain version's order (__fmul_rn / __fadd_rn,
// -fmad=false), so the kernel is bitwise equal to `ref.tree_shap_ref`.  The
// chunk width is the largest multiple of 32 (at most 128) for which the two
// M x ch tiles fit in the block's shared memory.
#include "common.cuh"

namespace {

constexpr int THREADS = 128;
constexpr int MAXD = 32;         // deepest path the kernel takes
constexpr int KMAX = 8;          // depths compiled as constants
constexpr int LB = 16;           // leaf values loaded per batch

// Shapley factors of path l of one tree: s_a[l, s] and s_f[l, s] (the
// feature, or -1 where the slot adds nothing: padding, out of range, or a
// repeat of an earlier slot's feature, whose factor is summed into it).
// KD > 0 fixes the depth at compile time; KD = 0 takes it from D.
template <int KD>
__device__ __forceinline__ void path_factors(
    int l, const int32_t* sf, const int32_t* lo, const int32_t* hi,
    const float* zf, const int32_t* s_code, const float* s_w, int M, int D_rt,
    int t, float* s_a, int32_t* s_f, int32_t* s_used) {
  constexpr int ND = KD > 0 ? KD : MAXD;
  const int D = KD > 0 ? KD : D_rt;
  float o[ND], z[ND], a[ND];
  int f[ND];
#pragma unroll
  for (int s = 0; s < D; ++s) {
    const int i = l * D + s;
    f[s] = sf[i];
    const int c = s_code[min(max(f[s], 0), M - 1)];
    o[s] = (c > lo[i] && c <= hi[i]) ? 1.0f : 0.0f;
    z[s] = zf[i];
  }
  // Suffix products of the path polynomial: suffix s (s = 1..D) has D - s + 1
  // coefficients, stored from offset (D - s)(D - s + 1) / 2; suffix D is [1].
  float suf[ND * (ND + 1) / 2];
  suf[0] = 1.0f;
#pragma unroll
  for (int s = D - 1; s >= 1; --s) {
    const int src = (D - s - 1) * (D - s) / 2, dst = (D - s) * (D - s + 1) / 2;
    const int len = D - s;
    suf[dst] = __fmul_rn(suf[src], z[s]);
#pragma unroll
    for (int k = 1; k < len; ++k)
      suf[dst + k] = __fadd_rn(__fmul_rn(suf[src + k], z[s]),
                               __fmul_rn(suf[src + k - 1], o[s]));
    suf[dst + len] = __fmul_rn(suf[src + len - 1], o[s]);
  }
  // Prefix products, extended in place slot by slot; Psi_s is the weighted
  // convolution of prefix s with suffix s + 1.
  float pre[ND + 1];
  pre[0] = 1.0f;
#pragma unroll
  for (int s = 0; s < D; ++s) {
    const int sp = (D - s - 1) * (D - s) / 2;
    const int ls = D - s, lp = s + 1;
    float psi = 0.0f;
#pragma unroll
    for (int k = 0; k < D; ++k) {
      const int j0 = max(0, k - ls + 1), j1 = min(k, lp - 1);
      float ck = __fmul_rn(pre[j0], suf[sp + k - j0]);
#pragma unroll
      for (int j = j0 + 1; j <= j1; ++j)
        ck = __fadd_rn(ck, __fmul_rn(pre[j], suf[sp + k - j]));
      const float wck = __fmul_rn(ck, s_w[k]);
      psi = k == 0 ? wck : __fadd_rn(psi, wck);
    }
    a[s] = __fmul_rn(__fsub_rn(o[s], z[s]), psi);
    pre[lp] = __fmul_rn(pre[lp - 1], o[s]);
#pragma unroll
    for (int k = lp - 1; k >= 1; --k)
      pre[k] = __fadd_rn(__fmul_rn(pre[k], z[s]), __fmul_rn(pre[k - 1], o[s]));
    pre[0] = __fmul_rn(pre[0], z[s]);
  }
#pragma unroll
  for (int s = 0; s < D; ++s) {
    const int fs = f[s];
    bool keep = fs >= 0 && fs < M;
#pragma unroll
    for (int p = 0; p < s; ++p) keep = keep && f[p] != fs;
    float v = 0.0f;
    if (keep) {
      v = a[s];
#pragma unroll
      for (int q = s + 1; q < D; ++q)
        if (f[q] == fs) v = __fadd_rn(v, a[q]);
      s_used[fs] = t;
    }
    s_a[l * D + s] = v;
    s_f[l * D + s] = keep ? fs : -1;
  }
}

template <int KD>
__global__ void __launch_bounds__(THREADS)
shap_kernel(float* __restrict__ phi, const uint8_t* __restrict__ codes,
            const int32_t* __restrict__ sf, const int32_t* __restrict__ lo,
            const int32_t* __restrict__ hi, const float* __restrict__ zf,
            const float* __restrict__ leaf, const int32_t* __restrict__ out_col,
            const float* __restrict__ wts, float lr, int M, int d, int T,
            int L, int D_rt, int W, int ch) {
  constexpr int ND = KD > 0 ? KD : MAXD;
  const int D = KD > 0 ? KD : D_rt;
  extern __shared__ float smem[];
  float* s_phi = smem;                                  // M x ch
  float* s_res = s_phi + M * ch;                        // M x ch
  float* s_a = s_res + M * ch;                          // L x D
  float* s_w = s_a + L * D;                             // D
  int32_t* s_f = reinterpret_cast<int32_t*>(s_w + D);   // L x D
  int32_t* s_code = s_f + L * D;                        // M
  int32_t* s_used = s_code + M;                         // M: last tree using f

  const long long r = blockIdx.x;
  const int c0 = blockIdx.y * ch;
  const int dc = min(ch, d - c0);
  const int tid = threadIdx.x;

  for (int i = tid; i < M * ch; i += THREADS) {
    s_phi[i] = 0.0f;
    s_res[i] = 0.0f;
  }
  for (int i = tid; i < M; i += THREADS) {
    s_code[i] = codes[r * M + i];
    s_used[i] = -1;
  }
  for (int i = tid; i < D; i += THREADS) s_w[i] = wts[i];
  __syncthreads();

  const int gj = c0 + tid;                              // this thread's column
  for (int t = 0; t < T; ++t) {
    const int col = out_col[t];
    if (min(col + W, c0 + dc) <= max(col, c0)) continue;   // block-uniform
    const long long tld = static_cast<long long>(t) * L * D;
    for (int l = tid; l < L; l += THREADS)
      path_factors<KD>(l, sf + tld, lo + tld, hi + tld, zf + tld, s_code, s_w,
                       M, D, t, s_a, s_f, s_used);
    __syncthreads();
    if (tid < dc && gj >= col && gj < col + W) {
      const float* lv = leaf + static_cast<long long>(t) * L * W + (gj - col);
      for (int l0 = 0; l0 < L; l0 += LB) {
        float v[LB];                    // LB leaf loads in flight at once
#pragma unroll
        for (int u = 0; u < LB; ++u)
          v[u] = l0 + u < L ? __ldg(lv + static_cast<long long>(l0 + u) * W)
                            : 0.0f;
#pragma unroll
        for (int u = 0; u < LB; ++u) {
          const int l = l0 + u;
          if (l >= L) break;
          int fo[ND];                   // this path's features: distinct
          float acc[ND];
#pragma unroll
          for (int s = 0; s < D; ++s) {
            fo[s] = s_f[l * D + s];
            acc[s] = fo[s] >= 0 ? s_res[fo[s] * ch + tid] : 0.0f;
          }
#pragma unroll
          for (int s = 0; s < D; ++s)
            if (fo[s] >= 0)
              s_res[fo[s] * ch + tid] =
                  __fadd_rn(acc[s], __fmul_rn(s_a[l * D + s], v[u]));
        }
      }
      for (int f = 0; f < M; ++f) {
        if (s_used[f] != t) continue;
        float* p = s_phi + f * ch + tid;
        float* q = s_res + f * ch + tid;
        *p = __fadd_rn(*p, __fmul_rn(lr, *q));
        *q = 0.0f;
      }
    }
    __syncthreads();   // the next tree rewrites s_a, s_f and s_used
  }
  for (int i = tid; i < M * dc; i += THREADS) {
    const int f = i / dc, j = i % dc;
    phi[(r * M + f) * d + c0 + j] = s_phi[f * ch + j];
  }
}

struct Args {
  float* phi;
  const uint8_t* codes;
  const int32_t *sf, *lo, *hi;
  const float *z, *leaf;
  const int32_t* out_col;
  const float* wts;
  float lr;
  int n, M, d, T, L, D, W;
};

template <int KD>
int launch(const Args& a, int ch, size_t smem, cudaStream_t stream) {
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        shap_kernel<KD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  dim3 grid(a.n, static_cast<unsigned>((a.d + ch - 1) / ch));
  shap_kernel<KD><<<grid, THREADS, smem, stream>>>(
      a.phi, a.codes, a.sf, a.lo, a.hi, a.z, a.leaf, a.out_col, a.wts, a.lr,
      a.M, a.d, a.T, a.L, a.D, a.W, ch);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// phi (n, M, d) float32, written whole; codes (n, M) uint8; sf/lo/hi
// (T, L, D) int32; z (T, L, D) float32; leaf (T, L, W) float32; out_col (T,)
// int32; wts (D,) float32 Shapley weights W(k, D).  1 <= D <= 32.
extern "C" int tree_shap_launch(void* phi, const void* codes, const void* sf,
                                const void* lo, const void* hi, const void* z,
                                const void* leaf, const void* out_col,
                                const void* wts, float lr, int n, int M, int d,
                                int T, int L, int D, int W, void* stream) {
  if (D < 1 || D > MAXD || M < 1 || d < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0, limit = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long fixed = 4LL * (2LL * L * D + D + 2LL * M);
  long long ch = (limit - fixed) / (8LL * M);
  ch = ch < THREADS ? ch : THREADS;
  ch = ch < d ? ch : d;
  if (ch >= 32) ch -= ch % 32;
  if (ch < 1) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = static_cast<size_t>(fixed + 8LL * M * ch);
  const Args a{static_cast<float*>(phi), static_cast<const uint8_t*>(codes),
               static_cast<const int32_t*>(sf), static_cast<const int32_t*>(lo),
               static_cast<const int32_t*>(hi), static_cast<const float*>(z),
               static_cast<const float*>(leaf),
               static_cast<const int32_t*>(out_col),
               static_cast<const float*>(wts), lr, n, M, d, T, L, D, W};
  const int c = static_cast<int>(ch);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  static_assert(KMAX == 8, "one case per compiled depth");
  switch (D) {
    case 1: return launch<1>(a, c, smem, st);
    case 2: return launch<2>(a, c, smem, st);
    case 3: return launch<3>(a, c, smem, st);
    case 4: return launch<4>(a, c, smem, st);
    case 5: return launch<5>(a, c, smem, st);
    case 6: return launch<6>(a, c, smem, st);
    case 7: return launch<7>(a, c, smem, st);
    case 8: return launch<8>(a, c, smem, st);
    default: return launch<0>(a, c, smem, st);
  }
}
