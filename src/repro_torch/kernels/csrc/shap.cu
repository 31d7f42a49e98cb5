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
// scatter-contraction plus O(D^2) per (row, path) for Psi.  With 8 depth-6
// trees (L = 64, D = 6) the bytes of phi set the bound; with the explain
// path's 100 trees the scatter's operations do.  The TPU kernel did the
// scatter as a dense (rows * M, L) x (L, W) product in which all but <= D
// entries of each path are zero; here only the real slots are touched.
//
// Design: three kernels a call, in one stream.
//  1. Plan, one warp a tree: a stable counting sort of the tree's kept
//     slots (0 <= sf < M, the first slot of its feature on its path) by
//     feature, in the order the scatter's warps hold the features (`fkey`),
//     so that each feature gets the list of its (path, slot) pairs in
//     ascending path order, and a table of where each list starts and
//     ends.  It depends on the tables only, not on the rows.
//  2. Psi, one thread a (tree, path, row), rows fastest: the path's factors
//     a_ls, repeated features merged into the first slot in slot order, into
//     a scratch A[t, l * D + s, row].  Psi is computed once per (row, tree,
//     path) with every thread at work.  The kernel is compiled for each
//     path depth D from 1 to KMAX, so the polynomial coefficients live in
//     registers; deeper paths (up to MAXD slots) take a build with
//     per-thread local arrays.
//  3. Scatter: a block owns R = 8 rows and 32 output columns, one a lane.
//     Its 16 warps split the features: warp g holds phi[row, f, column] for
//     the block's 8 rows and the features f = g, g + 16, g + 32, ... (8 of
//     them) in registers from the first tree to the last, so phi is written
//     to device memory once and no two threads ever add into the same
//     element (no atomics: the same bits run to run).  The trees whose
//     blocks overlap the columns go through shared memory four at a time,
//     by cp.async into one buffer: each tree's leaf tile (L x 32), A tile
//     (L D x 8), key table and entries.
//     Then for each of its features, a warp sums a_l(f) * leaf[l, c] down
//     the feature's list in registers, one register a row (the plain
//     version's order, from 0), and adds lr * res into its phi.  A leaf
//     value read once serves 8 rows, A's values for them are two broadcast
//     loads, and the loop holds no store, so its loads run ahead of its
//     sums.  One barrier a group of four trees: a warp whose features are
//     heavy in one tree (its root's feature is on every path) catches up in
//     the others.  Column blocks are the grid's fastest axis, so the blocks
//     of one group of rows share its A tiles in L2.
// The trees a buffer are picked per call in `pick` from the shared memory
// the card offers; where not even one tree fits a block (deep paths), the
// tables are read in place.  Features beyond 128 go in further passes, one
// a layer of the grid.  Rows go through the Psi scratch in chunks of at
// most A_BUDGET bytes.  Every product and sum rounds once, in the plain
// version's order (__fmul_rn / __fadd_rn, -fmad=false), so the kernel is
// bitwise equal to `ref.tree_shap_ref`.
//
// The first redesign kept phi's tile (R x M x 32 floats) in shared memory,
// as the first version did; at M = 100 that left room for 4 warps an SM,
// and the entry loop, with phi's stores between the features' lists, waited
// on each load in turn: it was slower than the first version (PERF.md §6
// gives each step's time from `tools/shap_split_sweep.py`).
#include <climits>

#include "common.cuh"

namespace {

constexpr int MAXD = 32;          // deepest path the kernel takes
constexpr int KMAX = 8;           // depths compiled as constants
constexpr int PSI_THREADS = 128;
constexpr int MAX_THREADS = 512;  // scatter block, at most
constexpr long long A_BUDGET = 1LL << 30;   // bytes of Psi scratch a chunk
constexpr unsigned FULL = 0xffffffffu;
constexpr int RT = 8;             // rows a scatter thread and block
constexpr int MF = 8;             // features a scatter warp holds

// 4-byte cp.async, for leaf tiles whose columns are not 16-byte aligned.
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst),
               "l"(src)
               : "memory");
}

// The scatter's nwf warps split the features: warp g of pass z holds
// features f = z nwf MF + m nwf + g for m < MF.  The plan orders a tree's
// entries by key(f) = (z nwf + g) MF + m, so that each warp's entries are
// one contiguous run, its features in ascending order.
__host__ __device__ __forceinline__ int fkey(int f, int nwf) {
  const int per = nwf * MF;
  return ((f / per) * nwf + f % nwf) * MF + (f / nwf) % MF;
}
__host__ __device__ __forceinline__ int n_keys(int M, int nwf) {
  const int per = nwf * MF;
  return (M + per - 1) / per * per;
}

// Plan of tree t, at plan + t * plan_stride (int32): K (kept slots) and
// three unused; from TAB_OFF, for each key, (start, end) of its feature's
// entries; from ent_off, K entries (a_mul * (l D + s), l_mul * l) in (key,
// path) order.
constexpr int TAB_OFF = 4;
__host__ __device__ __forceinline__ int round4(int x) {
  return (x + 3) / 4 * 4;
}
__host__ __device__ __forceinline__ int ent_off(int keys) {
  return TAB_OFF + round4(2 * keys);
}
__host__ __device__ __forceinline__ int plan_stride(int LD, int keys) {
  return round4(ent_off(keys) + 2 * LD);
}

__global__ void __launch_bounds__(32)
shap_plan_kernel(const int32_t* __restrict__ sf, int32_t* __restrict__ plan,
                 int M, int L, int D, int a_mul, int l_mul, int nwf) {
  extern __shared__ int32_t s_cnt[];            // keys: counts, then cursors
  const int t = blockIdx.x, lane = threadIdx.x;
  const int LD = L * D, keys = n_keys(M, nwf);
  const int32_t* f_t = sf + static_cast<long long>(t) * LD;
  int32_t* p = plan + static_cast<long long>(t) * plan_stride(LD, keys);
  int2* tab = reinterpret_cast<int2*>(p + TAB_OFF);
  int2* ent = reinterpret_cast<int2*>(p + ent_off(keys));
  for (int k = lane; k < keys; k += 32) s_cnt[k] = 0;
  __syncwarp();
  auto kept = [&](int i) {                       // the slot's key, or -1
    const int f = f_t[i];
    if (f < 0 || f >= M) return -1;
    for (int j = i - i % D; j < i; ++j)
      if (f_t[j] == f) return -1;
    return fkey(f, nwf);
  };
  for (int i = lane; i < LD; i += 32) {
    const int k = kept(i);
    if (k >= 0) atomicAdd(&s_cnt[k], 1);          // counts: any order
  }
  __syncwarp();
  // Exclusive prefix of the counts: each lane takes a contiguous run of
  // keys, then a warp scan.
  const int per = (keys + 31) / 32;
  const int k0 = min(keys, lane * per), k1 = min(keys, k0 + per);
  int sum = 0;
  for (int k = k0; k < k1; ++k) sum += s_cnt[k];
  int ps = sum;
  for (int off = 1; off < 32; off <<= 1) {
    const int x = __shfl_up_sync(FULL, ps, off);
    if (lane >= off) ps += x;
  }
  int start = ps - sum;
  for (int k = k0; k < k1; ++k) {
    const int c = s_cnt[k];
    tab[k] = make_int2(start, start + c);
    s_cnt[k] = start;                             // now the cursor
    start += c;
  }
  if (lane == 31) {
    p[0] = ps;
    p[1] = p[2] = p[3] = 0;
  }
  __syncwarp();
  // Stable placement: slots in ascending (path, slot) order, 32 at a time.
  for (int base = 0; base < LD; base += 32) {
    const int i = base + lane;
    const int k = i < LD ? kept(i) : -1;
    const unsigned peers = __match_any_sync(FULL, k);
    if (k >= 0) {
      const int rank = __popc(peers & ((1u << lane) - 1));
      ent[s_cnt[k] + rank] = make_int2(a_mul * i, l_mul * (i / D));
    }
    __syncwarp();
    if (k >= 0 && (peers >> lane) == 1u) s_cnt[k] += __popc(peers);
    __syncwarp();
  }
}

// Shapley factors of path l for one row: v[s] = a_ls merged over the path's
// later slots on the same feature, 0 where the slot adds nothing (padding,
// out of range, or a repeat of an earlier slot's feature).  KD > 0 fixes the
// depth at compile time; KD = 0 takes it from D.
template <int KD>
__device__ __forceinline__ void path_factors(
    const int32_t* sf, const int32_t* lo, const int32_t* hi, const float* zf,
    const uint8_t* code_row, const float* wts, int M, int D_rt, float* v) {
  constexpr int ND = KD > 0 ? KD : MAXD;
  const int D = KD > 0 ? KD : D_rt;
  float o[ND], z[ND], a[ND];
  int f[ND];
#pragma unroll
  for (int s = 0; s < D; ++s) {
    f[s] = __ldg(sf + s);
    const int c = code_row[min(max(f[s], 0), M - 1)];
    o[s] = (c > __ldg(lo + s) && c <= __ldg(hi + s)) ? 1.0f : 0.0f;
    z[s] = __ldg(zf + s);
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
      const float wck = __fmul_rn(ck, __ldg(wts + k));
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
    float val = 0.0f;
    if (keep) {
      val = a[s];
#pragma unroll
      for (int q = s + 1; q < D; ++q)
        if (f[q] == fs) val = __fadd_rn(val, a[q]);
    }
    v[s] = val;
  }
}

// A[((r / RT) T + t) L D + l D + s][r % RT] for rows r of the chunk, in
// groups of RT rows (0 past n_c): a scatter block's tile of a tree is one
// contiguous run.
template <int KD>
__global__ void __launch_bounds__(PSI_THREADS)
shap_psi_kernel(float* __restrict__ A, const uint8_t* __restrict__ codes,
                const int32_t* __restrict__ sf, const int32_t* __restrict__ lo,
                const int32_t* __restrict__ hi, const float* __restrict__ zf,
                const float* __restrict__ wts, int M, int T, int L, int D_rt,
                int n_c) {
  constexpr int ND = KD > 0 ? KD : MAXD;
  const int D = KD > 0 ? KD : D_rt;
  const int n_g = (n_c + RT - 1) / RT * RT;      // rows, whole groups
  const long long w = static_cast<long long>(blockIdx.x) * PSI_THREADS +
                      threadIdx.x;
  if (w >= static_cast<long long>(T) * L * n_g) return;
  const int r = static_cast<int>(w % n_g);
  const long long tl = w / n_g;                 // t * L + l
  const long long base = tl * D;                // slot (t, l, 0)
  const long long t = tl / L;
  float* out = A + ((r / RT * T + t) * L * D + (base - t * L * D)) * RT +
               r % RT;
  float v[ND];
  if (r < n_c) {
    path_factors<KD>(sf + base, lo + base, hi + base, zf + base,
                     codes + static_cast<long long>(r) * M, wts, M, D, v);
  } else {
#pragma unroll
    for (int s = 0; s < D; ++s) v[s] = 0.0f;
  }
#pragma unroll
  for (int s = 0; s < D; ++s) out[s * RT] = v[s];
}

// Scatter configuration: nwf feature warps, the tables staged in shared
// memory or read in place, and trees a staging buffer (1 to GMAX).
struct Config {
  int nwf, staged, group;
};

struct Scatter {
  float* phi;              // the chunk's first row
  const float* A;
  const float* leaf;
  const int32_t* out_col;
  const int32_t* plan;
  float lr;
  int n_c, M, d, T, L, LD, W, nwf, group, leaf16;
};

constexpr int CH = 32;    // columns a block: one a lane
constexpr int GMAX = 4;   // trees a staging group, at most

// Floats of one staging buffer: the leaf tile (L x CH), the Psi tile
// (L D x RT), the key table (keys int2) and the entries (L D int2).
__host__ __device__ __forceinline__ long long buf_floats(int L, int LD,
                                                         int keys) {
  return static_cast<long long>(L) * CH + static_cast<long long>(LD) * RT +
         round4(2 * keys) + round4(2 * LD);
}

template <bool STAGED>
__global__ void __launch_bounds__(MAX_THREADS)
shap_scatter_kernel(const Scatter a) {
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nthreads = blockDim.x;
  const int nwf = a.nwf;
  const int f0 = blockIdx.z * nwf * MF + warp;  // this warp's first feature
  const int kbase = (blockIdx.z * nwf + warp) * MF;  // and its first key
  const int row0 = blockIdx.y * RT;             // the block's first row
  const int c0 = blockIdx.x * CH;
  const int dc = min(CH, a.d - c0);
  const int M = a.M, L = a.L, LD = a.LD, W = a.W;
  const int keys = n_keys(M, nwf);
  const int pstride = plan_stride(LD, keys), eoff = ent_off(keys);
  const long long bufn = STAGED ? buf_floats(L, LD, keys) : 0;
  const int a_off = L * CH, tab_off = a_off + LD * RT;
  const int e_off = tab_off + round4(2 * keys);
  // The block's Psi tiles: tree t's at a_rows + t * LD * RT.
  const float* a_rows =
      a.A + static_cast<long long>(blockIdx.y) * a.T * LD * RT;
  float phi[MF][RT];
#pragma unroll
  for (int m = 0; m < MF; ++m)
#pragma unroll
    for (int q = 0; q < RT; ++q) phi[m][q] = 0.0f;

  auto overlaps = [&](int t) {
    const int col = a.out_col[t];
    return min(col + W, c0 + dc) > max(col, c0);
  };
  auto next = [&](int t) {
    for (++t; t < a.T && !overlaps(t); ++t) {
    }
    return t;
  };
  auto stage = [&](int t, int j) {
    float* sb = smem + j * bufn;
    const int col = a.out_col[t];
    const int lo = max(col, c0) - c0, hi = min(col + W, c0 + dc) - c0;
    const float* src = a.leaf + static_cast<long long>(t) * L * W + (c0 - col);
    if (lo == 0 && hi == CH && a.leaf16 && (c0 - col) % 4 == 0) {
      for (int i = tid; i < L * (CH / 4); i += nthreads) {
        const int l = i / (CH / 4), q = 4 * (i % (CH / 4));
        cp_async16(smem_addr(sb + l * CH + q),
                   src + static_cast<long long>(l) * W + q, 16);
      }
    } else {
      const int w = hi - lo;
      for (int i = tid; i < L * w; i += nthreads) {
        const int l = i / w, q = lo + i % w;
        cp_async4(smem_addr(sb + l * CH + q),
                  src + static_cast<long long>(l) * W + q);
      }
    }
    const float* sa = a_rows + static_cast<long long>(t) * LD * RT;
    for (int i = tid; i < LD * (RT / 4); i += nthreads)
      cp_async16(smem_addr(sb + a_off + 4 * i), sa + 4 * i, 16);
    const int32_t* pl = a.plan + static_cast<long long>(t) * pstride;
    const int nt = round4(2 * keys) / 4, ne = (2 * __ldg(pl) + 3) / 4;
    for (int i = tid; i < nt + ne; i += nthreads) {
      const int32_t* from = i < nt ? pl + TAB_OFF + 4 * i
                                   : pl + eoff + 4 * (i - nt);
      cp_async16(smem_addr(sb + (i < nt ? tab_off : e_off - 4 * nt) + 4 * i),
                 from, 16);
    }
  };

  // Tree t's sums into phi, its tables at sb (staged) or in place.
  auto sum_tree = [&](int t, const float* sb) {
    const int col = a.out_col[t];
    const int gc = c0 + lane;
    if (lane < dc && gc >= col && gc < col + W) {
      const int32_t* pl = a.plan + static_cast<long long>(t) * pstride;
      const int2* tab = reinterpret_cast<const int2*>(
          STAGED ? reinterpret_cast<const int32_t*>(sb + tab_off)
                 : pl + TAB_OFF) + kbase;
      const int2* ent = reinterpret_cast<const int2*>(
          STAGED ? reinterpret_cast<const int32_t*>(sb + e_off) : pl + eoff);
      const float* lsrc =
          (STAGED ? sb
                  : a.leaf + static_cast<long long>(t) * L * W + (c0 - col)) +
          lane;
      const float* asrc =
          STAGED ? sb + a_off : a_rows + static_cast<long long>(t) * LD * RT;
#pragma unroll
      for (int m = 0; m < MF; ++m) {
        const int2 se = tab[m];
        if (se.x == se.y) continue;
        float res[RT];
#pragma unroll
        for (int q = 0; q < RT; ++q) res[q] = 0.0f;
#pragma unroll 4
        for (int k = se.x; k < se.y; ++k) {
          const int2 e = ent[k];
          const float v = lsrc[e.y];
          float av[RT];
#pragma unroll
          for (int q = 0; q < RT; q += 4) {
            const float4 x = *reinterpret_cast<const float4*>(asrc + e.x + q);
            av[q] = x.x;
            av[q + 1] = x.y;
            av[q + 2] = x.z;
            av[q + 3] = x.w;
          }
#pragma unroll
          for (int q = 0; q < RT; ++q)
            res[q] = __fadd_rn(res[q], __fmul_rn(av[q], v));
        }
#pragma unroll
        for (int q = 0; q < RT; ++q)
          phi[m][q] = __fadd_rn(phi[m][q], __fmul_rn(a.lr, res[q]));
      }
    }
  };

  // Trees go through shared memory in groups of G (the ones that overlap
  // the block's columns): one barrier a group, so a warp whose features are
  // heavy in one tree catches up in the others.  The loops over a group's
  // trees are not unrolled: one copy of the sums keeps the code small.
  const int G = STAGED ? a.group : 1;
  auto group_end = [&](int t, int& n) {         // the tree after the group
    for (n = 0; t < a.T && n < G; ++n) t = next(t);
    return t;
  };
  auto stage_group = [&](int t, int n) {
#pragma unroll 1
    for (int j = 0; j < n; ++j, t = next(t)) stage(t, j);
    cp_async_commit();
  };
  // The next group is found before the wait, so its reads of out_col run
  // while the staged copies are in flight.
  int cur = next(-1), ncur;
  int t = group_end(cur, ncur);
  if (STAGED && ncur > 0) stage_group(cur, ncur);
  while (ncur > 0) {
    const int nxt = t;
    int nn;
    t = group_end(nxt, nn);
    if (STAGED) {
      cp_async_wait<0>();
      __syncthreads();
    }
    int tt = cur;
#pragma unroll 1
    for (int j = 0; j < ncur; ++j, tt = next(tt))
      sum_tree(tt, smem + j * bufn);
    if (STAGED) {
      __syncthreads();   // the next group rewrites the buffer
      if (nn > 0) stage_group(nxt, nn);
    }
    cur = nxt;
    ncur = nn;
  }
  if (lane < dc) {
#pragma unroll
    for (int m = 0; m < MF; ++m) {
      const int f = f0 + m * nwf;
      if (f >= M) break;
#pragma unroll
      for (int q = 0; q < RT; ++q) {
        const int r = row0 + q;
        if (r < a.n_c)
          a.phi[(static_cast<long long>(r) * M + f) * a.d + c0 + lane] =
              phi[m][q];
      }
    }
  }
}

struct Shape {
  int n, M, d, T, L, D, W;
};

// The rows of one pass through the Psi scratch (a multiple of 16, and few
// enough that the scatter's grid has at most 65,535 blocks of RT rows).
constexpr long long MAX_CHUNK_ROWS = 65535LL * RT / 16 * 16;
long long chunk_rows(const Shape& s) {
  const long long per_row = 4LL * s.T * s.L * s.D;
  long long rows = A_BUDGET / per_row;
  rows = rows < MAX_CHUNK_ROWS ? rows : MAX_CHUNK_ROWS;
  rows = rows < 16 ? 16 : rows - rows % 16;
  const long long all = (static_cast<long long>(s.n) + 15) / 16 * 16;
  return rows < all ? rows : all;
}

size_t smem_bytes(const Config& c, const Shape& s) {
  const int keys = n_keys(s.M, c.nwf);
  return c.staged ? 4 * static_cast<size_t>(c.group *
                                            buf_floats(s.L, s.L * s.D, keys))
                  : 0;
}

struct Card {
  int optin;               // shared bytes a block may opt in to
};

int card(Card* out) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&out->optin,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  return static_cast<int>(e);
}

// The scatter's configuration for this shape on this card: 16 feature
// warps (fewer where M is smaller) of MF features each, RT = 8 rows a block
// (512 threads); the tables staged in one buffer of the most trees (up to
// GMAX) that fit a block's shared memory, else read in place.
Config pick(const Shape& s, const Card& cd) {
  const int nwf = s.M < 16 ? s.M : 16;
#ifdef SHAP_FORCE_CONFIG
  (void)cd;
  Config c SHAP_FORCE_CONFIG;
  c.nwf = c.nwf < s.M ? c.nwf : s.M;
  return c;
#else
  for (int group = GMAX; group >= 1; --group) {
    const Config c{nwf, 1, group};
    if (smem_bytes(c, s) <= static_cast<size_t>(cd.optin)) return c;
  }
  return Config{nwf, 0, 1};
#endif
}

template <bool ST>
int run_scatter(const Scatter& sc, size_t smem, cudaStream_t st) {
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        shap_scatter_kernel<ST>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  // Column blocks fastest: the blocks of one group of rows run together
  // and share its Psi tiles in L2.
  const dim3 grid((sc.d + CH - 1) / CH, (sc.n_c + RT - 1) / RT,
                  (sc.M + sc.nwf * MF - 1) / (sc.nwf * MF));
  shap_scatter_kernel<ST><<<grid, sc.nwf * 32, smem, st>>>(sc);
  return static_cast<int>(cudaGetLastError());
}

template <int KD>
int psi(float* A, const uint8_t* codes, const int32_t* sf, const int32_t* lo,
        const int32_t* hi, const float* z, const float* wts, const Shape& s,
        int n_c, cudaStream_t st) {
  const long long work =
      static_cast<long long>(s.T) * s.L * ((n_c + RT - 1) / RT * RT);
  const long long blocks = (work + PSI_THREADS - 1) / PSI_THREADS;
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  shap_psi_kernel<KD><<<static_cast<unsigned>(blocks), PSI_THREADS, 0, st>>>(
      A, codes, sf, lo, hi, z, wts, s.M, s.T, s.L, s.D, n_c);
  return static_cast<int>(cudaGetLastError());
}

int psi_any(float* A, const uint8_t* codes, const int32_t* sf,
            const int32_t* lo, const int32_t* hi, const float* z,
            const float* wts, const Shape& s, int n_c,
            cudaStream_t st) {
  static_assert(KMAX == 8, "one case per compiled depth");
  switch (s.D) {
    case 1: return psi<1>(A, codes, sf, lo, hi, z, wts, s, n_c, st);
    case 2: return psi<2>(A, codes, sf, lo, hi, z, wts, s, n_c, st);
    case 3: return psi<3>(A, codes, sf, lo, hi, z, wts, s, n_c, st);
    case 4: return psi<4>(A, codes, sf, lo, hi, z, wts, s, n_c, st);
    case 5: return psi<5>(A, codes, sf, lo, hi, z, wts, s, n_c, st);
    case 6: return psi<6>(A, codes, sf, lo, hi, z, wts, s, n_c, st);
    case 7: return psi<7>(A, codes, sf, lo, hi, z, wts, s, n_c, st);
    case 8: return psi<8>(A, codes, sf, lo, hi, z, wts, s, n_c, st);
    default: return psi<0>(A, codes, sf, lo, hi, z, wts, s, n_c, st);
  }
}

bool valid(const Shape& s) {
  return s.n >= 1 && s.M >= 1 && s.d >= 1 && s.T >= 1 && s.L >= 1 &&
         s.D >= 1 && s.D <= MAXD && s.W >= 1 &&
         static_cast<long long>(s.L) * s.D <= (INT_MAX / 2 - 16) / 4;
}

long long plan_bytes(const Shape& s, const Config& c) {
  return 4LL * s.T * plan_stride(s.L * s.D, n_keys(s.M, c.nwf));
}

}  // namespace

// Bytes of scratch a call of `tree_shap_launch` needs, in KiB (rounded up):
// the plan of every tree, then the Psi scratch of one chunk of rows.
extern "C" int tree_shap_scratch_kib(int n, int M, int d, int T, int L, int D,
                                     int W) {
  const Shape s{n, M, d, T, L, D, W};
  Card cd;
  if (!valid(s) || card(&cd)) return -1;
  const long long bytes = plan_bytes(s, pick(s, cd)) +
                          4LL * T * L * D * chunk_rows(s);
  return static_cast<int>((bytes + 1023) / 1024);
}

// The scatter's configuration for this shape (out: rows a thread, rows a
// block, feature warps, features a warp, tables staged, shared bytes a
// block, rows a chunk of the Psi scratch, feature passes, trees a staging
// buffer); returns a CUDA error code.
extern "C" int tree_shap_info(int n, int M, int d, int T, int L, int D, int W,
                              int* out) {
  const Shape s{n, M, d, T, L, D, W};
  if (!valid(s)) return static_cast<int>(cudaErrorInvalidValue);
  Card cd;
  const int e = card(&cd);
  if (e) return e;
  const Config c = pick(s, cd);
  out[0] = RT;
  out[1] = RT;
  out[2] = c.nwf;
  out[3] = MF;
  out[4] = c.staged;
  out[5] = static_cast<int>(smem_bytes(c, s));
  out[6] = static_cast<int>(chunk_rows(s));
  out[7] = (M + c.nwf * MF - 1) / (c.nwf * MF);
  out[8] = c.group;
  return 0;
}

// phi (n, M, d) float32, written whole; codes (n, M) uint8; sf/lo/hi
// (T, L, D) int32; z (T, L, D) float32; leaf (T, L, W) float32; out_col (T,)
// int32; wts (D,) float32 Shapley weights W(k, D); scratch of
// `tree_shap_scratch_kib` KiB, 16-byte aligned.  1 <= D <= 32.
extern "C" int tree_shap_launch(void* phi, const void* codes, const void* sf,
                                const void* lo, const void* hi, const void* z,
                                const void* leaf, const void* out_col,
                                const void* wts, void* scratch, float lr,
                                int n, int M, int d, int T, int L, int D,
                                int W, void* stream) {
  const Shape s{n, M, d, T, L, D, W};
  if (!valid(s) || reinterpret_cast<uintptr_t>(scratch) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Card cd;
  int e = card(&cd);
  if (e) return e;
  const Config c = pick(s, cd);
  const int keys = n_keys(M, c.nwf);
  const size_t smem = smem_bytes(c, s);
  if (c.group < 1 || c.group > GMAX || c.nwf * 32 > MAX_THREADS ||
      smem > static_cast<size_t>(cd.optin) ||
      4LL * keys > cd.optin)                    // the plan's counts
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int LD = L * D;
  int32_t* plan = static_cast<int32_t*>(scratch);
  float* A = reinterpret_cast<float*>(static_cast<char*>(scratch) +
                                      plan_bytes(s, c));
  if (keys * 4 > 48 * 1024) {
    cudaError_t ce = cudaFuncSetAttribute(
        shap_plan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        keys * 4);
    if (ce != cudaSuccess) return static_cast<int>(ce);
  }
  const long long rows = chunk_rows(s);
  shap_plan_kernel<<<T, 32, 4 * keys, st>>>(
      static_cast<const int32_t*>(sf), plan, M, L, D,
      RT, c.staged ? CH : W, c.nwf);
  e = static_cast<int>(cudaGetLastError());
  if (e) return e;
  const auto* cd8 = static_cast<const uint8_t*>(codes);
  for (long long r0 = 0; r0 < n; r0 += rows) {
    const int n_c = static_cast<int>(n - r0 < rows ? n - r0 : rows);
    e = psi_any(A, cd8 + r0 * M, static_cast<const int32_t*>(sf),
                static_cast<const int32_t*>(lo),
                static_cast<const int32_t*>(hi), static_cast<const float*>(z),
                static_cast<const float*>(wts), s, n_c, st);
    if (e) return e;
    const Scatter sc{static_cast<float*>(phi) + r0 * M * d, A,
                     static_cast<const float*>(leaf),
                     static_cast<const int32_t*>(out_col), plan, lr, n_c, M,
                     d, T, L, LD, W, c.nwf, c.group,
                     reinterpret_cast<uintptr_t>(leaf) % 16 == 0 &&
                         W % 4 == 0};
    e = c.staged ? run_scatter<true>(sc, smem, st)
                 : run_scatter<false>(sc, smem, st);
    if (e) return e;
  }
  return 0;
}
