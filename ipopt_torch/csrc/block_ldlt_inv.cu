// K2: batched unpivoted Gauss-Jordan inverse, giving the explicit inverse and
// the LDL^T pivots of many symmetric blocks, for Hopper.
//
// Replaces the TPU kernel ipopt_tpu/linalg/pallas_ldlt.py::_gj_inv_kernel
// (wrapper pallas_block_ldlt_inv), with the algorithm the reference's BCR
// levels run, block_tridiag.py::_gj_inv_auto.  For A of shape (nb, b, b) it
// writes Ainv (nb, b, b) and the unguarded pivot sequence d (nb, b).
//
// The scalar sweep, step k on the working block X (sp = p = X[k][k] guarded
// to +-FLT_MIN / DBL_MIN when |p| <= that, NaN -> -tiny):
//     X[i][j] <- X[i][j] - (X[i][k] * X[k][j]) / sp     i != k, j != k
//     X[k][j] <- -X[k][j] / sp                          j != k
//     X[i][k] <- X[i][k] / sp                           i != k
//     X[k][k] <- 1 / sp,        d[k] = p
// every update reading the X of step k-1.  For b <= 32 this is the whole
// algorithm, and the result equals the plain PyTorch version
// (ipopt_torch/linalg/block_ldlt_inv.py::block_ldlt_inv_plain) and
// _gj_inv_lanes bit for bit: none of the expressions can be contracted into
// an FMA.  Above 32 the block goes in panels P of t = 32 rows and columns
// (the last may be ragged), as _gj_inv_lanes_blocked does, o being the
// indices outside P:
//     Pinv, d[P] = the scalar sweep of X_PP;   CP = X_oP Pinv
//     X_oo -= CP X_Po;   X_oP = CP;   X_Po = -Pinv X_Po;   X_PP = Pinv
//
// What bounds it: on the chained main path (LuksanVlcek1 n=4096, v=32) the
// first BCR level is (64, 156, 156) float64.  The function needs b^3
// multiply-adds per block, 486 M flops per launch: 7.3 us at the 67 TFLOP/s
// of the FP64 tensor cores, against 25 MB read and written, 7.5 us at
// 3.35 TB/s.  So bytes bound it, barely.  The launches of one factorization
// go from 64 blocks down to 1 (ne = 64, 32, ..., 1 and the root), so from
// the third on a CTA per block would leave most of the 132 SMs idle, and a
// sweep of 156 dependent scalar steps on one SM costs ~1.3 ms whatever ne is.
//
// The design (b > 32; for b <= 32 the warp variant below runs the scalar
// sweep in registers, several blocks per warp):
// - One thread-block cluster of cs CTAs per block.  CTA c keeps a strip of
//   whole 32-row panels of the block in its shared memory for the whole
//   factorization (the panels split as evenly as they go, the larger strips
//   first); device memory is read once and written once.  The plan (cs, the
//   strip rows, the shared bytes) is plain Python, block_ldlt_inv.py::plan:
//   the smallest cs whose strips fit, widened while nb * cs <= 132 SMs, a CTA
//   still holds a panel and the cluster stays portable (cs <= 8), to the
//   smallest cs that gives the shortest strips those bounds allow.  So at
//   b = 156 level 1 (ne = 64) runs cs = 2, ne = 32 cs = 3 and the tail levels
//   spread each block over 5 SMs.
// - One panel step, with the panel's rows held by CTA q:
//     1. q sweeps the t x t panel in shared memory (the reference's
//        divisions, 512 threads, ping-pong between two 32 x 32 tiles: one
//        barrier per step);
//     2. cluster barrier;
//     3. every CTA copies Pinv from q's shared memory (distributed shared
//        memory, cooperative_groups::this_cluster().map_shared_rank), forms
//        CP = X_strip,P Pinv in place in its panel columns, and applies
//        X_strip,o += (-CP) R_o with R_o read from q's strip in place;
//     4. cluster barrier;
//     5. q writes -Pinv R_o and Pinv into the panel rows, in place (each
//        warp owns whole column tiles).
//   Step 1 of the next panel overlaps step 5 when another CTA holds it.
// - float64 products on the FP64 tensor cores:
//   mma.sync.aligned.m8n8k4.row.col.f64 (DMMA), fragments loaded straight
//   from shared memory (the strip's row stride, round_up(b, 32) + 4, is 4
//   mod 16 doubles, so an A fragment's 8 rows hit distinct banks).  float32
//   products are IEEE FFMA on the CUDA cores (never TF32).
// - The sweep's quotients come from one correctly rounded reciprocal per
//   step and a certified Markstein correction (div_by), without branches;
//   only what the certificate cannot vouch for takes the library division.
//   A pivot outside the certificate's range that is a power of two (the
//   guard's +-tiny, and the 1 / tiny its step leaves behind) takes its own
//   uniform branch: its reciprocal is exact, so each quotient is one
//   rounded product (step_guard).  That matters on the chained path: its
//   first inertia-correction trials (no constraint regularization yet) hit
//   exactly zero pivots in every block, and each of those steps, and the
//   2^1022 pivot that follows each, otherwise sent every thread of the CTA
//   to the library division.
// - Shared memory per CTA: (strip rows) x (round_up(b, 32) + 4) elements and
//   2 x 32 x 32 for Pinv and its sweep buffer.  At (64, 156) float64 cs = 2:
//   96 x 164 x 8 + 16,384 = 142,336 B.  At b = 408 float64 the 13 panels need
//   strips of at most 2 panels (64 x 420 x 8 + 16,384 = 231,424 B of the
//   232,448 a CTA may use; 3 panels would be 338,944), so cs = 7.  The
//   cluster variant's largest b is 416 in float64 and 576 in float32; wider
//   blocks take the device-memory variant below, so every b runs.
//   No buffer holds R_o or CP: R_o is read from q in place and CP is kept
//   in the strip's panel columns, where it belongs after the step.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libblock_ldlt_inv.so block_ldlt_inv.cu
// (ipopt_torch/linalg/cuda_lib.py does this at first use).

#include <cuda_runtime.h>
#include <cooperative_groups.h>
#include <cuda_pipeline.h>
#include <cfloat>

#include "dmma.cuh"
#include "exact_div.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kPanel = 32;
constexpr int kTile = kPanel * kPanel;
constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxCluster = 8;
static_assert(kPanel % kWarps == 0, "the sweep gives each warp whole rows");

// Panels [first, first + count) of CTA c: as even as possible, larger first
// (block_ldlt_inv.py::_strip_panels).
__device__ __forceinline__ void strip_of(int n_panels, int cs, int c, int& first,
                                         int& count) {
  const int base = n_panels / cs, extra = n_panels % cs;
  first = c * base + (c < extra ? c : extra);
  count = base + (c < extra ? 1 : 0);
}

__device__ __forceinline__ int owner_of(int panel, int n_panels, int cs) {
  const int base = n_panels / cs, extra = n_panels % cs;
  const int big = extra * (base + 1);
  return panel < big ? panel / (base + 1) : extra + (panel - big) / base;
}

// One sweep step for element (i, j) of the panel, from the previous step's
// x = X[i][j], c = X[i][k], r = X[k][j]; y = 1/sp.
template <typename T>
__device__ __forceinline__ T step_fast(int i, int j, int k, T x, T c, T r, T sp,
                                       T y, bool& ok) {
  const bool row = i == k, col = j == k;
  const T a = row ? -r : (col ? c : mul_rn(c, r));
  const T q = div_by(a, sp, y, ok);
  return (row & col) ? y : ((row | col) ? q : sub_rn(x, q));
}

// The step when sp is a power of two (Pow2), y = 1 / sp exactly: RN(a y) is
// RN(a / sp) for every a (0, huge, inf and NaN included).
template <typename T>
__device__ __forceinline__ T step_guard(int i, int j, int k, T x, T c, T r, T y) {
  const bool row = i == k, col = j == k;
  const T q = mul_rn(row ? -r : (col ? c : mul_rn(c, r)), y);
  return (row & col) ? y : ((row | col) ? q : sub_rn(x, q));
}

template <typename T>
__device__ __forceinline__ T step_exact(int i, int j, int k, T x, T c, T r, T sp) {
  if (i == k) return j == k ? div_rn(T(1), sp) : div_rn(-r, sp);
  return j == k ? div_rn(c, sp) : sub_rn(x, div_rn(mul_rn(c, r), sp));
}

// 1. The scalar sweep of the t x t panel at Xp (row stride ld) into Pl
// (32 x 32, zero outside t x t), with Pw as the ping-pong tile; the pivots
// go to Dp.  Whole CTA; ends after a barrier.  Thread (warp, lane) owns
// column lane of rows warp and warp + 16, and loads all its operands before
// it computes, so its quotients overlap.  Lane k
// keeps pivot k in a register: a store to device memory inside the loop
// would hold every step's barrier until it completes.
template <typename T>
__device__ void sweep_panel(const T* Xp, int ld, int t, T* Pl, T* Pw, T* Dp) {
  constexpr int kRows = kPanel / kWarps;
  const int j = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int m = 0; m < kRows; ++m) {
    const int i = warp + kWarps * m;
    Pl[i * kPanel + j] = (i < t && j < t) ? Xp[i * ld + j] : T(0);
    Pw[i * kPanel + j] = T(0);
  }
  __syncthreads();
  T* src = Pl;
  T* dst = Pw;
  T dj = T(0);
  for (int k = 0; k < t; ++k) {
    const T p = src[k * kPanel + k];
    if (j == k) dj = p;
    const T r = src[k * kPanel + j];
    T c[kRows], x[kRows], v[kRows];
#pragma unroll
    for (int m = 0; m < kRows; ++m) {
      c[m] = src[(warp + kWarps * m) * kPanel + k];
      x[m] = src[(warp + kWarps * m) * kPanel + j];
    }
    const T sp = safe_pivot(p);
    const T asp = fabs(sp);
    // sp is the same in every thread: the branches are uniform
    if ((asp >= Exact<T>::plo) & (asp <= Exact<T>::phi)) {
      const T y = div_rn(T(1), sp);
      bool ok = true;
#pragma unroll
      for (int m = 0; m < kRows; ++m)
        v[m] = step_fast(warp + kWarps * m, j, k, x[m], c[m], r, sp, y, ok);
      if (!ok) {
#pragma unroll
        for (int m = 0; m < kRows; ++m)
          v[m] = step_exact(warp + kWarps * m, j, k, x[m], c[m], r, sp);
      }
    } else if (Pow2<T>::is(sp)) {
      const T y = Pow2<T>::recip(sp);
#pragma unroll
      for (int m = 0; m < kRows; ++m)
        v[m] = step_guard(warp + kWarps * m, j, k, x[m], c[m], r, y);
    } else {
#pragma unroll
      for (int m = 0; m < kRows; ++m)
        v[m] = step_exact(warp + kWarps * m, j, k, x[m], c[m], r, sp);
    }
#pragma unroll
    for (int m = 0; m < kRows; ++m) {
      const int i = warp + kWarps * m;
      if (i < t && j < t) dst[i * kPanel + j] = v[m];
    }
    __syncthreads();
    T* tmp = src;
    src = dst;
    dst = tmp;
  }
  if (warp == 0 && j < t) Dp[j] = dj;
  if (src != Pl) {
    for (int e = threadIdx.x; e < kTile; e += kThreads) Pl[e] = src[e];
    __syncthreads();
  }
}

// The three products of a panel step.  S is the CTA's strip (nrows real
// rows, stride ld), p0 the panel's first column, t its width, skip the
// strip row of the panel when this CTA holds it (else -1).
//   form_cp:      S[r, P] <- S[r, P] Pinv                  (r outside P)
//   update_strip: S[r, o] <- S[r, o] + (-S[r, P]) R[:, o]  (r outside P)
//   update_panel: Sp[:, o] <- (-Pinv) Sp[:, o]             (the panel rows)
template <typename T> struct Products;

template <> struct Products<double> {
  static __device__ void form_cp(double* S, int ld, int nrows, int skip, int p0,
                                 int t, const double* Pl) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int g = lane >> 2, c4 = lane & 3;
    const int mtiles = (nrows + 7) >> 3;
    if (warp >= mtiles) return;
    double bf[4][8];
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int s = 0; s < 8; ++s) bf[nt][s] = Pl[(4 * s + c4) * kPanel + 8 * nt + g];
    for (int mt = warp; mt < mtiles; mt += kWarps) {
      const int r0 = mt * 8;
      if (r0 >= skip && r0 < skip + kPanel && skip >= 0) continue;
      double* Xr = S + (r0 + g) * ld + p0;
      double af[8];
#pragma unroll
      for (int s = 0; s < 8; ++s) af[s] = 4 * s + c4 < t ? Xr[4 * s + c4] : 0.0;
      double acc[4][2] = {};
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int s = 0; s < 8; ++s) dmma(acc[nt][0], acc[nt][1], af[s], bf[nt][s]);
      __syncwarp();
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
        *reinterpret_cast<double2*>(Xr + 8 * nt + 2 * c4) =
            make_double2(acc[nt][0], acc[nt][1]);
      __syncwarp();
    }
  }

  static __device__ void update_strip(double* S, int ld, int nrows, int skip,
                                      int p0, int t, int b, const double* R) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int g = lane >> 2, c4 = lane & 3;
    const int mtiles = (nrows + 7) >> 3, ntiles = (b + 7) >> 3;
    for (int nt = warp; nt < ntiles; nt += kWarps) {
      const int n0 = nt * 8;
      if (n0 >= p0 && n0 < p0 + kPanel) continue;
      double bf[8];
#pragma unroll
      for (int s = 0; s < 8; ++s)
        bf[s] = 4 * s + c4 < t ? R[(4 * s + c4) * ld + n0 + g] : 0.0;
      for (int mt = 0; mt < mtiles; ++mt) {
        const int r0 = mt * 8;
        if (r0 >= skip && r0 < skip + kPanel && skip >= 0) continue;
        double* Xr = S + (r0 + g) * ld;
        double2 c = *reinterpret_cast<const double2*>(Xr + n0 + 2 * c4);
#pragma unroll
        for (int s = 0; s < 8; ++s) {
          const double a = 4 * s + c4 < t ? -Xr[p0 + 4 * s + c4] : 0.0;
          dmma(c.x, c.y, a, bf[s]);
        }
        *reinterpret_cast<double2*>(Xr + n0 + 2 * c4) = c;
      }
    }
  }

  static __device__ void update_panel(double* Sp, int ld, int p0, int t, int b,
                                      const double* Pl) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int g = lane >> 2, c4 = lane & 3;
    const int ntiles = (b + 7) >> 3;
    if (warp >= ntiles) return;
    double af[4][8];
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
#pragma unroll
      for (int s = 0; s < 8; ++s) af[mt][s] = -Pl[(8 * mt + g) * kPanel + 4 * s + c4];
    for (int nt = warp; nt < ntiles; nt += kWarps) {
      const int n0 = nt * 8;
      if (n0 >= p0 && n0 < p0 + kPanel) continue;
      double bf[8];
#pragma unroll
      for (int s = 0; s < 8; ++s)
        bf[s] = 4 * s + c4 < t ? Sp[(4 * s + c4) * ld + n0 + g] : 0.0;
      double acc[4][2] = {};
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
#pragma unroll
        for (int s = 0; s < 8; ++s) dmma(acc[mt][0], acc[mt][1], af[mt][s], bf[s]);
      __syncwarp();
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
        *reinterpret_cast<double2*>(Sp + (8 * mt + g) * ld + n0 + 2 * c4) =
            make_double2(acc[mt][0], acc[mt][1]);
    }
  }
};

template <> struct Products<float> {
  // a warp per strip row, lane n computes CP[r][n]
  static __device__ void form_cp(float* S, int ld, int nrows, int skip, int p0,
                                 int t, const float* Pl) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    for (int r = warp; r < nrows; r += kWarps) {
      if (r >= skip && r < skip + kPanel && skip >= 0) continue;
      float* Xr = S + r * ld + p0;
      float cp = 0.0f;
      for (int k = 0; k < t; ++k) cp = fmaf(Xr[k], Pl[k * kPanel + lane], cp);
      __syncwarp();
      Xr[lane] = cp;
      __syncwarp();
    }
  }

  // a warp per (32 columns, 8 rows), lane j keeps R[:, j] in registers
  static __device__ void update_strip(float* S, int ld, int nrows, int skip,
                                      int p0, int t, int b, const float* R) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int chunks = (b + 31) >> 5, groups = (nrows + 7) >> 3;
    for (int task = warp; task < chunks * groups; task += kWarps) {
      const int j = (task % chunks) * 32 + lane, r0 = (task / chunks) * 8;
      if (j - lane == p0) continue;
      float rk[kPanel];
#pragma unroll
      for (int k = 0; k < kPanel; ++k) rk[k] = k < t ? R[k * ld + j] : 0.0f;
      for (int r = r0; r < r0 + 8 && r < nrows; ++r) {
        if (r >= skip && r < skip + kPanel && skip >= 0) continue;
        float* Xr = S + r * ld;
        float acc = Xr[j];
#pragma unroll
        for (int k = 0; k < kPanel; ++k)
          if (k < t) acc = fmaf(-Xr[p0 + k], rk[k], acc);
        Xr[j] = acc;
      }
    }
  }

  // a warp per 32 columns, lane j owns column j of the panel rows
  static __device__ void update_panel(float* Sp, int ld, int p0, int t, int b,
                                      const float* Pl) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int chunks = (b + 31) >> 5;
    for (int ch = warp; ch < chunks; ch += kWarps) {
      const int j = ch * 32 + lane;
      if (ch * 32 == p0) continue;
      float rk[kPanel];
#pragma unroll
      for (int k = 0; k < kPanel; ++k) rk[k] = k < t ? Sp[k * ld + j] : 0.0f;
      for (int i = 0; i < kPanel; ++i) {
        float acc = 0.0f;
#pragma unroll
        for (int k = 0; k < kPanel; ++k) acc = fmaf(-Pl[i * kPanel + k], rk[k], acc);
        Sp[i * ld + j] = acc;
      }
    }
  }
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
gj_inv_cluster_kernel(const T* __restrict__ A, T* __restrict__ Ainv,
                      T* __restrict__ D, int b) {
  cg::cluster_group cluster = cg::this_cluster();
  const int cs = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const long long blk = blockIdx.x / cs;
  const int n_panels = (b + kPanel - 1) / kPanel;
  const int ld = n_panels * kPanel + 4;
  const int alloc_rows = (n_panels + cs - 1) / cs * kPanel;
  int first, count;
  strip_of(n_panels, cs, rank, first, count);
  const int row0 = first * kPanel;
  const int nrows = min(b, (first + count) * kPanel) - row0;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* S = reinterpret_cast<T*>(smem_raw);  // alloc_rows x ld, the strip
  T* Pl = S + alloc_rows * ld;            // 32 x 32: Pinv of the panel
  T* Pw = Pl + kTile;                     // 32 x 32: the sweep's other tile

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  // the strip, by asynchronous copies all in flight at once; zero padding
  const T* Ab = A + blk * b * b;
  for (int i = warp; i < alloc_rows; i += kWarps)
    for (int j = lane; j < ld; j += 32) {
      if (i < nrows && j < b)
        __pipeline_memcpy_async(S + i * ld + j, Ab + (long long)(row0 + i) * b + j,
                                sizeof(T));
      else
        S[i * ld + j] = T(0);
    }
  __pipeline_commit();
  __pipeline_wait_prior(0);
  __syncthreads();

  T* Db = D + blk * b;
  for (int pi = 0; pi < n_panels; ++pi) {
    const int p0 = pi * kPanel;
    const int t = min(kPanel, b - p0);
    const int q = owner_of(pi, n_panels, cs);
    const bool own = q == rank;
    const int skip = own ? p0 - row0 : -1;
    if (own) sweep_panel<T>(S + skip * ld + p0, ld, t, Pl, Pw, Db + p0);
    cluster.sync();
    int q_first, q_count;
    strip_of(n_panels, cs, q, q_first, q_count);
    const T* R = own ? S + skip * ld
                     : cluster.map_shared_rank(S, q) + (p0 - q_first * kPanel) * ld;
    if (!own) {
      const T* Plq = cluster.map_shared_rank(Pl, q);
      for (int e = threadIdx.x; e < kTile; e += kThreads) Pl[e] = Plq[e];
      __syncthreads();
    }
    Products<T>::form_cp(S, ld, nrows, skip, p0, t, Pl);
    __syncthreads();
    Products<T>::update_strip(S, ld, nrows, skip, p0, t, b, R);
    cluster.sync();
    if (own) {
      T* Sp = S + skip * ld;
      Products<T>::update_panel(Sp, ld, p0, t, b, Pl);
      for (int e = threadIdx.x; e < kTile; e += kThreads)
        Sp[(e >> 5) * ld + p0 + (e & 31)] = Pl[e];
      __syncthreads();
    }
  }

  T* Ob = Ainv + blk * b * b;
  for (int i = warp; i < nrows; i += kWarps)
    for (int j = lane; j < b; j += 32) Ob[(long long)(row0 + i) * b + j] = S[i * ld + j];
}

// ---------------------------------------------------------------------------
// The warp variant, for b <= 32: the scalar sweep in registers.  P =
// next_pow2(b) lanes per block, lane r holding row r's entries x[j]
// (j < P, zero past b), so 32 / P blocks per warp.  Step k takes the pivot
// row from lane k of the block's segment (__shfl_sync of width P, one per
// entry, every lane of the warp taking part), and each lane updates its own
// row with the same expressions as sweep_panel: quotients certified from an
// estimate of 1 / sp (1 / sp itself among them) without a branch, the
// exact reciprocal of a power-of-two pivot (step_guard), and the library
// division for a pivot out of range or a quotient the certificate cannot
// vouch for.  So it equals the plain version bit for bit, NaN included.
// The warp's contiguous blocks are loaded and stored coalesced through
// shared memory; warps spread over the SMs before a CTA takes more than one
// (block_ldlt_inv.py::plan).  What bounds it: the instructions of its
// certified quotients (b^3 per block), not its bytes.
// ---------------------------------------------------------------------------
constexpr int kMaxWarpsPerCta = 4;

// step_exact out of line: rare, and one copy keeps the unrolled step small.
template <typename T>
__device__ __noinline__ T step_slow(int i, int j, int k, T x, T c, T r, T sp) {
  return step_exact(i, j, k, x, c, r, sp);
}

// One sweep step's entry (the expressions of step_fast) with every quotient,
// 1 / sp included, certified from the estimate y of 1 / sp.
template <typename T>
__device__ __forceinline__ T step_cert(bool row, bool col, T x, T c, T r, T sp, T y,
                                       bool& ok) {
  const T a = row ? (col ? T(1) : -r) : (col ? c : mul_rn(c, r));
  const T q = div_by(a, sp, y, ok);
  return (row | col) ? q : sub_rn(x, q);
}

template <typename T, int P>
__global__ void __launch_bounds__(32 * kMaxWarpsPerCta)
gj_inv_warp_kernel(const T* __restrict__ A, T* __restrict__ Ainv, T* __restrict__ D,
                   int nb, int b) {
  constexpr int G = 32 / P;  // blocks per warp
  constexpr unsigned kFull = 0xffffffffu;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int bb = b * b;
  T* S = reinterpret_cast<T*>(smem_raw) + w * (G * bb);
  const long long first = ((long long)blockIdx.x * (blockDim.x >> 5) + w) * G;
  if (first >= nb) return;  // uniform over the warp
  const int nblk = (int)(nb - first < G ? nb - first : G);
  const int count = nblk * bb;
  const T* Aw = A + first * bb;
  for (int e = lane; e < count; e += 32) S[e] = Aw[e];
  __syncwarp();

  const int seg = lane / P, r = lane % P;
  const bool row = seg < nblk && r < b;
  T* Sr = S + (seg * b + r) * b;
  T x[P];
#pragma unroll
  for (int j = 0; j < P; ++j) x[j] = (row && j < b) ? Sr[j] : T(0);
  T dr = T(0);
  // rolled over k (one copy of the step's code), unrolled over the entries
  for (int k = 0; k < b; ++k) {
    T c = T(0);  // x[k], by compile-time indices
#pragma unroll
    for (int j = 0; j < P; ++j)
      if (j == k) c = x[j];
    const T p = __shfl_sync(kFull, c, k, P);
    if (r == k) dr = p;
    const T sp = safe_pivot(p);
    const T asp = fabs(sp);
    // uniform over a block's lanes: 0 certified quotients from an estimate
    // of 1 / sp, 1 a power of two (exact reciprocal), 2 the library division
    const int mode = ((asp >= Exact<T>::plo) & (asp <= Exact<T>::phi)) ? 0
                     : (Pow2<T>::is(sp) ? 1 : 2);
    const T y = mode == 1 ? Pow2<T>::recip(sp) : recip_estimate(sp);
    // every quotient without a branch (the guard's exact reciprocal only in
    // a warp that has such a pivot); a lane that was not vouched for
    // recomputes its row with the library division (the shuffles again, with
    // the whole warp).  Entries past b are never read.
    T v[P];
    bool ok = true;
    if (__any_sync(kFull, mode == 1)) {
#pragma unroll
      for (int j = 0; j < P; ++j) {
        const T rj = __shfl_sync(kFull, x[j], k, P);
        v[j] = mode == 1 ? step_guard(r, j, k, x[j], c, rj, y)
                         : step_cert(r == k, j == k, x[j], c, rj, sp, y, ok);
      }
    } else {
#pragma unroll
      for (int j = 0; j < P; ++j) {
        const T rj = __shfl_sync(kFull, x[j], k, P);
        v[j] = step_cert(r == k, j == k, x[j], c, rj, sp, y, ok);
      }
    }
    const bool slow = mode == 2 || (mode == 0 && !ok);
    if (__any_sync(kFull, slow)) {
#pragma unroll
      for (int j = 0; j < P; ++j) {
        const T rj = __shfl_sync(kFull, x[j], k, P);
        if (slow && j < b) v[j] = step_slow(r, j, k, x[j], c, rj, sp);
      }
    }
#pragma unroll
    for (int j = 0; j < P; ++j) x[j] = v[j];
  }

  __syncwarp();
  if (row) {
#pragma unroll
    for (int j = 0; j < P; ++j)
      if (j < b) Sr[j] = x[j];
    D[(first + seg) * b + r] = dr;
  }
  __syncwarp();
  T* Ow = Ainv + first * bb;
  for (int e = lane; e < count; e += 32) Ow[e] = S[e];
}

template <typename T, int P>
cudaError_t launch_warp(const T* a, T* ainv, T* d, int nb, int b, int grid, int threads,
                        int smem, cudaStream_t s) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        gj_inv_warp_kernel<T, P>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  gj_inv_warp_kernel<T, P><<<grid, threads, smem, s>>>(a, ainv, d, nb, b);
  return cudaGetLastError();
}

template <typename T>
int launch_warp_variant(const void* A, void* Ainv, void* D, int nb, int b, int rows,
                        int grid, int threads, int smem, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (nb <= 0 || b <= 0) return 0;
  if (b > rows || threads % 32 != 0 || threads > 32 * kMaxWarpsPerCta)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const T* a = static_cast<const T*>(A);
  T* o = static_cast<T*>(Ainv);
  T* d = static_cast<T*>(D);
  switch (rows) {
    case 1: return (int)launch_warp<T, 1>(a, o, d, nb, b, grid, threads, smem, s);
    case 2: return (int)launch_warp<T, 2>(a, o, d, nb, b, grid, threads, smem, s);
    case 4: return (int)launch_warp<T, 4>(a, o, d, nb, b, grid, threads, smem, s);
    case 8: return (int)launch_warp<T, 8>(a, o, d, nb, b, grid, threads, smem, s);
    case 16: return (int)launch_warp<T, 16>(a, o, d, nb, b, grid, threads, smem, s);
    case 32: return (int)launch_warp<T, 32>(a, o, d, nb, b, grid, threads, smem, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename T>
int launch(const void* A, void* Ainv, void* D, int nb, int b, int cs, int smem,
           int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (nb <= 0 || b <= 0) return 0;
  const int n_panels = (b + kPanel - 1) / kPanel;
  if (cs < 1 || cs > kMaxCluster || cs > n_panels) return (int)cudaErrorInvalidValue;
  const size_t rows = (size_t)((n_panels + cs - 1) / cs) * kPanel;
  const size_t need = (rows * (n_panels * kPanel + 4) + 2 * kTile) * sizeof(T);
  if (smem < 0 || (size_t)smem < need) return (int)cudaErrorInvalidValue;
  err = cudaFuncSetAttribute(gj_inv_cluster_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)nb * (unsigned)cs, 1, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = (size_t)smem;
  cfg.stream = reinterpret_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, gj_inv_cluster_kernel<T>, static_cast<const T*>(A),
                           static_cast<T*>(Ainv), static_cast<T*>(D), b);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}


// ---------------------------------------------------------------------------
// The device-memory variant, for blocks whose strips do not fit the widest
// portable cluster (b > 416 in float64, 576 in float32).  The working block X
// lives in the output buffer Ainv (A is copied there first); each panel step
// is three launches over all the blocks, in stream order:
//   1. gj_global_sweep: one CTA per block sweeps X_PP (sweep_panel, above),
//      writes the pivots and puts Pinv in place of X_PP;
//   2. gj_global_panel: one CTA per 32-row tile of a block outside P forms
//      CP = X_tile,P Pinv and writes it in place of X_tile,P; one CTA per
//      32-column tile outside P saves R = X_P,tile to the scratch buffer Rs
//      (nb, 32, b) and writes -Pinv R in place of X_P,tile;
//   3. gj_global_update: one CTA per 64 x 64 tile of a block applies
//      X_oo += (-CP) R, reading CP from X_o,P and R from Rs, and writes only
//      the entries outside P's rows and columns.
// No launch reads what another CTA of the same launch writes.  The products
// run on the FP64 tensor cores in float64 (DMMA, the fragment layout of the
// cluster variant) and as IEEE FFMA in float32.  A 1288-wide float64 block is
// 13.3 MB: a launch of 20 of them streams 266 MB through device memory per
// panel step, so this variant is bound by bytes (b / 32 passes over X) where
// the cluster variant reads and writes each block once.
// ---------------------------------------------------------------------------

constexpr int kGThreads = 256;
constexpr int kGWarps = kGThreads / 32;
constexpr int kLdA = kPanel + 4;    // row stride of a (rows x 32) tile in shared memory
constexpr int kUTile = 64;          // output tile of the rank-32 update
constexpr int kLdB = kUTile + 4;

// One 8 x 8 output tile over k = 0..31: (c0, c1) += A[m0 + g][k] B[k][n0 + 2 c4 + {0, 1}]
// with A and B in shared memory; lane = 4 g + c4.
template <typename T> struct Mma8;

template <> struct Mma8<double> {
  static __device__ __forceinline__ void run(const double* A, int lda, const double* B,
                                             int ldb, int m0, int n0, double& c0,
                                             double& c1) {
    const int lane = threadIdx.x & 31, g = lane >> 2, c4 = lane & 3;
#pragma unroll
    for (int s = 0; s < 8; ++s)
      dmma(c0, c1, A[(m0 + g) * lda + 4 * s + c4], B[(4 * s + c4) * ldb + n0 + g]);
  }
};

template <> struct Mma8<float> {
  static __device__ __forceinline__ void run(const float* A, int lda, const float* B,
                                             int ldb, int m0, int n0, float& c0,
                                             float& c1) {
    const int lane = threadIdx.x & 31, g = lane >> 2, c4 = lane & 3;
    const float* a = A + (m0 + g) * lda;
    const float* bc = B + n0 + 2 * c4;
#pragma unroll
    for (int k = 0; k < kPanel; ++k) {
      c0 = fmaf(a[k], bc[k * ldb], c0);
      c1 = fmaf(a[k], bc[k * ldb + 1], c1);
    }
  }
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
gj_global_sweep(T* __restrict__ X, T* __restrict__ D, int b, int p0, int t) {
  __shared__ T Pl[kTile];
  __shared__ T Pw[kTile];
  const long long blk = blockIdx.x;
  T* Xp = X + blk * b * b + (long long)p0 * b + p0;
  sweep_panel<T>(Xp, b, t, Pl, Pw, D + blk * b + p0);
  for (int e = threadIdx.x; e < kTile; e += kThreads) {
    const int i = e >> 5, j = e & 31;
    if (i < t && j < t) Xp[(long long)i * b + j] = Pl[e];
  }
}

// grid: nb * 2 * n_panels CTAs; tile = the 32-row (kind 0) or 32-column
// (kind 1) tile of block blk, skipped when it is the panel's own.
template <typename T>
__global__ void __launch_bounds__(kGThreads)
gj_global_panel(T* __restrict__ X, T* __restrict__ Rs, int b, int p0, int t) {
  __shared__ T As[kPanel * kLdA];
  __shared__ T Bs[kPanel * kLdA];
  const int n_panels = (b + kPanel - 1) / kPanel;
  const long long blk = blockIdx.x / (2 * n_panels);
  const int rem = blockIdx.x % (2 * n_panels);
  const int kind = rem / n_panels, tile = rem % n_panels;
  if (tile * kPanel == p0) return;
  const int q0 = tile * kPanel;
  T* Xb = X + blk * b * b;
  const T* Pinv = Xb + (long long)p0 * b + p0;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, c4 = lane & 3;
  if (kind == 0) {
    // rows q0.. : As = X[q0 + i][p0 + k], Bs = Pinv
    for (int e = threadIdx.x; e < kTile; e += kGThreads) {
      const int i = e >> 5, k = e & 31;
      As[i * kLdA + k] = (q0 + i < b && k < t) ? Xb[(long long)(q0 + i) * b + p0 + k] : T(0);
      Bs[i * kLdA + k] = (i < t && k < t) ? Pinv[(long long)i * b + k] : T(0);
    }
  } else {
    // columns q0.. : As = -Pinv, Bs = R = X[p0 + k][q0 + j], saved to Rs
    T* Rb = Rs + blk * kPanel * b;
    for (int e = threadIdx.x; e < kTile; e += kGThreads) {
      const int i = e >> 5, j = e & 31;
      As[i * kLdA + j] = (i < t && j < t) ? -Pinv[(long long)i * b + j] : T(0);
      const T r = (i < t && q0 + j < b) ? Xb[(long long)(p0 + i) * b + q0 + j] : T(0);
      Bs[i * kLdA + j] = r;
      if (q0 + j < b) Rb[(long long)i * b + q0 + j] = r;
    }
  }
  __syncthreads();
  // 16 output tiles of 8 x 8, two per warp
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int st = warp * 2 + h, m0 = (st >> 2) * 8, n0 = (st & 3) * 8;
    T c0 = T(0), c1 = T(0);
    Mma8<T>::run(As, kLdA, Bs, kLdA, m0, n0, c0, c1);
    const int i = m0 + g, j = n0 + 2 * c4;
    if (kind == 0) {
      if (q0 + i < b) {
        T* out = Xb + (long long)(q0 + i) * b + p0;
        if (j < t) out[j] = c0;
        if (j + 1 < t) out[j + 1] = c1;
      }
    } else if (i < t) {
      T* out = Xb + (long long)(p0 + i) * b + q0;
      if (q0 + j < b) out[j] = c0;
      if (q0 + j + 1 < b) out[j + 1] = c1;
    }
  }
}

// grid: nb * tiles * tiles CTAs, tiles = ceil(b / 64).
template <typename T>
__global__ void __launch_bounds__(kGThreads)
gj_global_update(T* __restrict__ X, const T* __restrict__ Rs, int b, int p0, int t) {
  __shared__ T As[kUTile * kLdA];   // -CP rows of the tile
  __shared__ T Bs[kPanel * kLdB];   // R columns of the tile
  const int tiles = (b + kUTile - 1) / kUTile;
  const long long blk = blockIdx.x / (tiles * tiles);
  const int rem = blockIdx.x % (tiles * tiles);
  const int r0 = (rem / tiles) * kUTile, n00 = (rem % tiles) * kUTile;
  T* Xb = X + blk * b * b;
  const T* Rb = Rs + blk * kPanel * b;
  for (int e = threadIdx.x; e < kUTile * kPanel; e += kGThreads) {
    const int i = e >> 5, k = e & 31;
    As[i * kLdA + k] = (r0 + i < b && k < t) ? -Xb[(long long)(r0 + i) * b + p0 + k] : T(0);
    const int kk = e / kUTile, j = e % kUTile;
    Bs[kk * kLdB + j] = (kk < t && n00 + j < b) ? Rb[(long long)kk * b + n00 + j] : T(0);
  }
  __syncthreads();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, c4 = lane & 3;
  const int i = r0 + warp * 8 + g;
  const bool row_ok = i < b && (i < p0 || i >= p0 + t);
#pragma unroll
  for (int nt = 0; nt < kUTile / 8; ++nt) {
    const int j = n00 + nt * 8 + 2 * c4;
    T* x = Xb + (long long)min(i, b - 1) * b;
    const bool ok0 = row_ok && j < b && (j < p0 || j >= p0 + t);
    const bool ok1 = row_ok && j + 1 < b && (j + 1 < p0 || j + 1 >= p0 + t);
    T c0 = ok0 ? x[j] : T(0), c1 = ok1 ? x[j + 1] : T(0);
    Mma8<T>::run(As, kLdA, Bs, kLdB, warp * 8, nt * 8, c0, c1);
    if (ok0) x[j] = c0;
    if (ok1) x[j + 1] = c1;
  }
}

template <typename T>
int launch_global(const void* A, void* Ainv, void* D, void* R, int nb, int b, int device,
                  void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (nb <= 0 || b <= 0) return 0;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  T* X = static_cast<T*>(Ainv);
  T* Dp = static_cast<T*>(D);
  T* Rs = static_cast<T*>(R);
  err = cudaMemcpyAsync(X, A, (size_t)nb * b * b * sizeof(T), cudaMemcpyDeviceToDevice, s);
  if (err != cudaSuccess) return (int)err;
  const int n_panels = (b + kPanel - 1) / kPanel;
  const int tiles = (b + kUTile - 1) / kUTile;
  const unsigned panel_grid = (unsigned)nb * 2u * (unsigned)n_panels;
  const unsigned update_grid = (unsigned)nb * (unsigned)tiles * (unsigned)tiles;
  for (int pi = 0; pi < n_panels; ++pi) {
    const int p0 = pi * kPanel, t = min(kPanel, b - p0);
    gj_global_sweep<T><<<nb, kThreads, 0, s>>>(X, Dp, b, p0, t);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    if (n_panels == 1) break;
    gj_global_panel<T><<<panel_grid, kGThreads, 0, s>>>(X, Rs, b, p0, t);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    gj_global_update<T><<<update_grid, kGThreads, 0, s>>>(X, Rs, b, p0, t);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

}  // namespace

extern "C" {

// Each returns the cudaError_t of the launch (0 on success).  Pointers are
// device pointers of contiguous (nb, b, b), (nb, b, b) and (nb, b) arrays;
// cs and smem come from block_ldlt_inv.py::plan; stream is a cudaStream_t of
// `device`.
int block_ldlt_inv_f32(const void* A, void* Ainv, void* D, int nb, int b, int cs,
                       int smem, int device, void* stream) {
  return launch<float>(A, Ainv, D, nb, b, cs, smem, device, stream);
}

int block_ldlt_inv_f64(const void* A, void* Ainv, void* D, int nb, int b, int cs,
                       int smem, int device, void* stream) {
  return launch<double>(A, Ainv, D, nb, b, cs, smem, device, stream);
}

// The warp variant (b <= 32): rows = next_pow2(b), grid, threads and smem
// are block_ldlt_inv.py::plan's.
int block_ldlt_inv_warp_f32(const void* A, void* Ainv, void* D, int nb, int b, int rows,
                            int grid, int threads, int smem, int device, void* stream) {
  return launch_warp_variant<float>(A, Ainv, D, nb, b, rows, grid, threads, smem, device,
                                    stream);
}

int block_ldlt_inv_warp_f64(const void* A, void* Ainv, void* D, int nb, int b, int rows,
                            int grid, int threads, int smem, int device, void* stream) {
  return launch_warp_variant<double>(A, Ainv, D, nb, b, rows, grid, threads, smem, device,
                                     stream);
}

// The device-memory variant: R is a scratch buffer of (nb, 32, b) elements.
int block_ldlt_inv_global_f32(const void* A, void* Ainv, void* D, void* R, int nb, int b,
                              int device, void* stream) {
  return launch_global<float>(A, Ainv, D, R, nb, b, device, stream);
}

int block_ldlt_inv_global_f64(const void* A, void* Ainv, void* D, void* R, int nb, int b,
                              int device, void* stream) {
  return launch_global<double>(A, Ainv, D, R, nb, b, device, stream);
}


}  // extern "C"
