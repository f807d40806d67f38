// K1: batched unpivoted LDL^T of many symmetric blocks, for Hopper.
//
// Replaces the TPU kernel ipopt_tpu/linalg/pallas_ldlt.py::_ldlt_block_kernel
// (wrapper pallas_block_ldlt).  For A of shape (nb, b, b) it writes the unit
// lower factor L (nb, b, b) and the pivots d (nb, b) of a right-looking
// elimination without pivoting.  A pivot with |d| <= FLT_MIN / DBL_MIN is
// replaced by +-tiny keeping its sign, as pallas_ldlt.py:39-40 and
// ipopt_tpu/linalg/ldlt.py:126 do; inertia is counted by the caller.
//
// What it computes, step k with sd the guarded pivot and a_i = M[i][k] for
// i > k, a_i = 0 otherwise: M[i][j] <- M[i][j] - RN(RN(a_i a_j) / sd) over
// the whole block, then M[i][k] <- RN(a_i / sd) for i > k.  Only the lower
// triangle reaches L and d, so the kernel updates only that:
//  * the live entries k < j <= i, with the quotients above;
//  * column k of the rows below it, with a_i / sd;
//  * the columns j < k of the rows below k, where the reference subtracts
//    (a_i * 0) / sd: +-0 when a_i is finite (the entry keeps its value up to
//    the sign of a zero), NaN otherwise.  The warp variant subtracts a_i * 0;
//    the others write there only where a_i is not finite, NaN where the
//    reference puts it.
// No expression is contracted into an FMA (exact_div.cuh), so the warp and
// cta variants' L and d (and the blocked variant's in float32) equal the
// plain PyTorch version (ipopt_torch/linalg/block_ldlt.py::
// block_ldlt_plain) bit for bit, with NaN in the same places and zeros equal
// up to their sign.
//
// Quotients: one reciprocal y = 1 / sd per pivot.  A pivot that is a power of
// two (the guard's +-tiny among them) has an exact y, and each quotient is
// the rounded product a y.  Otherwise y is the hardware's estimate refined
// by two Newton steps, and each quotient is Markstein's correction of a y,
// certified exactly (exact_div.cuh): inside the ranges stated at Fast below,
// the test decides exactly whether it is the rounded quotient.  A quotient
// the certificate cannot vouch for takes the library division.
//
// What bounds it: at the main path's shape (512, 7, 7) float64 the function
// reads and writes 2 * 512 * 49 * 8 B + 512 * 7 * 8 B = 430 KB, 0.13 us at
// 3.35 TB/s; each block is a chain of b dependent steps, and the latency of
// that chain, with a launch's fixed cost (1.6 us at b = 1 on an H100),
// bounds it.  The design keeps the chain in registers, spends no lane on
// dead work it can skip, and splits each row over two lanes.
//
// Three variants; the launch plan is block_ldlt.py::plan:
//  * warp (b <= 32): rows = next_pow2(b) (at least 2) rows per block and two
//    lanes per row up to 16 rows (one above), so 32 / (2 rows) blocks per
//    warp; lane (r, h) keeps the entries j = 2t + h of row r in registers
//    (b is padded to the compile-time row count, so every loop unrolls).
//    The pivot, a_r and a_j travel by segmented __shfl_sync; every lane of
//    the warp takes part in every shuffle and vote, also past the last
//    block.  The warp's contiguous blocks are loaded and stored coalesced
//    through a shared tile (no division by b).  A fast pass runs all steps
//    as straight-line code with no branch; a lane records whether its
//    every step and quotient were vouched for, and a warp in which one was
//    not (non-finite or extreme entries, a pivot out of range and not a
//    power of two) runs an exact pass from its input with the library
//    division.  Two warps per CTA at (512, 7, 7), so its 256 warps take 128
//    SMs; up to four per CTA when there are more warps than SMs.
//  * cta (b(b+1)/2 elements fit a CTA's 232,448 B of shared memory: b <= 240
//    in float64, 340 in float32): one CTA per block holds the lower triangle
//    packed column-major in shared memory.  A warp updates one column at a
//    time, its lanes on consecutive rows.  One barrier per step: column k is
//    only read in step k, and its L entries are written in step k + 1; the
//    barrier also votes (__syncthreads_or) whether column k has a
//    non-finite entry below the pivot, the only case in which the columns
//    j < k change.
//  * blocked (every wider b, and the shapes where plan's measured times
//    favour it): panels of 32 columns over many CTAs per block, the float64
//    trailing update on the FP64 tensor cores; see its note below.  The
//    warp and cta variants, and the blocked one in float32, equal the plain
//    version bit for bit; the blocked one in float64 sums the trailing
//    update in another order.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libblock_ldlt.so block_ldlt.cu
// (ipopt_torch/linalg/cuda_lib.py does this at first use).

#include <cuda_runtime.h>
#include <cfloat>

#include "dmma.cuh"
#include "exact_div.cuh"

namespace {

constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kMaxWarpsPerCta = 4;

enum Variant { kWarp = 0, kCta = 1 };

// The guarded pivot of one step and its reciprocal.
template <typename T>
struct Pivot {
  T sd, y;
  bool pow2;  // y = 1 / sd exactly
  bool in;    // sd in [Exact::plo, Exact::phi], the certificate's range
};

template <typename T>
__device__ __forceinline__ Pivot<T> pivot_of(T p) {
  Pivot<T> v;
  v.sd = safe_pivot(p);
  v.pow2 = Pow2<T>::is(v.sd);
  const T a = fabs(v.sd);
  v.in = (a >= Exact<T>::plo) & (a <= Exact<T>::phi);
  v.y = v.pow2 ? Pow2<T>::recip(v.sd) : recip_estimate(v.sd);
  return v;
}

// The library division, out of line: rare, and one copy of its code keeps
// the kernels' instructions in cache.
template <typename T>
__device__ __noinline__ T div_slow(T a, T b) {
  return div_rn(a, b);
}

// A quotient needs no library division when its pivot is a power of two
// (exact reciprocal), or when the pivot lies in Exact's divisor range
// [plo, phi] and its numerator is 0 or in [lo^2, hi^2] (a product of two
// values that are 0 or in [lo, hi], or one such value): then the quotient
// lies in [lo^2 / phi, hi^2 / plo], and the certificate's half ulp times
// the pivot is a normal number, so every residual and every test is exact.
template <typename T> struct Fast;
template <> struct Fast<double> {
  static constexpr double lo = 0x1p-200, hi = 0x1p200;
};
template <> struct Fast<float> {
  static constexpr float lo = 0x1p-20f, hi = 0x1p20f;
};

template <typename T>
__device__ __forceinline__ bool fast_operand(T a) {
  const T aa = fabs(a);
  return (a == T(0)) | ((aa >= Fast<T>::lo) & (aa <= Fast<T>::hi));
}

template <typename T>
__device__ __forceinline__ bool fast_numerator(T num) {
  const T an = fabs(num);
  return (num == T(0)) |
         ((an >= Fast<T>::lo * Fast<T>::lo) & (an <= Fast<T>::hi * Fast<T>::hi));
}

// RN(num / sd) from y: the exact product num y for a power-of-two pivot,
// else Markstein's correction of num y; good turns false where the
// certificate cannot vouch for it.  Inside the ranges above it decides
// exactly whether q1 is the rounded quotient; the caller checks the
// ranges.  No branch.
template <typename T>
__device__ __forceinline__ T quot_fast(T num, const Pivot<T>& v, bool& good) {
  const T q = mul_rn(num, v.y);
  const T q1 = fma(fma(-v.sd, q, num), v.y, q);
  const T r1 = fma(-v.sd, q1, num);
  good = v.pow2 | (r1 == T(0)) | Exact<T>::rn(q1, r1, v.sd);
  return v.pow2 ? q : q1;
}

// The fast quotient and whether the ranges and the certificate vouch for
// it (ok turns false where not).  No branch.
template <typename T>
__device__ __forceinline__ T quot_try(T num, const Pivot<T>& v, bool& ok) {
  bool good;
  const T q = quot_fast(num, v, good);
  ok &= v.pow2 | (v.in & fast_numerator(num) & good);
  return q;
}

// RN(num / sd) for the CTA variants: the fast quotient where the ranges and
// the certificate vouch for it, else the library division.
template <typename T>
__device__ __forceinline__ T quot_cta(T num, const Pivot<T>& v) {
  bool good;
  const T q = quot_fast(num, v, good);
  if (v.pow2 | (v.in & fast_numerator(num) & good)) return q;
  return div_slow(num, v.sd);
}

// Warp variant: P rows per block (a power of two, b <= P), H lanes per row,
// W = P H lanes per block, 32 / W blocks per warp.  Lane (r, h) of a block
// keeps the entries M[r][j], j = t H + h, of row r in registers m[t].
template <typename T, int P, int H>
__global__ void __launch_bounds__(32 * kMaxWarpsPerCta)
ldlt_warp_kernel(const T* __restrict__ A, T* __restrict__ L,
                 T* __restrict__ D, int nb, int b) {
  constexpr int W = P * H;
  constexpr int G = 32 / W;  // blocks per warp
  constexpr int C = P / H;   // entries per lane
  static_assert(W <= 32 && C >= 1, "a block's lanes fit a warp");
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

  const int seg = lane / W, rem = lane % W, r = rem / H, h = rem % H;
  const bool row = seg < nblk && r < b;
  T* Sr = S + (seg * b + r) * b;
  T m[C];
#pragma unroll
  for (int t = 0; t < C; ++t) {
    const int j = t * H + h;
    m[t] = (row && j <= r) ? Sr[j] : T(0);
  }

  // Fast pass: straight-line code, no branch and no vote inside, so the
  // compiler overlaps the steps' independent quotients.  good records
  // whether this lane's every step and quotient were vouched for.
  bool good = true;
#pragma unroll
  for (int k = 0; k < P; ++k) {
    if (k >= b) break;  // uniform
    const int tk = k / H, hk = k % H;  // M[r][k] is m[tk] of lane (r, hk)
    const T piv = __shfl_sync(kFullMask, m[tk], k * H + hk, W);
    const T ar = __shfl_sync(kFullMask, m[tk], r * H + hk, W);
    const Pivot<T> pv = pivot_of(piv);
    const bool below = r > k;
    const T a = below ? ar : T(0);
    good &= pv.pow2 | (pv.in & fast_operand(a));
    const T q0 = mul_rn(a, T(0));  // (a * 0) / sd, up to the sign of a zero
#pragma unroll
    for (int t = 0; t < C; ++t) {
      const int j = t * H + h;
      if (t < tk) {  // j < k
        if (below) m[t] = sub_rn(m[t], q0);
        continue;
      }
      const T aj = __shfl_sync(kFullMask, a, j * H, W);
      const T num = j == k ? a : mul_rn(a, aj);
      bool g;
      const T q = quot_fast(num, pv, g);
      good &= g | (j < k) | (j > r);  // only k <= j <= r is read
      if (below) {
        if (j < k) m[t] = sub_rn(m[t], q0);
        else if (j == k) m[t] = q;
        else if (j <= r) m[t] = sub_rn(m[t], q);
      }
    }
  }

  // Exact pass, for a warp in which some lane was not vouched for (non-finite
  // or extreme entries, a pivot outside the range): the same steps from the
  // input, every quotient by the library division.  Rolled, to keep its
  // code small.
  if (__any_sync(kFullMask, !good)) {
#pragma unroll
    for (int t = 0; t < C; ++t) {
      const int j = t * H + h;
      m[t] = (row && j <= r) ? Sr[j] : T(0);
    }
    for (int k = 0; k < b; ++k) {
      const int tk = k / H, hk = k % H;
      T own = m[0];
#pragma unroll
      for (int t = 1; t < C; ++t)
        if (t == tk) own = m[t];
      const T sd = safe_pivot(__shfl_sync(kFullMask, own, k * H + hk, W));
      const T ar = __shfl_sync(kFullMask, own, r * H + hk, W);
      const bool below = r > k;
      const T a = below ? ar : T(0);
      const T q0 = mul_rn(a, T(0));
#pragma unroll
      for (int t = 0; t < C; ++t) {
        const int j = t * H + h;
        const T aj = __shfl_sync(kFullMask, a, j * H, W);
        if (below) {
          if (j < k) m[t] = sub_rn(m[t], q0);
          else if (j == k) m[t] = div_slow(a, sd);
          else if (j <= r) m[t] = sub_rn(m[t], div_slow(mul_rn(a, aj), sd));
        }
      }
    }
  }

  __syncwarp();
  if (row) {
    T dr = T(0);
#pragma unroll
    for (int t = 0; t < C; ++t) {
      const int j = t * H + h;
      if (j < b) Sr[j] = j < r ? m[t] : (j == r ? T(1) : T(0));
      if (j == r) dr = m[t];
    }
    if (h == r % H) D[(first + seg) * b + r] = dr;
  }
  __syncwarp();
  T* Lw = L + first * bb;
  for (int e = lane; e < count; e += 32) Lw[e] = S[e];
}

// Column j of the working lower triangle, packed column-major in shared
// memory, indexed by the row i >= j.
template <typename T>
__device__ __forceinline__ T* column(T* S, int j, int b) {
  return S + (long long)j * b - (((long long)j * (j + 1)) >> 1);
}

// CTA variant: one CTA per block.
template <typename T>
__global__ void __launch_bounds__(1024)
ldlt_tri_kernel(const T* __restrict__ A, T* __restrict__ L,
                T* __restrict__ D, int b) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const long long bb = (long long)b * b;
  const T* Ab = A + blockIdx.x * bb;
  T* Lb = L + blockIdx.x * bb;
  T* S = reinterpret_cast<T*>(smem_raw);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  for (int i = warp; i < b; i += nw) {
    const T* Ai = Ab + (long long)i * b;
    for (int j = lane; j <= i; j += 32) column(S, j, b)[i] = Ai[j];
  }

  Pivot<T> prev{};
  bool flag = false;  // this thread wrote a non-finite entry below the next pivot
  for (int k = 0; k < b; ++k) {
    const bool nonfinite = __syncthreads_or(flag);
    flag = false;
    T* ck = column(S, k, b);
    const Pivot<T> pv = pivot_of(ck[k]);
    if (k > 0) {
      // column k - 1's L entries, and the NaN of a non-finite a_i in the
      // columns j < k of its row
      T* cp = column(S, k - 1, b);
      for (int i = k + threadIdx.x; i < b; i += blockDim.x) {
        cp[i] = quot_cta(cp[i], prev);
        if (nonfinite && i > k) {
          const T q0 = mul_rn(ck[i], T(0));  // NaN exactly where a_i is not finite
          if (q0 != q0) {
            for (int j = 0; j < k; ++j) {
              T* cj = column(S, j, b);
              cj[i] = sub_rn(cj[i], q0);
            }
          }
        }
      }
    }
    for (int j = k + 1 + warp; j < b; j += nw) {
      T* cj = column(S, j, b);
      const T aj = ck[j];
      for (int i = j + lane; i < b; i += 32) {
        const T v = sub_rn(cj[i], quot_cta(mul_rn(ck[i], aj), pv));
        cj[i] = v;
        flag |= (j == k + 1) & (i > j) & !isfinite(v);
      }
    }
    prev = pv;
  }
  __syncthreads();

  T* Db = D + (long long)blockIdx.x * b;
  for (int i = warp; i < b; i += nw) {
    T* Li = Lb + (long long)i * b;
    for (int j = lane; j < b; j += 32)
      Li[j] = j < i ? column(S, j, b)[i] : (j == i ? T(1) : T(0));
  }
  for (int i = threadIdx.x; i < b; i += blockDim.x) Db[i] = column(S, i, b)[i];
}

// ---------------------------------------------------------------------------
// Blocked variant: the right-looking order of ipopt_tpu/linalg/ldlt.py::
// ldlt_blocked, with panels of t = 32 columns (the last may be ragged), each
// block spread over many CTAs.  The working lower triangle lives in the
// output L itself (row-major, entry (i, j) at L[i][j], j <= i); W (nb, b, 32)
// holds the current panel's unscaled columns.  One call launches:
//   0. ldlt_blocked_init: L <- the lower triangle of A, zeros above.
//   per panel p0 (width t, q0 = p0 + t the first row below it):
//   1. ldlt_blocked_panel, nb x strips CTAs.  Every CTA factors the t x t
//      diagonal tile in shared memory: the CTA variant's steps (a warp per
//      rows, a lane per column, one barrier per step), which leave each
//      column's unscaled entries a_j (the values at its own step) in place.
//      Then each warp runs the same t steps on rows of its strip below the
//      tile, a lane per panel column, with no barrier: a_i = M[i][k],
//      L[i][k] = RN(a_i / sd), M[i][j] -= RN(RN(a_i a_j) / sd) for the
//      panel's j > k, a_j read from the tile.  So every entry of the panel's
//      columns is the plain version's, bit for bit.  It writes the strip's L
//      entries, and its unscaled a_i^k to W; CTA 0 writes the tile's L and d.
//   2. ldlt_blocked_update, nb x (the 64 x 64 tiles on or below the trailing
//      matrix's diagonal) CTAs, on q0 <= j <= i.  float64: M[i][j] -= sum_k
//      a_i^k RN(a_j^k / sd_k) over the panel, that is A22 -= W21 L21^T with
//      the guarded pivot, as the plain version subtracts a a^T / sd
//      (block_ldlt.py:94), on the FP64 tensor cores (mma.sync m8n8k4 f64,
//      K2's fragment layout); it sums in another order than the rank-1 loop,
//      so the float64 variant is not bit-equal to the plain version, and
//      chip_smoke.py holds it by the finite pattern, the inertia and the
//      backward error.  float32: the plain version's steps, M[i][j] -=
//      RN(RN(a_i^k a_j^k) / sd_k) for each k in order (IEEE, no FMA, no
//      TF32), so the float32 variant equals the plain version bit for bit.
// Non-finite entries follow the plain version: the strip NaNs a row's
// earlier columns where one of its a_i^k is not finite, and a product with
// inf or NaN is inf or NaN in any summation order.
// What bounds it: at (1, 1726) float64 the function does ~b^3 / 3 multiply-
// adds (2.57 G operations with the quotients, 0.038 ms at 67 TFLOP/s), and
// the panels are a chain of b / 32 dependent steps, two launches each.
// ---------------------------------------------------------------------------

constexpr int kPanelT = 32;          // panel width t
constexpr int kBThreads = 256;       // threads of the panel and update kernels
constexpr int kBWarps = kBThreads / 32;
constexpr int kTileLd = kPanelT + 1;  // row stride of the t x t tile in shared memory
constexpr int kStripRows = 2;        // rows of the strip a warp steps at once
constexpr int kStrip = kBWarps * kStripRows;  // rows of the strip a CTA takes
constexpr int kUTile = 64;           // output tile of the trailing update
constexpr int kULd = kPanelT + 4;    // row stride of its operands in shared memory
constexpr int kInitGrid = 1024;      // CTAs of the init, a grid-stride copy

template <typename T>
__device__ __forceinline__ T quiet_nan();
template <>
__device__ __forceinline__ double quiet_nan<double>() { return __longlong_as_double(0x7ff8000000000000LL); }
template <>
__device__ __forceinline__ float quiet_nan<float>() { return __int_as_float(0x7fc00000); }

template <typename T>
__global__ void __launch_bounds__(kBThreads)
ldlt_blocked_init(const T* __restrict__ A, T* __restrict__ L, long long total, int b) {
  for (long long e = blockIdx.x * (long long)blockDim.x + threadIdx.x; e < total;
       e += (long long)gridDim.x * blockDim.x) {
    const long long row = e / b;
    const int j = (int)(e - row * b), i = (int)(row % b);
    L[e] = j <= i ? A[e] : T(0);
  }
}

// grid: nb * strips CTAs; CTA c of block blk takes the kStrip rows
// [q0 + c kStrip, q0 + (c + 1) kStrip) below the panel, kStripRows per warp.
// One loop of t + 1 steps, one barrier each: step k runs the tile's step k
// (thread (warp, lane) owns column lane of the tile rows 4 warp .. 4 warp +
// 3; a warp whose rows are all at or above the pivot skips it) and the
// strip's step k - 1 (lane j on column p0 + j of the warp's rows), whose
// tile column k - 1 the tile's step k - 1 finished and step k does not
// write.  The kernel is bound by the instructions of its certified
// quotients, so a step computes only rows that change.  Every quotient of a
// step is computed without a branch; the library division runs only where
// one was not vouched for.
template <typename T>
__global__ void __launch_bounds__(kBThreads)
ldlt_blocked_panel(T* __restrict__ L, T* __restrict__ D, T* __restrict__ W, int b,
                   int p0, int t, int strips) {
  __shared__ T St[kPanelT * kTileLd];  // the tile; column k holds a_j^k after step k
  __shared__ T Lt[kPanelT * kTileLd];  // the tile's L entries
  __shared__ unsigned char Snf[kPanelT];
  const long long blk = blockIdx.x / strips;
  const int c = blockIdx.x % strips;
  const long long bb = (long long)b * b;
  T* Lb = L + blk * bb;
  T* Wb = W + blk * (long long)b * kPanelT;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  constexpr int kRowsPerWarp = kPanelT / kBWarps;
  const int q0 = p0 + t;

#pragma unroll
  for (int m = 0; m < kRowsPerWarp; ++m) {
    const int r = kRowsPerWarp * warp + m;
    St[r * kTileLd + lane] =
        (r < t && lane <= r) ? Lb[(long long)(p0 + r) * b + p0 + lane] : T(0);
    Lt[r * kTileLd + lane] = T(0);
  }
  if (threadIdx.x < kPanelT) Snf[threadIdx.x] = 0;
  // the strip: x keeps M[i][p0 + j] (a_i^j once its step has passed), l the
  // L entry
  const int i0 = q0 + c * kStrip + warp * kStripRows;
  T x[kStripRows], l[kStripRows];
  bool nf[kStripRows];
#pragma unroll
  for (int u = 0; u < kStripRows; ++u) {
    x[u] = (i0 + u < b && lane < t) ? Lb[(long long)(i0 + u) * b + p0 + lane] : T(0);
    l[u] = T(0);
    nf[u] = false;
  }

  Pivot<T> prev{};
  for (int k = 0; k <= t; ++k) {
    __syncthreads();
    const bool tile = k < t, strip = k > 0;
    const int kt = tile ? k : t - 1;
    const Pivot<T> pv = pivot_of(St[kt * (kTileLd + 1)]);
    // tile step k: rows r > k, columns k <= lane <= r; uniform over the warp
    const bool rows = tile && kRowsPerWarp * warp + kRowsPerWarp - 1 > k &&
                      kRowsPerWarp * warp < t;
    const T aj = St[lane * kTileLd + kt];
    T ar[kRowsPerWarp], tn[kRowsPerWarp], tq[kRowsPerWarp];
    bool ok = true;
    if (rows) {
#pragma unroll
      for (int m = 0; m < kRowsPerWarp; ++m) {
        const int r = kRowsPerWarp * warp + m;
        ar[m] = (r > k && r < t) ? St[r * kTileLd + kt] : T(0);
        tn[m] = lane == k ? ar[m] : mul_rn(ar[m], aj);
        tq[m] = quot_try(tn[m], pv, ok);
      }
    }
    // strip step k - 1: lanes k - 1 < j < t, for a warp with rows below b
    // (uniform over the warp)
    const bool srows = strip && i0 < b;
    const int ks = strip ? k - 1 : 0;
    const T sj = (srows && lane > ks && lane < t) ? St[lane * kTileLd + ks] : T(0);
    T a[kStripRows], sn[kStripRows], sq[kStripRows];
    if (srows) {
#pragma unroll
      for (int u = 0; u < kStripRows; ++u) {
        a[u] = __shfl_sync(kFullMask, x[u], ks);
        sn[u] = lane == ks ? a[u] : mul_rn(a[u], sj);
        sq[u] = quot_try(sn[u], prev, ok);
      }
    }
    if (!ok) {
      if (rows) {
#pragma unroll
        for (int m = 0; m < kRowsPerWarp; ++m) tq[m] = div_slow(tn[m], pv.sd);
      }
      if (srows) {
#pragma unroll
        for (int u = 0; u < kStripRows; ++u) sq[u] = div_slow(sn[u], prev.sd);
      }
    }
    if (rows) {
#pragma unroll
      for (int m = 0; m < kRowsPerWarp; ++m) {
        const int r = kRowsPerWarp * warp + m;
        if (r <= k || r >= t) continue;
        if (lane > k && lane <= r) {
          St[r * kTileLd + lane] = sub_rn(St[r * kTileLd + lane], tq[m]);
        } else if (lane == k) {
          Lt[r * kTileLd + k] = tq[m];
        } else if (lane < k && !isfinite(ar[m])) {
          Lt[r * kTileLd + lane] = quiet_nan<T>();
        }
        if (lane == 0 && !isfinite(ar[m])) Snf[r] = 1;
      }
    }
    if (srows) {
#pragma unroll
      for (int u = 0; u < kStripRows; ++u) {
        if (lane > ks && lane < t) {
          x[u] = sub_rn(x[u], sq[u]);
        } else if (lane == ks) {
          l[u] = sq[u];
        } else if (lane < ks && !isfinite(a[u])) {
          l[u] = quiet_nan<T>();
        }
        nf[u] |= !isfinite(a[u]);
      }
    }
    prev = pv;
  }
  __syncthreads();

  if (c == 0) {
    // the tile's L entries, unit diagonal and zeros above; its pivots; the
    // NaN of a row with a non-finite a_r^k in its columns before the panel.
    // The other CTAs of the launch may still be reading the tile from L, so
    // unless this CTA is alone (the last panel) its L goes to the tile's
    // rows of W, which the trailing update then copies into L.
    const bool alone = q0 == b;
#pragma unroll
    for (int m = 0; m < kRowsPerWarp; ++m) {
      const int r = kRowsPerWarp * warp + m;
      if (r >= t) continue;
      T* Li = Lb + (long long)(p0 + r) * b;
      if (lane < t) {
        const T v = lane < r ? Lt[r * kTileLd + lane] : (lane == r ? T(1) : T(0));
        if (alone)
          Li[p0 + lane] = v;
        else
          Wb[(long long)(p0 + r) * kPanelT + lane] = v;
      }
      if (Snf[r])
        for (int j = lane; j < p0; j += 32) Li[j] = quiet_nan<T>();
    }
    if (threadIdx.x < t) D[blk * b + p0 + threadIdx.x] = St[threadIdx.x * kTileLd + threadIdx.x];
  }

  // the strip's L entries and unscaled columns; the NaN of a row with a
  // non-finite a_i^k in its columns before the panel
#pragma unroll
  for (int u = 0; u < kStripRows; ++u) {
    const int i = i0 + u;
    if (i >= b) continue;
    T* Li = Lb + (long long)i * b;
    if (lane < t) {
      Li[p0 + lane] = l[u];
      Wb[(long long)i * kPanelT + lane] = x[u];
    }
    if (nf[u])  // uniform over the warp: a[u] is the same in every lane
      for (int j = lane; j < p0; j += 32) Li[j] = quiet_nan<T>();
  }
}

// The panel's pivots, as pivot_of gives them, for the float32 update.
template <typename T>
struct PanelPivots {
  T sd[kPanelT], y[kPanelT];
  unsigned char pow2[kPanelT], in[kPanelT];
};

// The trailing update of one 64 x 64 tile (ti, tj), tj <= ti, of block blk,
// from the tile rows' a_i^k (Ws) and the tile columns' Cs.
template <typename T> struct TrailingUpdate;

// float64: Cs = L[j][p0 + k], C[i][j] += sum_k (-W[i][k]) L[j][k] on the FP64
// tensor cores.
template <> struct TrailingUpdate<double> {
  static constexpr bool kScaledColumns = true;
  static __device__ void run(double* C, long long ldc, const double* Ws,
                             const double* Ls, int rows, int cols, bool diag, int,
                             const PanelPivots<double>&) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int g = lane >> 2, c4 = lane & 3;
    // warp w owns the 8 output rows 8 w .. 8 w + 7 of the tile
    double af[kPanelT / 4];
#pragma unroll
    for (int s = 0; s < kPanelT / 4; ++s) af[s] = -Ws[(8 * warp + g) * kULd + 4 * s + c4];
    const int i = 8 * warp + g;
#pragma unroll
    for (int nt = 0; nt < kUTile / 8; ++nt) {
      if (diag && nt > warp) break;  // above the block's diagonal
      const int j0 = 8 * nt + 2 * c4;
      const bool ok0 = i < rows && j0 < cols && (!diag || j0 <= i);
      const bool ok1 = i < rows && j0 + 1 < cols && (!diag || j0 + 1 <= i);
      double* Ci = C + (long long)min(i, rows - 1) * ldc;
      double c0 = ok0 ? Ci[j0] : 0.0, c1 = ok1 ? Ci[j0 + 1] : 0.0;
#pragma unroll
      for (int s = 0; s < kPanelT / 4; ++s)
        dmma(c0, c1, af[s], Ls[(8 * nt + g) * kULd + 4 * s + c4]);
      if (ok0) Ci[j0] = c0;
      if (ok1) Ci[j0 + 1] = c1;
    }
  }
};

// float32: Cs = the columns' a_j^k, and each entry takes the plain version's
// steps in order, C[i][j] -= RN(RN(a_i^k a_j^k) / sd_k) for k = 0 .. t - 1,
// so the float32 variant equals the plain version bit for bit.  Summed in
// another order (FFMA), float32's rounding decided pivot signs on blocks
// with large element growth, and the inertia differed from the plain
// version's.  Thread (ty, tx) of 16 x 16 owns rows 4 ty .. 4 ty + 3, columns
// 4 tx .. 4 tx + 3.
template <> struct TrailingUpdate<float> {
  static constexpr bool kScaledColumns = false;
  static __device__ void run(float* C, long long ldc, const float* Ws,
                             const float* Cs, int rows, int cols, bool diag, int t,
                             const PanelPivots<float>& pp) {
    const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
    if (diag && tx > ty) return;
    float acc[4][4];
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        const int i = 4 * ty + u, j = 4 * tx + v;
        acc[u][v] = (i < rows && j < cols) ? C[(long long)i * ldc + j] : 0.0f;
      }
    for (int k = 0; k < t; ++k) {
      Pivot<float> pv;
      pv.sd = pp.sd[k];
      pv.y = pp.y[k];
      pv.pow2 = pp.pow2[k];
      pv.in = pp.in[k];
      float a[4], w[4], num[4][4], q[4][4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        a[u] = Ws[(4 * ty + u) * kULd + k];
        w[u] = Cs[(4 * tx + u) * kULd + k];
      }
      bool ok = true;
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int v = 0; v < 4; ++v) {
          num[u][v] = mul_rn(a[u], w[v]);
          q[u][v] = quot_try(num[u][v], pv, ok);
        }
      if (!ok) {
#pragma unroll
        for (int u = 0; u < 4; ++u)
#pragma unroll
          for (int v = 0; v < 4; ++v) q[u][v] = div_slow(num[u][v], pv.sd);
      }
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int v = 0; v < 4; ++v) acc[u][v] = sub_rn(acc[u][v], q[u][v]);
    }
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        const int i = 4 * ty + u, j = 4 * tx + v;
        if (i < rows && j < cols && (!diag || j <= i)) C[(long long)i * ldc + j] = acc[u][v];
      }
  }
};

// grid: nb * nt (nt + 1) / 2 CTAs, nt = ceil((b - q0) / 64): the tiles on or
// below the trailing matrix's diagonal, row by row.
template <typename T>
__global__ void __launch_bounds__(kBThreads)
ldlt_blocked_update(T* __restrict__ L, const T* __restrict__ D, const T* __restrict__ W,
                    int b, int p0, int t) {
  __shared__ __align__(16) T Ws[kUTile * kULd];  // a_i^k of the tile's rows
  __shared__ __align__(16) T Cs[kUTile * kULd];  // its columns' L[j][p0 + k] or a_j^k
  __shared__ PanelPivots<T> pp;
  const int q0 = p0 + t;
  const int m = b - q0;
  const int nt = (m + kUTile - 1) / kUTile;
  const int per = nt * (nt + 1) / 2;
  const long long blk = blockIdx.x / per;
  int rem = blockIdx.x % per;
  int ti = 0;
  while (rem > ti) rem -= ++ti;  // rem = ti (ti + 1) / 2 + tj, tj <= ti
  const int tj = rem;
  const int r0 = q0 + ti * kUTile, c0 = q0 + tj * kUTile;
  T* Lb = L + blk * (long long)b * b;
  const T* Wb = W + blk * (long long)b * kPanelT;
  for (int e = threadIdx.x; e < kUTile * kPanelT; e += kBThreads) {
    const int r = e / kPanelT, k = e % kPanelT;
    Ws[r * kULd + k] = (r0 + r < b && k < t) ? Wb[(long long)(r0 + r) * kPanelT + k] : T(0);
    const bool in = c0 + r < b && k < t;
    Cs[r * kULd + k] = !in ? T(0)
                           : (TrailingUpdate<T>::kScaledColumns
                                  ? Lb[(long long)(c0 + r) * b + p0 + k]
                                  : Wb[(long long)(c0 + r) * kPanelT + k]);
  }
  if (!TrailingUpdate<T>::kScaledColumns && threadIdx.x < t) {
    const Pivot<T> pv = pivot_of(D[blk * b + p0 + threadIdx.x]);
    pp.sd[threadIdx.x] = pv.sd;
    pp.y[threadIdx.x] = pv.y;
    pp.pow2[threadIdx.x] = pv.pow2;
    pp.in[threadIdx.x] = pv.in;
  }
  if (ti == 0 && tj == 0) {
    // the panel's diagonal tile, staged in W's tile rows by the panel launch
    for (int e = threadIdx.x; e < t * t; e += kBThreads) {
      const int r = e / t, j = e % t;
      Lb[(long long)(p0 + r) * b + p0 + j] = Wb[(long long)(p0 + r) * kPanelT + j];
    }
  }
  __syncthreads();
  TrailingUpdate<T>::run(Lb + (long long)r0 * b + c0, b, Ws, Cs, min(kUTile, b - r0),
                         min(kUTile, b - c0), ti == tj, t, pp);
}

template <typename T, int P, int H>
cudaError_t launch_warp(const T* a, T* l, T* d, int nb, int b, int grid,
                        int threads, int smem, cudaStream_t s) {
  ldlt_warp_kernel<T, P, H><<<grid, threads, smem, s>>>(a, l, d, nb, b);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_tri(const T* a, T* l, T* d, int b, int grid, int threads,
                       int smem, cudaStream_t s) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        ldlt_tri_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  ldlt_tri_kernel<T><<<grid, threads, smem, s>>>(a, l, d, b);
  return cudaGetLastError();
}

template <typename T>
int launch(const void* A, void* L, void* D, int nb, int b, int variant,
           int rows, int lanes, int grid, int threads, int smem, int device,
           void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (nb <= 0 || b <= 0) return 0;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const T* a = static_cast<const T*>(A);
  T* l = static_cast<T*>(L);
  T* d = static_cast<T*>(D);
  switch (variant) {
    case kWarp:
      if (b > rows) return (int)cudaErrorInvalidValue;
      switch (rows * 64 + lanes) {
        case 2 * 64 + 4: return (int)launch_warp<T, 2, 2>(a, l, d, nb, b, grid, threads, smem, s);
        case 4 * 64 + 8: return (int)launch_warp<T, 4, 2>(a, l, d, nb, b, grid, threads, smem, s);
        case 8 * 64 + 16: return (int)launch_warp<T, 8, 2>(a, l, d, nb, b, grid, threads, smem, s);
        case 16 * 64 + 32: return (int)launch_warp<T, 16, 2>(a, l, d, nb, b, grid, threads, smem, s);
        case 32 * 64 + 32: return (int)launch_warp<T, 32, 1>(a, l, d, nb, b, grid, threads, smem, s);
        default: return (int)cudaErrorInvalidValue;
      }
    case kCta:
      return (int)launch_tri<T>(a, l, d, b, grid, threads, smem, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// The blocked variant: 2 ceil(b / 32) launches in stream order (the init,
// then per panel its strip and, but for the last panel, the trailing update).
// W is a scratch buffer of (nb, b, 32) elements.
template <typename T>
int launch_blocked(const void* A, void* L, void* D, void* W, int nb, int b, int device,
                   void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (nb <= 0 || b <= 0) return 0;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  T* l = static_cast<T*>(L);
  T* d = static_cast<T*>(D);
  T* w = static_cast<T*>(W);
  const long long total = (long long)nb * b * b;
  const long long want = (total + kBThreads - 1) / kBThreads;
  const int init_grid = (int)(want < kInitGrid ? want : kInitGrid);
  ldlt_blocked_init<T><<<init_grid, kBThreads, 0, s>>>(static_cast<const T*>(A), l, total, b);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  for (int p0 = 0; p0 < b; p0 += kPanelT) {
    const int t = b - p0 < kPanelT ? b - p0 : kPanelT;
    const int m = b - p0 - t;
    const int strips = m > 0 ? (m + kStrip - 1) / kStrip : 1;
    const long long pgrid = (long long)nb * strips;
    if (pgrid >= (1LL << 31)) return (int)cudaErrorInvalidValue;
    ldlt_blocked_panel<T><<<(unsigned)pgrid, kBThreads, 0, s>>>(l, d, w, b, p0, t, strips);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    if (m == 0) break;
    const int nt = (m + kUTile - 1) / kUTile;
    const long long ugrid = (long long)nb * (nt * (nt + 1) / 2);
    if (ugrid >= (1LL << 31)) return (int)cudaErrorInvalidValue;
    ldlt_blocked_update<T><<<(unsigned)ugrid, kBThreads, 0, s>>>(l, d, w, b, p0, t);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

}  // namespace

extern "C" {

// Each returns the cudaError_t of the launch (0 on success).  Pointers are
// device pointers of contiguous (nb, b, b), (nb, b, b) and (nb, b) arrays;
// variant, rows, lanes, grid, threads and smem are block_ldlt.py::plan's;
// stream is a cudaStream_t of `device`.
int block_ldlt_f32(const void* A, void* L, void* D, int nb, int b, int variant,
                   int rows, int lanes, int grid, int threads, int smem,
                   int device, void* stream) {
  return launch<float>(A, L, D, nb, b, variant, rows, lanes, grid, threads,
                        smem, device, stream);
}

int block_ldlt_f64(const void* A, void* L, void* D, int nb, int b, int variant,
                   int rows, int lanes, int grid, int threads, int smem,
                   int device, void* stream) {
  return launch<double>(A, L, D, nb, b, variant, rows, lanes, grid, threads,
                         smem, device, stream);
}

// The blocked variant; W is (nb, b, 32) scratch.
int block_ldlt_blocked_f32(const void* A, void* L, void* D, void* W, int nb, int b,
                           int device, void* stream) {
  return launch_blocked<float>(A, L, D, W, nb, b, device, stream);
}

int block_ldlt_blocked_f64(const void* A, void* L, void* D, void* W, int nb, int b,
                           int device, void* stream) {
  return launch_blocked<double>(A, L, D, W, nb, b, device, stream);
}

}  // extern "C"
