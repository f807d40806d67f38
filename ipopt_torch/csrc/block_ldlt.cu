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
// No expression is contracted into an FMA (exact_div.cuh), so L and d equal
// the plain PyTorch version (ipopt_torch/linalg/block_ldlt.py::
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
//  * global (larger b): the same steps with the triangle column-major in the
//    output buffer L itself (entry (i, j) at L[j][i], i >= j), in device
//    memory (the 50 MB L2 holds a block up to b ~ 2,500 in float64); at the
//    end each thread moves its pairs (L[j][i] -> L[i][j], 0 -> L[j][i]) and
//    the diagonal to d.  Slow, one SM per block; it exists so that the dense
//    backend factors every KKT size the reference factors.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libblock_ldlt.so block_ldlt.cu
// (ipopt_torch/linalg/cuda_lib.py does this at first use).

#include <cuda_runtime.h>
#include <cfloat>

#include "exact_div.cuh"

namespace {

constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kMaxWarpsPerCta = 4;

enum Variant { kWarp = 0, kCta = 1, kGlobal = 2 };

// The guarded pivot of one step and its reciprocal.
template <typename T>
struct Pivot {
  T sd, y;
  bool pow2;  // y = 1 / sd exactly
  bool in;    // sd in [Exact::plo, Exact::phi], the certificate's range
};

// An estimate of 1 / s within about an ulp: two Newton steps from the
// hardware's approximation.  It need not be correctly rounded: the
// certificate checks every quotient exactly.
__device__ __forceinline__ double recip_estimate(double s) {
  double y;
  asm("rcp.approx.ftz.f64 %0, %1;" : "=d"(y) : "d"(s));
  double e = fma(-s, y, 1.0);
  y = fma(y, e, y);
  e = fma(-s, y, 1.0);
  return fma(y, e, y);
}
__device__ __forceinline__ float recip_estimate(float s) { return __frcp_rn(s); }

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

// Column j of the working lower triangle, indexed by the row i >= j: packed
// column-major in shared memory, or column-major b x b (that is, the upper
// triangle of the row-major output) in device memory.
template <typename T, bool kShared>
__device__ __forceinline__ T* column(T* S, int j, int b) {
  return S + (kShared ? (long long)j * b - (((long long)j * (j + 1)) >> 1)
                      : (long long)j * b);
}

// CTA and global variants: one CTA per block.
template <typename T, bool kShared>
__global__ void __launch_bounds__(1024)
ldlt_tri_kernel(const T* __restrict__ A, T* __restrict__ L,
                T* __restrict__ D, int b) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const long long bb = (long long)b * b;
  const T* Ab = A + blockIdx.x * bb;
  T* Lb = L + blockIdx.x * bb;
  T* S = kShared ? reinterpret_cast<T*>(smem_raw) : Lb;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  for (int i = warp; i < b; i += nw) {
    const T* Ai = Ab + (long long)i * b;
    for (int j = lane; j <= i; j += 32) column<T, kShared>(S, j, b)[i] = Ai[j];
  }

  Pivot<T> prev{};
  bool flag = false;  // this thread wrote a non-finite entry below the next pivot
  for (int k = 0; k < b; ++k) {
    const bool nonfinite = __syncthreads_or(flag);
    flag = false;
    T* ck = column<T, kShared>(S, k, b);
    const Pivot<T> pv = pivot_of(ck[k]);
    if (k > 0) {
      // column k - 1's L entries, and the NaN of a non-finite a_i in the
      // columns j < k of its row
      T* cp = column<T, kShared>(S, k - 1, b);
      for (int i = k + threadIdx.x; i < b; i += blockDim.x) {
        cp[i] = quot_cta(cp[i], prev);
        if (nonfinite && i > k) {
          const T q0 = mul_rn(ck[i], T(0));  // NaN exactly where a_i is not finite
          if (q0 != q0) {
            for (int j = 0; j < k; ++j) {
              T* cj = column<T, kShared>(S, j, b);
              cj[i] = sub_rn(cj[i], q0);
            }
          }
        }
      }
    }
    for (int j = k + 1 + warp; j < b; j += nw) {
      T* cj = column<T, kShared>(S, j, b);
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
  if (kShared) {
    for (int i = warp; i < b; i += nw) {
      T* Li = Lb + (long long)i * b;
      for (int j = lane; j < b; j += 32)
        Li[j] = j < i ? column<T, kShared>(S, j, b)[i] : (j == i ? T(1) : T(0));
    }
    for (int i = threadIdx.x; i < b; i += blockDim.x)
      Db[i] = column<T, kShared>(S, i, b)[i];
  } else {
    // M[i][j] (i > j) sits at L[j][i]: each thread moves its own pairs
    for (int i = warp; i < b; i += nw) {
      for (int j = lane; j < i; j += 32) {
        const T v = Lb[(long long)j * b + i];
        Lb[(long long)i * b + j] = v;
        Lb[(long long)j * b + i] = T(0);
      }
    }
    for (int i = threadIdx.x; i < b; i += blockDim.x) {
      Db[i] = Lb[(long long)i * b + i];
      Lb[(long long)i * b + i] = T(1);
    }
  }
}

template <typename T, int P, int H>
cudaError_t launch_warp(const T* a, T* l, T* d, int nb, int b, int grid,
                        int threads, int smem, cudaStream_t s) {
  ldlt_warp_kernel<T, P, H><<<grid, threads, smem, s>>>(a, l, d, nb, b);
  return cudaGetLastError();
}

template <typename T, bool kShared>
cudaError_t launch_tri(const T* a, T* l, T* d, int b, int grid, int threads,
                       int smem, cudaStream_t s) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        ldlt_tri_kernel<T, kShared>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return err;
  }
  ldlt_tri_kernel<T, kShared><<<grid, threads, smem, s>>>(a, l, d, b);
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
      return (int)launch_tri<T, true>(a, l, d, b, grid, threads, smem, s);
    case kGlobal:
      return (int)launch_tri<T, false>(a, l, d, b, grid, threads, 0, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
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

}  // extern "C"
