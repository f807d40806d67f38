// K2: batched unpivoted Gauss-Jordan sweep, giving the explicit inverse and
// the LDL^T pivots of many symmetric blocks, for Hopper.
//
// Replaces the TPU kernel ipopt_tpu/linalg/pallas_ldlt.py::_gj_inv_kernel
// (wrapper pallas_block_ldlt_inv), whose contract the reference's BCR levels
// compute in jnp (block_tridiag.py::_gj_inv_lanes).  For A of shape
// (nb, b, b) it writes Ainv (nb, b, b) and the pivot sequence d (nb, b).
// Step k, on the working block X (initially A), with p = X[k][k] and
// sp = p guarded to +-FLT_MIN / DBL_MIN when |p| <= that (NaN -> -tiny):
//     X[i][j] <- X[i][j] - (X[i][k] * X[k][j]) / sp     i != k, j != k
//     X[k][j] <- -X[k][j] / sp                          j != k
//     X[i][k] <- X[i][k] / sp                           i != k
//     X[k][k] <- 1 / sp,        d[k] = p (unguarded)
// Every update reads the X of step k-1.  The expressions are the
// reference's; none can be contracted into an FMA, so the result equals the
// plain PyTorch version (ipopt_torch/linalg/block_ldlt_inv.py::
// block_ldlt_inv_plain) bit for bit.
//
// What bounds it: on the chained main path (LuksanVlcek1 n=4096, v=32) the
// first BCR level is (64, 156, 156) float64.  The function needs about b^3
// multiply-adds per block (2 b^3 = 7.6 M flops), 486 M flops per launch:
// 7.3 us at the 67 TFLOP/s of the FP64 tensor cores, against 25 MB read and
// written, 7.5 us at 3.35 TB/s.  So bytes bound it, barely.  This scalar
// sweep does about 3 b^3 operations (mul, div, sub) outside the tensor cores
// instead: 729 M per launch, 21 us at 34 TFLOP/s.  The design keeps each block in shared
// memory for the whole sweep (one read and one write of device memory) and
// spreads one step's b*b independent updates over 512 threads; the b steps
// are sequential, two barriers each.  One factorization launches it 8 times
// (ne = 64, 32, ..., 1 and the root): from ne <= 16 on, at most 16 of the
// 132 SMs have work, and each of those CTAs still walks all b dependent
// steps, so the tail levels, not the first, are likely to set the time.
// Division is correctly rounded (div.rn), which costs many FP64 instructions
// per entry; faster variants (several blocks per CTA for small b, panels on
// the tensor cores for large b) are later work.
//
// One CTA per block, the block in dynamic shared memory (b*b + 2b elements:
// the block, and copies of column k and row k): b_max = 169 in float64,
// 240 in float32.  Thread (tx, ty) of the 32 x 16 CTA updates rows
// ty, ty+16, ... at columns tx, tx+32, ..., so a warp touches consecutive
// words of one row.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libblock_ldlt_inv.so block_ldlt_inv.cu
// (ipopt_torch/linalg/cuda_lib.py does this at first use).

#include <cuda_runtime.h>
#include <cfloat>

namespace {

constexpr int kTx = 32;
constexpr int kTy = 16;

template <typename T> struct Tiny;
template <> struct Tiny<float> {
  __device__ static float value() { return FLT_MIN; }
};
template <> struct Tiny<double> {
  __device__ static double value() { return DBL_MIN; }
};

// jnp.where(|p| > tiny, p, jnp.where(p >= 0, tiny, -tiny)); NaN -> -tiny.
template <typename T>
__device__ __forceinline__ T safe_pivot(T p) {
  const T tiny = Tiny<T>::value();
  const T ap = p < T(0) ? -p : p;
  return ap > tiny ? p : (p >= T(0) ? tiny : -tiny);
}

template <typename T>
__global__ void __launch_bounds__(kTx * kTy)
gj_inv_kernel(const T* __restrict__ A, T* __restrict__ Ainv,
              T* __restrict__ D, int b) {
  extern __shared__ unsigned char smem_raw[];
  T* S = reinterpret_cast<T*>(smem_raw);  // row-major b x b
  T* colk = S + b * b;                    // column k of the previous step
  T* rowk = colk + b;                     // row k of the previous step
  const long long blk = blockIdx.x;
  const int bb = b * b;
  const int tid = threadIdx.y * kTx + threadIdx.x;
  const T* Ab = A + blk * bb;
  for (int e = tid; e < bb; e += kTx * kTy) S[e] = Ab[e];
  __syncthreads();

  T* Db = D + blk * b;
  for (int k = 0; k < b; ++k) {
    for (int i = tid; i < b; i += kTx * kTy) {
      colk[i] = S[i * b + k];
      rowk[i] = S[k * b + i];
    }
    __syncthreads();
    const T p = colk[k];
    const T sp = safe_pivot(p);
    if (tid == 0) Db[k] = p;
    for (int i = threadIdx.y; i < b; i += kTy) {
      T* Si = S + i * b;
      if (i == k) {
        for (int j = threadIdx.x; j < b; j += kTx)
          Si[j] = j == k ? T(1) / sp : -rowk[j] / sp;
      } else {
        const T ci = colk[i];
        for (int j = threadIdx.x; j < b; j += kTx)
          Si[j] = j == k ? ci / sp : Si[j] - (ci * rowk[j]) / sp;
      }
    }
    __syncthreads();
  }

  T* Ob = Ainv + blk * bb;
  for (int e = tid; e < bb; e += kTx * kTy) Ob[e] = S[e];
}

template <typename T>
int launch(const void* A, void* Ainv, void* D, int nb, int b, int device,
           void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (nb <= 0 || b <= 0) return 0;
  const size_t smem = (size_t)(b * b + 2 * b) * sizeof(T);
  err = cudaFuncSetAttribute(gj_inv_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  gj_inv_kernel<T><<<nb, dim3(kTx, kTy), smem,
                     reinterpret_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(A), static_cast<T*>(Ainv), static_cast<T*>(D), b);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Each returns the cudaError_t of the launch (0 on success).  Pointers are
// device pointers of contiguous (nb, b, b), (nb, b, b) and (nb, b) arrays;
// stream is a cudaStream_t of `device`.
int block_ldlt_inv_f32(const void* A, void* Ainv, void* D, int nb, int b,
                       int device, void* stream) {
  return launch<float>(A, Ainv, D, nb, b, device, stream);
}

int block_ldlt_inv_f64(const void* A, void* Ainv, void* D, int nb, int b,
                       int device, void* stream) {
  return launch<double>(A, Ainv, D, nb, b, device, stream);
}

}  // extern "C"
