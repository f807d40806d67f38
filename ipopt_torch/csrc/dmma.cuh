// The FP64 tensor-core product shared by K1's blocked variant
// (block_ldlt.cu) and K2's panel products (block_ldlt_inv.cu):
// mma.sync.aligned.m8n8k4.row.col.f64 (DMMA), sm_80 and later.
#pragma once

namespace {

// d(2) = a(8x4, row) b(4x8, col) + c(2): lane l holds a[l/4][l%4],
// b[l%4][l/4] and c, d[l/4][2(l%4) + {0, 1}].
__device__ __forceinline__ void dmma(double& d0, double& d1, double a, double b) {
  asm volatile(
      "mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 "
      "{%0, %1}, {%2}, {%3}, {%0, %1};\n"
      : "+d"(d0), "+d"(d1)
      : "d"(a), "d"(b));
}

}  // namespace
