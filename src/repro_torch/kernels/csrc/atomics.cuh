// Atomic combines shared by the push kernels (push_fused.cu, push_staged.cu).
//
// Float min by the sign-split trick: for a value with the sign bit clear,
// int atomicMin on its bit pattern; with the sign bit set, unsigned atomicMax
// on its bit pattern.  Both orders agree with float order on their half, and
// every negative pattern is below every positive one as a signed int and
// above it as an unsigned one, so the result is the exact minimum of every
// non-NaN float, negatives included, in any order of arrival.

#pragma once

#include <cuda_runtime.h>

__device__ __forceinline__ void atomic_min_float(float* p, float v) {
  const int bits = __float_as_int(v);
  if (bits >= 0) {
    atomicMin(reinterpret_cast<int*>(p), bits);
  } else {
    atomicMax(reinterpret_cast<unsigned*>(p), static_cast<unsigned>(bits));
  }
}
