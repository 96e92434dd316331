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

__device__ __forceinline__ void atomic_min(int* p, int v) { atomicMin(p, v); }
__device__ __forceinline__ void atomic_min(float* p, float v) {
  atomic_min_float(p, v);
}

// A min value's order key: an int whose signed order is the value's order,
// so that one int atomicMin on keys (in a shared tile) takes a min.  An int
// is its own key; a float's key is its bit pattern with the magnitude bits
// of a negative one flipped.  -0.0 keys just below +0.0, as the sign-split
// atomics order them.  from_key inverts order_key.
__device__ __forceinline__ int order_key(int v) { return v; }
__device__ __forceinline__ int order_key(float v) {
  const int b = __float_as_int(v);
  return b >= 0 ? b : b ^ 0x7fffffff;
}
template <typename T>
__device__ __forceinline__ T from_key(int k);
template <>
__device__ __forceinline__ int from_key<int>(int k) {
  return k;
}
template <>
__device__ __forceinline__ float from_key<float>(int k) {
  return __int_as_float(k >= 0 ? k : k ^ 0x7fffffff);
}

// Mins v (order key `key`) into *p unless *p already holds as little.
// Exact while *p only falls, as out does while a min push or scatter runs:
// a plain read (from L2, so never a line an earlier kernel left in L1) is
// then at or above the true value, and the skip drops no contribution that
// would have lowered it.
template <typename T>
__device__ __forceinline__ void min_below(T* p, T v, int key) {
  if (key < order_key(__ldcg(p))) atomic_min(p, v);
}
