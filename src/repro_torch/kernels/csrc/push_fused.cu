// Fused push kernels for Hopper (sm_90a): one launch per superstep computes
//
//     out[r, s] = combine(out[r, s], combine_{e: valid[r,e], dst[r,e] == s}
//                                    edge_value(vals[r, src[r,e]], w[r,e]))
//
// for every chare row r of a [rows, E] edge layout, with an optional
// trailing batch axis B on vals/out (one query column each).
//
// Replaces the TPU kernels in repro/kernels/push_fused.py:
//   fused_push_add_kernel  <- _fused_push_add_kernel (one-hot MXU matmuls)
//   fused_push_min_kernel  <- _fused_push_min_kernel (VPU mask-and-reduce)
//
// What bounds it on this card: memory.  Per edge it reads src, dst, valid
// (12 B) and, with a weight operand, 4 B more, then gathers one vals element
// and does one atomic read-modify-write on out.  The vertex planes of the
// main path (16.8 MB each at 2^22 vertices) fit the 50 MB L2, so the gather
// and the atomics mostly hit L2 and the edge stream from HBM dominates;
// there is next to no arithmetic.
//
// What the design does about it: the TPU kernels needed one-hot matmuls and
// mask-and-reduce tiles because the TPU has no fast gather or scatter; Hopper
// has both, so each thread takes one (edge, batch column) item, gathers
// directly and combines with one atomic.  Edge reads are coalesced (256
// consecutive edges per block).  The band table stays an operand only so
// empty (all-padding) edge blocks, band hi == -1, are skipped without
// reading their edges; the valid mask alone decides which edges count.
// Grid-stride over (row, edge block) pairs covers all chare rows in one
// launch.
//
// Exactness: int32 min and add use atomicMin/atomicAdd, exact in any order.
// Float min uses the sign-split trick (int atomicMin on the bit pattern for
// values with the sign bit clear, unsigned atomicMax for values with it set),
// which orders every non-NaN float exactly, negatives included.  Float add
// uses f32 atomicAdd, whose order varies from run to run.
//
// Built by repro_torch/kernels/_build.py with nvcc into a shared library with
// a plain C interface, loaded through ctypes.

#include <cuda_runtime.h>

#include "atomics.cuh"

namespace {

constexpr int kBlockE = 256;            // blocks.BLOCK_E
constexpr int kSentinel = 2147483647;   // int32 max
constexpr float kSentinelF = 2147483648.0f;  // float(int32 max), as JAX rounds it

enum WeightMode { kNone = 0, kArray = 1, kUnit = 2 };

struct AddInt {
  using T = int;
  __device__ static T gather(T v) { return v; }
  __device__ static T transform(T c, T w) {
    // int32 product wraps, as XLA's does
    return static_cast<T>(static_cast<unsigned>(c) * static_cast<unsigned>(w));
  }
  __device__ static void combine(T* p, T v) { atomicAdd(p, v); }
};

struct AddFloat {
  using T = float;
  __device__ static T gather(T v) { return v; }
  __device__ static T transform(T c, T w) { return c * w; }
  __device__ static void combine(T* p, T v) { atomicAdd(p, v); }
};

struct MinInt {
  using T = int;
  __device__ static T gather(T v) { return v; }  // min(v, SENTINEL) == v
  __device__ static T transform(T c, T w) {
    // saturating c + min(w, SENTINEL - c), in wrapping int32 arithmetic
    // exactly as the reference computes it
    const T head = static_cast<T>(static_cast<unsigned>(kSentinel) -
                                  static_cast<unsigned>(c));
    const T add = w < head ? w : head;
    return static_cast<T>(static_cast<unsigned>(c) + static_cast<unsigned>(add));
  }
  __device__ static void combine(T* p, T v) { atomicMin(p, v); }
};

struct MinFloat {
  using T = float;
  // values above the sentinel are "unreached": clamp to float(SENTINEL)
  __device__ static T gather(T v) { return v > kSentinelF ? kSentinelF : v; }
  __device__ static T transform(T c, T w) { return c + w; }
  __device__ static void combine(T* p, T v) { atomic_min_float(p, v); }
};

template <class Op, int kWeight>
__global__ void __launch_bounds__(kBlockE) fused_push_kernel(
    const int* __restrict__ band, const int* __restrict__ src,
    const int* __restrict__ dst, const int* __restrict__ valid,
    const typename Op::T* __restrict__ weight,
    const typename Op::T* __restrict__ vals, typename Op::T* __restrict__ out,
    long long rows, long long E, long long NB, long long V, long long S,
    int B) {
  using T = typename Op::T;
  const long long nblocks = rows * NB;
  for (long long blk = blockIdx.x; blk < nblocks; blk += gridDim.x) {
    const long long row = blk / NB;
    const long long eb = blk - row * NB;
    if (band[(row * 4 + 1) * NB + eb] < 0) continue;  // empty edge block
    const long long ebase = row * E + eb * kBlockE;
    const T* vrow = vals + row * V * B;
    T* orow = out + row * S * B;
    for (int i = threadIdx.x; i < kBlockE * B; i += blockDim.x) {
      const int le = i / B;
      const int b = i - le * B;
      const long long e = ebase + le;
      if (valid[e] == 0) continue;
      T c = Op::gather(vrow[static_cast<long long>(src[e]) * B + b]);
      if (kWeight == kArray) c = Op::transform(c, weight[e]);
      if (kWeight == kUnit) c = Op::transform(c, static_cast<T>(1));
      Op::combine(orow + static_cast<long long>(dst[e]) * B + b, c);
    }
  }
}

template <class Op>
cudaError_t launch(int weight_mode, const int* band, const int* src,
                   const int* dst, const int* valid, const void* weight,
                   const void* vals, void* out, long long rows, long long E,
                   long long NB, long long V, long long S, int B,
                   cudaStream_t stream) {
  using T = typename Op::T;
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  const long long nblocks = rows * NB;
  const long long cap = static_cast<long long>(sms) * 16;
  const unsigned grid =
      static_cast<unsigned>(nblocks < cap ? nblocks : cap);
  const T* w = static_cast<const T*>(weight);
  const T* v = static_cast<const T*>(vals);
  T* o = static_cast<T*>(out);
  switch (weight_mode) {
    case kNone:
      fused_push_kernel<Op, kNone><<<grid, kBlockE, 0, stream>>>(
          band, src, dst, valid, w, v, o, rows, E, NB, V, S, B);
      break;
    case kArray:
      fused_push_kernel<Op, kArray><<<grid, kBlockE, 0, stream>>>(
          band, src, dst, valid, w, v, o, rows, E, NB, V, S, B);
      break;
    case kUnit:
      fused_push_kernel<Op, kUnit><<<grid, kBlockE, 0, stream>>>(
          band, src, dst, valid, w, v, o, rows, E, NB, V, S, B);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

// combine: 0 = add, 1 = min.  is_float: 0 = int32, 1 = float32 (vals,
// weight and out share it).  weight_mode: 0 none, 1 array, 2 unit.
// Edge planes are [rows, E] int32 with E a multiple of 256, band is
// [rows, 4, E / 256], vals [rows, V, B], out [rows, S, B] (already holding
// the identity or the init seed).  Returns cudaGetLastError() after the
// launch (0 on success); launches nothing when there are no edge blocks.
extern "C" int fused_push_launch(int combine, int is_float, int weight_mode,
                                 const int* band, const int* src,
                                 const int* dst, const int* valid,
                                 const void* weight, const void* vals,
                                 void* out, long long rows, long long E,
                                 long long NB, long long V, long long S,
                                 int B, void* stream) {
  if (rows * NB == 0) return static_cast<int>(cudaSuccess);
  if (B < 1 || E != NB * kBlockE) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (combine == 0) {
    err = is_float ? launch<AddFloat>(weight_mode, band, src, dst, valid,
                                      weight, vals, out, rows, E, NB, V, S, B, s)
                   : launch<AddInt>(weight_mode, band, src, dst, valid,
                                    weight, vals, out, rows, E, NB, V, S, B, s);
  } else {
    err = is_float ? launch<MinFloat>(weight_mode, band, src, dst, valid,
                                      weight, vals, out, rows, E, NB, V, S, B, s)
                   : launch<MinInt>(weight_mode, band, src, dst, valid,
                                    weight, vals, out, rows, E, NB, V, S, B, s);
  }
  return static_cast<int>(err);
}
