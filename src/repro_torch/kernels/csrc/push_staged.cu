// Staged push kernels for Hopper (sm_90a): the two halves of the push, with
// the per-edge intermediate c between them in device memory,
//
//     gather:   c[r, e, b]   = vals[r, src[r, e], b]   if valid[r, e] and
//                                                      0 <= src[r, e] < V,
//                              the identity otherwise
//     scatter:  out[r, s, b] = combine(out[r, s, b],
//                                      combine_{e: dst[r, e] == s} c[r, e, b])
//
// for every chare row r of a [rows, E] edge layout, with an optional
// trailing batch axis B on vals/c/out (one query column each).  The
// identity is 0 for add and the int32 sentinel for min; for float min it is
// float(int32 max) = 2^31, and values at or above it read as unreached
// (gathered values and scattered contributions are clamped to it), as the
// TPU kernels' sentinel fill makes them.
//
// Replaces the TPU kernels in repro/kernels/push_sum.py and push_min.py:
//   gather_sum   <- push_sum._gather_sum_kernel   (one-hot MXU matmul)
//   scatter_sum  <- push_sum._scatter_sum_kernel  (one-hot MXU matmul)
//   gather_min   <- push_min._gather_min_kernel   (VPU mask-and-reduce)
//   scatter_min  <- push_min._scatter_min_kernel  (VPU mask-and-reduce)
//
// What bounds them on this card: memory.  Per edge and column the gather
// reads src and valid (8 B, shared by the B columns), gathers one vals
// element and writes one c element (4 B); the scatter reads dst (4 B) and
// one c element and combines it into out.  There is no arithmetic to speak
// of.  The vertex planes of the main path (16.8 MB at 2^22 vertices) fit the
// 50 MB L2, so the gathers and the combines mostly hit L2 and the edge
// streams from HBM dominate.
//
// What the design does about it: the TPU kernels are one-hot matmuls and
// mask-and-reduce tiles over dense (edge block x vertex block) grids only
// because the TPU has no fast gather or scatter; Hopper has both.  The
// gathers take one (edge, column) item per thread; neighbouring threads
// read neighbouring edges and write neighbouring c elements, so the edge
// streams are coalesced; vals are read through the read-only data path; a
// grid-stride loop covers all chare rows and columns in one launch.
//
// The two scatters are one tiled kernel over the monoid (scatter_kernel):
// the row comes from the grid, each CTA takes a chunk of kScatterChunk
// edges, each thread whole edges and every column of them, so no item
// needs a 64-bit division.  A block reduction finds the chunk's
// destination range.  Where range x B fits the shared-memory tile (the sd
// layout: a chunk spans a segment block or two), contributions go into
// the tile with shared atomics -- atomicAdd for add, atomicMin on order
// keys for min (an int whose order is the value's, atomics.cuh) -- and
// each slot a contribution changed then goes to out with one global
// atomic (for min unless out already holds as little).  Otherwise (the
// pairwise layout, whose destinations are spread) contributions go
// straight to out with global atomics.  Either way a contribution that
// cannot change out is skipped: 0 for add; for min one at or above the
// identity or, in the tile, the slot.  Reading out first to skip more on
// the global path was slower there (the read waits, the atomic does not).
// What is left bounds the pairwise scatters: one atomic per contribution
// on random lines of the plane.  With one column a thread loads all its
// contributions before it combines any.  Summing lanes with the same
// destination in the warp first (__match_any_sync) was tried for add and
// was slower on the sd layout: a shared atomic costs less than the
// matching.  No padding of edges or vertices is needed.
//
// Exactness: int32 add and min are exact in any order (int add wraps as
// XLA's int32 does).  Float min is exact in any order too: the tile mins
// order keys, out takes the sign-split atomics of atomics.cuh (negatives
// included), and a skip only drops a contribution at or above a value
// the slot or out already holds -- both only fall while the kernel runs,
// so a plain read can only be at or above the true value.  Float
// add in scatter_sum uses shared and global f32 atomics, whose order
// varies from run to run.  The gather is a copy and exact; bfloat16 values
// widen exactly to float32.
//
// Built by repro_torch/kernels/_build.py with nvcc into a shared library with
// a plain C interface, loaded through ctypes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

#include "atomics.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kScatterChunk = 2048;                   // edges per CTA
constexpr int kPerThread = kScatterChunk / kThreads;  // edges per thread
constexpr int kTileWords = 8192;                      // 32 KB of 4-byte words
constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kSentinel = 2147483647;        // int32 max
constexpr float kSentinelF = 2147483648.0f;  // float(int32 max), as JAX rounds it

// read-only loads of one vals element, widened to the output type
__device__ __forceinline__ float load(const float* p) { return __ldg(p); }
__device__ __forceinline__ int load(const int* p) { return __ldg(p); }
__device__ __forceinline__ float load(const __nv_bfloat16* p) {
  return __bfloat162float(__ushort_as_bfloat16(
      __ldg(reinterpret_cast<const unsigned short*>(p))));
}

template <typename T, bool kMin>
__device__ __forceinline__ T identity();
template <>
__device__ __forceinline__ float identity<float, false>() { return 0.0f; }
template <>
__device__ __forceinline__ int identity<int, false>() { return 0; }
template <>
__device__ __forceinline__ float identity<float, true>() { return kSentinelF; }
template <>
__device__ __forceinline__ int identity<int, true>() { return kSentinel; }

// min's clamp to the identity: float values above 2^31 are unreached
__device__ __forceinline__ float clamp_min(float v) {
  return v > kSentinelF ? kSentinelF : v;
}
__device__ __forceinline__ int clamp_min(int v) { return v; }

template <typename In, typename Out, bool kMin>
__global__ void __launch_bounds__(kThreads) gather_kernel(
    const int* __restrict__ src, const int* __restrict__ valid,
    const In* __restrict__ vals, Out* __restrict__ c, long long rows,
    long long E, long long V, int B) {
  const long long n = rows * E * B;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < n; i += stride) {
    const long long re = i / B;  // row * E + edge
    const int b = static_cast<int>(i - re * B);
    const int s = src[re];
    Out v = identity<Out, kMin>();
    if (valid[re] != 0 && s >= 0 && s < V) {
      const long long row = re / E;
      v = load(vals + (row * V + s) * B + b);
      if (kMin) v = clamp_min(v);
    }
    c[i] = v;
  }
}

// Combines contribution v to column b of segment d into its tile slot
// (tiled) or into out: for add a shared or global atomicAdd unless v is 0;
// for min, unless v cannot lower the identity (its order key is at or
// above cap), a shared atomicMin on its key unless the slot already holds
// as little, or a global atomic min.
template <typename T, bool kMin>
__device__ __forceinline__ void scatter_one(T v, int d, int b, int B,
                                            bool tiled, int lo, int cap,
                                            void* tile, T* orow) {
  if constexpr (kMin) {
    const T m = clamp_min(v);
    const int key = order_key(m);
    if (key >= cap) return;
    if (tiled) {
      int* slot = static_cast<int*>(tile) + static_cast<long long>(d - lo) * B + b;
      if (key < *slot) atomicMin(slot, key);
    } else {
      atomic_min(orow + static_cast<long long>(d) * B + b, m);
    }
  } else {
    if (v == T(0)) return;
    if (tiled) {
      atomicAdd(static_cast<T*>(tile) + static_cast<long long>(d - lo) * B + b, v);
    } else {
      atomicAdd(orow + static_cast<long long>(d) * B + b, v);
    }
  }
}

// The tiled scatter, one template for both monoids: blockIdx.y picks the
// row, blockIdx.x the chunk of kScatterChunk edges; thread t takes edges t,
// t + kThreads, ... of the chunk with all their columns.  A destination
// outside [0, S) is dropped.  A tile slot holds a partial sum (add) or the
// order key of a partial min (min; atomics.cuh), and each slot a
// contribution changed goes to out with one global atomic -- for min
// unless out already holds as little.  With one column (kOneCol) a thread
// loads its edges' values together before it combines any; with several,
// it takes an edge's columns together, so that a global combine hits one
// line of out B times in a row.
template <typename T, bool kMin, bool kOneCol>
__global__ void __launch_bounds__(kThreads) scatter_kernel(
    const int* __restrict__ dst, const T* __restrict__ c, T* __restrict__ out,
    long long rows, long long E, long long S, int B) {
  using Slot = std::conditional_t<kMin, int, T>;
  __shared__ Slot tile[kTileWords];
  __shared__ int range[2][kThreads / 32];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int cap = order_key(identity<T, true>());  // min: skip at and above
  const long long base = static_cast<long long>(blockIdx.x) * kScatterChunk;
  for (long long row = blockIdx.y; row < rows; row += gridDim.y) {
    const int* drow = dst + row * E;
    const T* crow = c + row * E * B;
    T* orow = out + row * S * B;
    int d[kPerThread];
    int lo = 0x7fffffff, hi = -1;
#pragma unroll
    for (int k = 0; k < kPerThread; ++k) {
      const long long e = base + k * kThreads + threadIdx.x;
      d[k] = e < E ? drow[e] : -1;
      if (d[k] < 0 || d[k] >= S) {
        d[k] = -1;
      } else {
        lo = d[k] < lo ? d[k] : lo;
        hi = d[k] > hi ? d[k] : hi;
      }
    }
    lo = __reduce_min_sync(kFullMask, lo);
    hi = __reduce_max_sync(kFullMask, hi);
    if (lane == 0) {
      range[0][warp] = lo;
      range[1][warp] = hi;
    }
    __syncthreads();
#pragma unroll
    for (int w = 0; w < kThreads / 32; ++w) {
      lo = range[0][w] < lo ? range[0][w] : lo;
      hi = range[1][w] > hi ? range[1][w] : hi;
    }
    __syncthreads();  // range is rewritten for the next row
    if (hi < 0) continue;  // no destination in range
    const long long span = (static_cast<long long>(hi) - lo + 1) * B;
    const bool tiled = span <= kTileWords;
    if (tiled) {
      for (int x = threadIdx.x; x < span; x += kThreads)
        tile[x] = kMin ? Slot(cap) : Slot(0);
      __syncthreads();
    }
    if constexpr (kOneCol) {
      T v[kPerThread];
#pragma unroll
      for (int k = 0; k < kPerThread; ++k)
        v[k] = d[k] >= 0 ? crow[base + k * kThreads + threadIdx.x]
                         : identity<T, kMin>();
#pragma unroll
      for (int k = 0; k < kPerThread; ++k)
        if (d[k] >= 0)
          scatter_one<T, kMin>(v[k], d[k], 0, 1, tiled, lo, cap, tile, orow);
    } else {
#pragma unroll
      for (int k = 0; k < kPerThread; ++k) {
        if (d[k] < 0) continue;
        const long long e = base + k * kThreads + threadIdx.x;
        for (int b = 0; b < B; ++b)
          scatter_one<T, kMin>(crow[e * B + b], d[k], b, B, tiled, lo, cap,
                               tile, orow);
      }
    }
    if (tiled) {
      __syncthreads();
      T* o = orow + static_cast<long long>(lo) * B;
      for (int x = threadIdx.x; x < span; x += kThreads) {
        const Slot v = tile[x];
        if constexpr (kMin) {
          if (v < cap) min_below(o + x, from_key<T>(v), v);
        } else {
          if (v != T(0)) atomicAdd(o + x, v);
        }
      }
      __syncthreads();  // the tile is reused for the next row
    }
  }
}

cudaError_t grid_for(long long n, unsigned* grid) {
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  const long long blocks = (n + kThreads - 1) / kThreads;
  const long long cap = static_cast<long long>(sms) * 32;
  *grid = static_cast<unsigned>(blocks < cap ? blocks : cap);
  return cudaSuccess;
}

template <typename In, typename Out, bool kMin>
cudaError_t gather(const int* src, const int* valid, const void* vals,
                   void* c, long long rows, long long E, long long V, int B,
                   cudaStream_t stream) {
  unsigned grid = 0;
  cudaError_t err = grid_for(rows * E * B, &grid);
  if (err != cudaSuccess) return err;
  gather_kernel<In, Out, kMin><<<grid, kThreads, 0, stream>>>(
      src, valid, static_cast<const In*>(vals), static_cast<Out*>(c), rows, E,
      V, B);
  return cudaGetLastError();
}

template <typename T, bool kMin>
cudaError_t scatter(const int* dst, const void* c, void* out, long long rows,
                    long long E, long long S, int B, cudaStream_t stream) {
  const long long chunks = (E + kScatterChunk - 1) / kScatterChunk;
  const dim3 grid(static_cast<unsigned>(chunks),
                  static_cast<unsigned>(rows < 65535 ? rows : 65535));
  if (B == 1) {
    scatter_kernel<T, kMin, true><<<grid, kThreads, 0, stream>>>(
        dst, static_cast<const T*>(c), static_cast<T*>(out), rows, E, S, B);
  } else {
    scatter_kernel<T, kMin, false><<<grid, kThreads, 0, stream>>>(
        dst, static_cast<const T*>(c), static_cast<T*>(out), rows, E, S, B);
  }
  return cudaGetLastError();
}

}  // namespace

// combine: 0 = add (gather_sum), 1 = min (gather_min).  in_type: 0 =
// float32, 1 = int32, 2 = bfloat16 (add only; c is then float32).  src and
// valid are [rows, E] int32, vals [rows, V, B], c [rows, E, B] of the output
// type (float32 for float inputs, int32 for int32).  Returns
// cudaGetLastError() after the launch (0 on success); launches nothing when
// there are no items.
extern "C" int staged_gather_launch(int combine, int in_type, const int* src,
                                    const int* valid, const void* vals,
                                    void* c, long long rows, long long E,
                                    long long V, int B, void* stream) {
  if (B < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (rows * E == 0) return static_cast<int>(cudaSuccess);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (combine == 0) {
    if (in_type == 0) err = gather<float, float, false>(src, valid, vals, c, rows, E, V, B, s);
    if (in_type == 1) err = gather<int, int, false>(src, valid, vals, c, rows, E, V, B, s);
    if (in_type == 2) err = gather<__nv_bfloat16, float, false>(src, valid, vals, c, rows, E, V, B, s);
  } else if (combine == 1) {
    if (in_type == 0) err = gather<float, float, true>(src, valid, vals, c, rows, E, V, B, s);
    if (in_type == 1) err = gather<int, int, true>(src, valid, vals, c, rows, E, V, B, s);
  }
  return static_cast<int>(err);
}

// combine: 0 = add (scatter_sum), 1 = min (scatter_min).  is_float: 0 =
// int32, 1 = float32 (c and out share it).  dst is [rows, E] int32, c
// [rows, E, B], out [rows, S, B], already holding the identity.  Returns
// cudaGetLastError() after the launch (0 on success); launches nothing when
// there are no items.
extern "C" int staged_scatter_launch(int combine, int is_float,
                                     const int* dst, const void* c, void* out,
                                     long long rows, long long E, long long S,
                                     int B, void* stream) {
  if (B < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (rows * E == 0) return static_cast<int>(cudaSuccess);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (combine == 0) {
    err = is_float ? scatter<float, false>(dst, c, out, rows, E, S, B, s)
                   : scatter<int, false>(dst, c, out, rows, E, S, B, s);
  } else if (combine == 1) {
    err = is_float ? scatter<float, true>(dst, c, out, rows, E, S, B, s)
                   : scatter<int, true>(dst, c, out, rows, E, S, B, s);
  }
  return static_cast<int>(err);
}
