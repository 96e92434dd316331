// Fused push kernels for Hopper (sm_90a): one launch per superstep computes
//
//     out[r, s] = combine(out[r, s], combine_{e: valid[r,e], dst[r,e] == s}
//                                    edge_value(vals[r, src[r,e]], w[r,e]))
//
// for every chare row r of a [rows, E] edge layout, with an optional
// trailing batch axis B on vals/out (one query column each).
//
// Replaces the TPU kernels in repro/kernels/push_fused.py:
//   tiled_add_kernel + merge_kernel, and fused_push_kernel<Add*> on rows
//                            <- _fused_push_add_kernel (one-hot MXU matmuls)
//   tiled_min_kernel, and fused_push_kernel<Min*> on rows
//                            <- _fused_push_min_kernel (VPU mask-and-reduce)
//
// What bounds it on this card: memory.  Per edge it reads src, dst, valid
// (12 B) and, with a weight operand, 4 B more, then gathers one vals element
// and combines one contribution into out.  The vertex planes of the main
// path (16.8 MB each at 2^22 vertices) fit the 50 MB L2, so the gather and
// the combine mostly hit L2 and the edge stream from HBM dominates; there is
// next to no arithmetic.
//
// What the design does about it: the TPU kernels needed one-hot matmuls and
// mask-and-reduce tiles because the TPU has no fast gather or scatter; Hopper
// has both, so threads gather directly.  How they combine depends on the
// row.  A seg-sorted row (band seg ranges that never decrease along the
// row: every row of the sd layout) takes a tiled path, in which one CTA
// takes a chunk of consecutive edge blocks, streams them with 16-byte loads
// (four edges a lane, two blocks a warp in flight) and combines into shared
// memory over a window of the chunk's segment range; a chunk whose range is
// wide (a sparse row) is split into pieces of segment blocks, one CTA each,
// so that no CTA walks hundreds of segment blocks alone.
//
// * Add, tiled (tiled_add_kernel + merge_kernel): each warp adds its
//   contributions into its own shared-memory tile, lanes with the same
//   destination in lane order; then the eight warp tiles are summed in warp
//   order.  (A chunk spread over more segment blocks than that suits shares
//   one wider tile, which the warps add into in turn.)  Segment blocks
//   inside the chunk's range belong to it alone (the ranges are monotone)
//   and are added to out directly; the first and last segment block may be
//   shared with neighbouring chunks, so they go to a scratch buffer, and
//   merge_kernel adds, per segment block, the partials of the chunks that
//   cover it in chunk order.  A hub block is so split over many CTAs.  No
//   global atomics.
// * Min, tiled (tiled_min_kernel), on the seg-sorted rows of a table with
//   at least half an edge per segment of its chunks' ranges (the
//   wrapper's rule, push_fused.min_tiles): the warps share one tile of
//   order keys (an int whose order is the value's, atomics.cuh), lowered
//   with shared atomicMin; then each slot that a contribution lowered
//   goes to out with one global atomic.  Min
//   needs no order, so there is no scratch and no merge pass: a segment
//   block that several chunks cover takes an atomic from each.  What
//   bounds it is the edge stream and the gathers; with one column a thread
//   has all its gathers in flight at once.  On a sparser table (a
//   near-uniform graph's) a slot takes about one contribution, the tile
//   saves no global atomic, and the atomic kernel is faster.
// * Add and min on any other row (the basic layout, arbitrary edges):
//   fused_push_kernel, one thread per (edge, batch column), grid-stride over
//   (row, edge block) pairs, one global atomic per contribution.
//
// Both min paths skip a contribution that cannot lower out: one whose key
// is at or above the skip bound (the identity's, where out holds nothing
// above it), the tile slot's, or a plain read of out's.  The skip tests the
// transformed contribution, never the gathered value: an unreached source
// over a negative weight gives a real value.
//
// In all of them, the band table lets a CTA skip empty (all-padding) edge
// blocks, band hi == -1; the valid mask alone decides which edges count.
//
// Exactness: int32 min and add are exact in any order.  Float min is exact
// in any order too: the tiles min order keys, out takes the sign-split
// atomics of atomics.cuh (int atomicMin on the bit pattern for values with
// the sign bit clear, unsigned atomicMax for values with it set), which
// order every non-NaN float exactly, negatives included; a skip drops only
// a contribution at or above a value the slot or out already holds, and
// both only fall while the kernel runs, so a plain read can only be at or
// above the true value.  Float add on the tiled path sums in an order fixed
// by the data alone (a warp's edges in the order it loads them, warps in
// order, chunks in order), with __fadd_rn/__fmul_rn so nothing is
// contracted: the same operands give the same bits on every run, and
// column b of a [B] plane the bits of a one-column call on that column.
// Float add on the atomic path uses f32 atomicAdd, whose order varies from
// run to run.
//
// Built by repro_torch/kernels/_build.py with nvcc into a shared library with
// a plain C interface, loaded through ctypes.

#include <cuda_runtime.h>

#include <cstdint>

#include "atomics.cuh"

namespace {

constexpr int kBlockE = 256;            // blocks.BLOCK_E
constexpr int kBlockS = 256;            // blocks.BLOCK_S
constexpr int kWarps = kBlockE / 32;
constexpr int kWarpWords = 1024;        // one warp's tile: 4 KB of 4-byte words
constexpr int kTags = 128;              // a warp's destination tag slots
constexpr int kRounds = 2;              // edge blocks a warp keeps in flight
constexpr int kWarpTileBlocks = 8;      // widest chunk range on warp tiles
constexpr int kChunkBlocks = 16;        // push_fused.TILE_CHUNK_BLOCKS
constexpr int kMinTileWords = kWarps * kWarpWords;  // the tiled min's tile
constexpr int kMinCols = 16;            // columns a tiled-min pass takes
constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kSentinel = 2147483647;   // int32 max
constexpr float kSentinelF = 2147483648.0f;  // float(int32 max), as JAX rounds it

enum WeightMode { kNone = 0, kArray = 1, kUnit = 2 };

struct AddInt {
  using T = int;
  static constexpr bool kMin = false;
  __device__ static T gather(T v) { return v; }
  __device__ static T transform(T c, T w) {
    // int32 product wraps, as XLA's does
    return static_cast<T>(static_cast<unsigned>(c) * static_cast<unsigned>(w));
  }
  __device__ static void combine(T* p, T v) { atomicAdd(p, v); }
};

struct AddFloat {
  using T = float;
  static constexpr bool kMin = false;
  __device__ static T gather(T v) { return v; }
  __device__ static T transform(T c, T w) { return __fmul_rn(c, w); }
  __device__ static void combine(T* p, T v) { atomicAdd(p, v); }
};

struct MinInt {
  using T = int;
  static constexpr bool kMin = true;
  __device__ static T gather(T v) { return v; }  // min(v, SENTINEL) == v
  __device__ static T transform(T c, T w) {
    // saturating c + min(w, SENTINEL - c), in wrapping int32 arithmetic
    // exactly as the reference computes it
    const T head = static_cast<T>(static_cast<unsigned>(kSentinel) -
                                  static_cast<unsigned>(c));
    const T add = w < head ? w : head;
    return static_cast<T>(static_cast<unsigned>(c) + static_cast<unsigned>(add));
  }
};

struct MinFloat {
  using T = float;
  static constexpr bool kMin = true;
  // values above the sentinel are "unreached": clamp to float(SENTINEL)
  __device__ static T gather(T v) { return v > kSentinelF ? kSentinelF : v; }
  __device__ static T transform(T c, T w) { return c + w; }
};

template <class Op, int kWeight>
__global__ void __launch_bounds__(kBlockE) fused_push_kernel(
    const int* __restrict__ band, const int* __restrict__ src,
    const int* __restrict__ dst, const int* __restrict__ valid,
    const typename Op::T* __restrict__ weight,
    const typename Op::T* __restrict__ vals, typename Op::T* __restrict__ out,
    long long rows, long long E, long long NB, long long V, long long S,
    int B, int cap) {
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
      T* p = orow + static_cast<long long>(dst[e]) * B + b;
      if constexpr (Op::kMin) {
        const int key = order_key(c);
        if (key < cap) min_below(p, c, key);
      } else {
        Op::combine(p, c);
      }
    }
  }
}

// Float and int adds the compiler may not contract or reorder: each float
// add rounds once, in the order written; int adds wrap as XLA's int32 does.
__device__ __forceinline__ float add_fixed(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ int add_fixed(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) + static_cast<unsigned>(b));
}

__device__ __forceinline__ int lane_of(const int4& v, int t) {
  return t == 0 ? v.x : (t == 1 ? v.y : (t == 2 ? v.z : v.w));
}
template <typename T>
__device__ __forceinline__ T from_bits(int x);
template <>
__device__ __forceinline__ float from_bits<float>(int x) {
  return __int_as_float(x);
}
template <>
__device__ __forceinline__ int from_bits<int>(int x) {
  return x;
}

// 16 edges' worth of one int32 edge plane, streamed past the caches (the
// edges are read once; L2 is kept for vals and out)
__device__ __forceinline__ int4 load_edges(const void* plane, long long e) {
  return __ldcs(reinterpret_cast<const int4*>(
      static_cast<const int*>(plane) + e));
}

// Adds c (BG columns, ncol of them live) into acc[key * BG + j] for every
// lane whose key is not -1, lanes with the same key in lane order: each
// round, every lane still waiting marks its key's tag slot with
// atomicMin(lane), and the lowest lane of each slot adds.  The whole warp
// calls it; tags is the warp's own kTags slots.
template <typename T, int BG>
__device__ __forceinline__ void ordered_add(T* acc, int* tags, int key,
                                            const T (&c)[BG], int ncol) {
  const int lane = threadIdx.x & 31;
  bool waiting = key >= 0;
  int* tag = tags + (key & (kTags - 1));
  while (__any_sync(kFullMask, waiting)) {
    if (waiting) *tag = 32;
    __syncwarp();
    if (waiting) atomicMin(tag, lane);
    __syncwarp();
    if (waiting && *tag == lane) {  // the lowest waiting lane of its slot
#pragma unroll
      for (int j = 0; j < BG; ++j) {
        if (j < ncol) {
          T* p = acc + key * BG + j;
          *p = add_fixed(*p, c[j]);
        }
      }
      waiting = false;
    }
    __syncwarp();
  }
}

// The tiled add's operands and schedule (fused_push_add_tiled_launch).
struct Tiled {
  const int* band;
  const int* src;
  const int* dst;
  const int* valid;
  const void* weight;
  const void* vals;
  void* out;
  const int* chunk_blocks;
  const int* tile_chunks;
  const int* merge_tiles;
  const int* work;
  void* scratch;
  long long rows, E, NB, NC, V, S, NT, NM, NW;
  int B;
  int cap;  // the tiled min's skip bound (fused_push_min_tiled_launch)
};

// One CTA per work item (chunk, plo, phi): the chunk's edge blocks [i0, i1)
// reduced over the piece [plo, phi] of its segment blocks [blo, bhi]
// (chunk_blocks and work, from the wrapper's schedule).  A dense chunk's
// range is one piece; a sparse chunk's wide range is split over several
// CTAs, each reading the chunk's edges and keeping those in its piece.
// Columns go in groups of BG, the piece in windows.  The edge blocks go in groups of kGroup;
// in a group, warp w takes the half (w & 1) of blocks w / 2 and
// w / 2 + kWarps / 2, four consecutive edges a lane (16-byte loads).
//
// A chunk whose range spans at most kWarpTileBlocks segment blocks (dense:
// many edges per segment) gives each warp its own tile: no barrier until
// the window's warp tiles are summed in warp order.  A wider chunk (sparse)
// shares one tile eight times as wide, and the warps add into it in turn,
// warp 0 first, a barrier after each; zeroing and summing the tiles costs
// per segment, and this keeps that cost to one tile.  Both orders depend on
// the data alone, never on B, and neither on the pieces and windows, which
// only choose the segments a pass keeps.
//
// A segment of block blo goes to scratch slot 0, of block bhi (when it
// differs) to slot 1, any other straight into out.
template <class Op, int kWeight, int BG>
__global__ void __launch_bounds__(kBlockE) tiled_add_kernel(const Tiled a) {
  using T = typename Op::T;
  const int* __restrict__ src = a.src;
  const int* __restrict__ dst = a.dst;
  const int* __restrict__ valid = a.valid;
  const T* __restrict__ weight = static_cast<const T*>(a.weight);
  const long long E = a.E, NB = a.NB, NC = a.NC, V = a.V, S = a.S;
  const int B = a.B;
  constexpr int kHalf = kWarps / 2;  // blocks a load round of the CTA covers
  constexpr int kGroup = kHalf * kRounds;
  __shared__ T tile[kWarps * kWarpWords];
  __shared__ int tags[kWarps * kTags];
  const int* item = a.work + 3LL * blockIdx.x;
  const long long chunk = item[0];  // row * NC + chunk within the row
  const int blo = a.chunk_blocks[2 * chunk];
  const int bhi = a.chunk_blocks[2 * chunk + 1];
  if (bhi < blo) return;
  const long long row = chunk / NC;
  const long long i0 = (chunk - row * NC) * kChunkBlocks;
  const long long i1 = i0 + kChunkBlocks < NB ? i0 + kChunkBlocks : NB;
  const int* seg_lo = a.band + (row * 4 + 2) * NB;
  const int* seg_hi = a.band + (row * 4 + 3) * NB;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const bool turns = bhi - blo >= kWarpTileBlocks;
  T* acc = turns ? tile : tile + warp * kWarpWords;
  const int acc_words = turns ? kWarps * kWarpWords : kWarpWords;
  const int win = acc_words / BG;  // segments a window holds
  int* my_tags = tags + warp * kTags;
  const T* vrow = static_cast<const T*>(a.vals) + row * V * B;
  T* orow = static_cast<T*>(a.out) + row * S * B;
  T* slots = static_cast<T*>(a.scratch) + chunk * 2 * kBlockS * B;
  const long long first = static_cast<long long>(item[1]) * kBlockS;
  const long long range_end = static_cast<long long>(item[2] + 1) * kBlockS;
  const long long end = range_end < S ? range_end : S;
  const long long lane_edge = row * E + (warp & 1) * (kBlockE / 2) + lane * 4;
  for (int g0 = 0; g0 < B; g0 += BG) {
    const int ncol = B - g0 < BG ? B - g0 : BG;
    for (long long ws = first; ws < end; ws += win) {
      const int width = static_cast<int>(end - ws < win ? end - ws : win);
      // does edge block ib have segments in the window? (hi == -1: empty)
      const auto meets = [&](long long ib) {
        const int hi = seg_hi[ib];
        return hi >= 0 && static_cast<long long>(hi + 1) * kBlockS > ws &&
               static_cast<long long>(seg_lo[ib]) * kBlockS < ws + width;
      };
      if (turns) {
        for (int x = threadIdx.x; x < width * BG; x += kBlockE) acc[x] = T(0);
        __syncthreads();
      } else {
        for (int x = lane; x < width * BG; x += 32) acc[x] = T(0);
        __syncwarp();
      }
      for (long long gi = i0; gi < i1; gi += kGroup) {
        // in turns, skip a group none of whose blocks meets the window
        // (every warp finds the same): its turns would add nothing
        if (turns && !__any_sync(kFullMask, lane < kGroup &&
                                                gi + lane < i1 &&
                                                meets(gi + lane)))
          continue;
        int4 d4[kRounds], v4[kRounds], s4[kRounds], w4[kRounds];
#pragma unroll
        for (int r = 0; r < kRounds; ++r) {
          d4[r] = v4[r] = s4[r] = w4[r] = make_int4(0, 0, 0, 0);
          const long long ib = gi + warp / 2 + r * kHalf;
          if (ib >= i1 || !meets(ib)) continue;
          const long long e = lane_edge + ib * kBlockE;
          d4[r] = load_edges(dst, e);
          v4[r] = load_edges(valid, e);  // all zero for a skipped block
          s4[r] = load_edges(src, e);
          if (kWeight == kArray) w4[r] = load_edges(weight, e);
        }
        int key[kRounds][4];
        T c[kRounds][4][BG];
#pragma unroll
        for (int r = 0; r < kRounds; ++r) {
#pragma unroll
          for (int t = 0; t < 4; ++t) {
            // invalid edges carry any dst: drop them before keying
            const int d = lane_of(d4[r], t);
            key[r][t] = lane_of(v4[r], t) != 0 && d >= ws && d < ws + width
                            ? static_cast<int>(d - ws)
                            : -1;
#pragma unroll
            for (int j = 0; j < BG; ++j) c[r][t][j] = T(0);
            if (key[r][t] < 0) continue;
            const T* v = vrow + static_cast<long long>(lane_of(s4[r], t)) * B + g0;
            const T w = from_bits<T>(lane_of(w4[r], t));
#pragma unroll
            for (int j = 0; j < BG; ++j) {
              if (j < ncol) {
                c[r][t][j] = Op::gather(v[j]);
                if (kWeight == kArray) c[r][t][j] = Op::transform(c[r][t][j], w);
              }
            }
          }
        }
        for (int w = 0; w < (turns ? kWarps : 1); ++w) {
          if (!turns || warp == w) {
#pragma unroll
            for (int r = 0; r < kRounds; ++r) {
#pragma unroll
              for (int t = 0; t < 4; ++t)
                ordered_add<T, BG>(acc, my_tags, key[r][t], c[r][t], ncol);
            }
          }
          if (turns) __syncthreads();
        }
      }
      __syncthreads();
      for (int x = threadIdx.x; x < width * BG; x += kBlockE) {
        const int j = x % BG;
        if (j >= ncol) continue;
        T sum = tile[x];
        if (!turns) {
#pragma unroll
          for (int w = 1; w < kWarps; ++w)
            sum = add_fixed(sum, tile[w * kWarpWords + x]);
        }
        const long long s = ws + x / BG;
        const long long sb = s / kBlockS;
        const long long col = g0 + j;
        if (sb == blo) {
          slots[(s - sb * kBlockS) * B + col] = sum;
        } else if (sb == bhi) {
          slots[(kBlockS + s - sb * kBlockS) * B + col] = sum;
        } else {
          T* p = orow + s * B + col;
          *p = add_fixed(*p, sum);
        }
      }
      __syncthreads();
    }
  }
}

// One CTA per (row, segment block t) of the merge list (merge_tiles, the
// blocks some chunk's range starts or ends in): the chunks [c0, c1] whose
// segment ranges cover t (tile_chunks) left their partials of t in scratch
// unless t lies inside a chunk's range; sum them in chunk order and add the
// sum to out.
template <typename T>
__global__ void __launch_bounds__(kBlockS) merge_kernel(const Tiled a) {
  const long long NC = a.NC, NT = a.NT, S = a.S;
  const int B = a.B;
  const long long tb = a.merge_tiles[blockIdx.x];  // row * NT + t
  const int c0 = a.tile_chunks[2 * tb];
  const int c1 = a.tile_chunks[2 * tb + 1];
  if (c1 < c0) return;
  const long long row = tb / NT;
  const int t = static_cast<int>(tb - row * NT);
  const long long s = static_cast<long long>(t) * kBlockS + threadIdx.x;
  if (s >= S) return;
  const int* cb = a.chunk_blocks + row * NC * 2;
  const T* part = static_cast<const T*>(a.scratch) + row * NC * 2 * kBlockS * B;
  for (int b = 0; b < B; ++b) {
    T acc = T(0);
    bool have = false;
    for (int c = c0; c <= c1; ++c) {
      const int lo = cb[2 * c], hi = cb[2 * c + 1];
      if (hi < lo || (t != lo && t != hi)) continue;  // empty, or inside
      const int slot = t == lo ? 0 : 1;
      const T v = part[((2LL * c + slot) * kBlockS + threadIdx.x) * B + b];
      acc = have ? add_fixed(acc, v) : v;
      have = true;
    }
    if (have) {
      T* p = static_cast<T*>(a.out) + (row * S + s) * B + b;
      *p = add_fixed(*p, acc);
    }
  }
}

// The tiled min: one CTA per work item (chunk, plo, phi), as the tiled add
// takes them (the work list alone: chunk_blocks, tile_chunks, merge_tiles
// and scratch are not read).  The CTA streams the chunk's edge
// blocks that meet the piece (16-byte loads, two blocks a warp in flight),
// gathers and transforms each edge's columns, and mins their order keys
// into one shared tile over a window of the piece's segments with shared
// atomicMin.  Then each slot a contribution lowered goes to out with one
// global atomic, unless out already holds as little.  Min is exact in any
// order, so the warps share the tile, a segment block that several chunks
// cover takes an atomic from each of them, and nothing is merged later.
//
// Every slot starts at `cap`, and a contribution whose key is not below the
// slot's (a plain read; the slot only falls) is skipped: one at or above
// cap cannot lower out, which the wrapper sets to hold nothing above cap
// (the identity's key where out starts at the identity, an int out never
// holds more; above every key where a float init may).  A slot still at
// cap was lowered by no contribution and is not flushed.  The skip is on
// the transformed value, never on the gathered one: an unreached source
// (the identity) over a negative weight gives a real value.
//
// Columns go in passes of up to kMinCols, the piece in windows of
// kMinTileWords / columns segments.  With one column (kOneCol) a thread
// gathers all its edges' values before it combines any, so that their
// loads are in flight together; with several, it takes an edge's columns
// together (gathering them column by column was slower).
template <class Op, int kWeight, bool kOneCol>
__global__ void __launch_bounds__(kBlockE) tiled_min_kernel(const Tiled a) {
  using T = typename Op::T;
  const int* __restrict__ src = a.src;
  const int* __restrict__ dst = a.dst;
  const int* __restrict__ valid = a.valid;
  const T* __restrict__ weight = static_cast<const T*>(a.weight);
  const long long E = a.E, NB = a.NB, NC = a.NC, V = a.V, S = a.S;
  const int B = a.B;
  const int cap = a.cap;
  constexpr int kHalf = kWarps / 2;  // blocks a load round of the CTA covers
  constexpr int kGroup = kHalf * kRounds;
  __shared__ int tile[kMinTileWords];
  const int* item = a.work + 3LL * blockIdx.x;
  const long long chunk = item[0];  // row * NC + chunk within the row
  const long long row = chunk / NC;
  const long long i0 = (chunk - row * NC) * kChunkBlocks;
  const long long i1 = i0 + kChunkBlocks < NB ? i0 + kChunkBlocks : NB;
  const int* seg_lo = a.band + (row * 4 + 2) * NB;
  const int* seg_hi = a.band + (row * 4 + 3) * NB;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int cols = B < kMinCols ? B : kMinCols;
  const int win = kMinTileWords / cols;  // segments a window holds
  const T* vrow = static_cast<const T*>(a.vals) + row * V * B;
  T* orow = static_cast<T*>(a.out) + row * S * B;
  const long long first = static_cast<long long>(item[1]) * kBlockS;
  const long long range_end = static_cast<long long>(item[2] + 1) * kBlockS;
  const long long end = range_end < S ? range_end : S;
  const long long lane_edge = row * E + (warp & 1) * (kBlockE / 2) + lane * 4;
  for (int g0 = 0; g0 < B; g0 += cols) {
    const int ncol = B - g0 < cols ? B - g0 : cols;
    for (long long ws = first; ws < end; ws += win) {
      const int width = static_cast<int>(end - ws < win ? end - ws : win);
      // does edge block ib have segments in the window? (hi == -1: empty)
      const auto meets = [&](long long ib) {
        const int hi = seg_hi[ib];
        return hi >= 0 && static_cast<long long>(hi + 1) * kBlockS > ws &&
               static_cast<long long>(seg_lo[ib]) * kBlockS < ws + width;
      };
      for (int x = threadIdx.x; x < width * ncol; x += kBlockE) tile[x] = cap;
      __syncthreads();
      for (long long gi = i0; gi < i1; gi += kGroup) {
        int4 d4[kRounds], v4[kRounds], s4[kRounds], w4[kRounds];
#pragma unroll
        for (int r = 0; r < kRounds; ++r) {
          d4[r] = v4[r] = s4[r] = w4[r] = make_int4(0, 0, 0, 0);
          const long long ib = gi + warp / 2 + r * kHalf;
          if (ib >= i1 || !meets(ib)) continue;
          const long long e = lane_edge + ib * kBlockE;
          d4[r] = load_edges(dst, e);
          v4[r] = load_edges(valid, e);  // all zero for a skipped block
          s4[r] = load_edges(src, e);
          if (kWeight == kArray) w4[r] = load_edges(weight, e);
        }
        if constexpr (kOneCol) {
          // every edge's slot and source first, then all the gathers, then
          // the combines (one column: ncol == 1, j == 0)
          int off[kRounds][4];  // slot offset, -1: no contribution
          const T* vp[kRounds][4];
          T wv[kRounds][4];
#pragma unroll
          for (int r = 0; r < kRounds; ++r) {
#pragma unroll
            for (int t = 0; t < 4; ++t) {
              // invalid edges carry any dst: drop them first
              const long long d = lane_of(d4[r], t);
              const bool in =
                  lane_of(v4[r], t) != 0 && d >= ws && d < ws + width;
              off[r][t] = in ? static_cast<int>(d - ws) * ncol : -1;
              vp[r][t] = vrow +
                         static_cast<long long>(in ? lane_of(s4[r], t) : 0) * B +
                         g0;
              wv[r][t] = from_bits<T>(lane_of(w4[r], t));
            }
          }
          for (int j = 0; j < ncol; ++j) {
            int key[kRounds][4];
#pragma unroll
            for (int r = 0; r < kRounds; ++r) {
#pragma unroll
              for (int t = 0; t < 4; ++t) {
                key[r][t] = cap;
                if (off[r][t] < 0) continue;
                T c = Op::gather(vp[r][t][j]);
                if (kWeight == kArray) c = Op::transform(c, wv[r][t]);
                if (kWeight == kUnit) c = Op::transform(c, static_cast<T>(1));
                key[r][t] = order_key(c);
              }
            }
#pragma unroll
            for (int r = 0; r < kRounds; ++r) {
#pragma unroll
              for (int t = 0; t < 4; ++t) {
                if (key[r][t] >= cap) continue;  // none, or cannot lower out
                int* slot = tile + off[r][t] + j;
                if (key[r][t] < *slot) atomicMin(slot, key[r][t]);
              }
            }
          }
        } else {
#pragma unroll
          for (int r = 0; r < kRounds; ++r) {
#pragma unroll
            for (int t = 0; t < 4; ++t) {
              // invalid edges carry any dst: drop them first
              const long long d = lane_of(d4[r], t);
              if (lane_of(v4[r], t) == 0 || d < ws || d >= ws + width) continue;
              const T* v = vrow + static_cast<long long>(lane_of(s4[r], t)) * B + g0;
              const T w = from_bits<T>(lane_of(w4[r], t));
              int* slot = tile + static_cast<int>(d - ws) * ncol;
              for (int j = 0; j < ncol; ++j) {
                T c = Op::gather(v[j]);
                if (kWeight == kArray) c = Op::transform(c, w);
                if (kWeight == kUnit) c = Op::transform(c, static_cast<T>(1));
                const int key = order_key(c);
                if (key < slot[j]) atomicMin(slot + j, key);
              }
            }
          }
        }
      }
      __syncthreads();
      for (int x = threadIdx.x; x < width * ncol; x += kBlockE) {
        const int key = tile[x];
        if (key >= cap) continue;  // no contribution lowered the slot
        const int k = x / ncol;
        T* p = orow + (ws + k) * B + g0 + (x - k * ncol);
        min_below(p, from_key<T>(key), key);
      }
      __syncthreads();  // the tile is refilled for the next window
    }
  }
}

template <class Op, int kWeight, int BG>
cudaError_t launch_tiled(const Tiled& a, cudaStream_t stream) {
  tiled_add_kernel<Op, kWeight, BG>
      <<<static_cast<unsigned>(a.NW), kBlockE, 0, stream>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || a.NM == 0) return err;
  merge_kernel<typename Op::T>
      <<<static_cast<unsigned>(a.NM), kBlockS, 0, stream>>>(a);
  return cudaGetLastError();
}

template <class Op, int kWeight>
cudaError_t launch_tiled_cols(const Tiled& a, cudaStream_t stream) {
  // column groups: a tile holds its words / BG segments of BG columns
  if (a.B == 1) return launch_tiled<Op, kWeight, 1>(a, stream);
  if (a.B == 2) return launch_tiled<Op, kWeight, 2>(a, stream);
  if (a.B <= 4) return launch_tiled<Op, kWeight, 4>(a, stream);
  return launch_tiled<Op, kWeight, 8>(a, stream);
}

template <class Op>
cudaError_t launch_tiled_add(int weight_mode, const Tiled& a,
                             cudaStream_t stream) {
  switch (weight_mode) {
    case kNone:
      return launch_tiled_cols<Op, kNone>(a, stream);
    case kArray:
      return launch_tiled_cols<Op, kArray>(a, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

template <class Op>
cudaError_t launch(int weight_mode, const int* band, const int* src,
                   const int* dst, const int* valid, const void* weight,
                   const void* vals, void* out, long long rows, long long E,
                   long long NB, long long V, long long S, int B, int cap,
                   cudaStream_t stream) {
  using T = typename Op::T;
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  const long long nblocks = rows * NB;
  const long long most = static_cast<long long>(sms) * 16;
  const unsigned grid =
      static_cast<unsigned>(nblocks < most ? nblocks : most);
  const T* w = static_cast<const T*>(weight);
  const T* v = static_cast<const T*>(vals);
  T* o = static_cast<T*>(out);
  switch (weight_mode) {
    case kNone:
      fused_push_kernel<Op, kNone><<<grid, kBlockE, 0, stream>>>(
          band, src, dst, valid, w, v, o, rows, E, NB, V, S, B, cap);
      break;
    case kArray:
      fused_push_kernel<Op, kArray><<<grid, kBlockE, 0, stream>>>(
          band, src, dst, valid, w, v, o, rows, E, NB, V, S, B, cap);
      break;
    case kUnit:
      fused_push_kernel<Op, kUnit><<<grid, kBlockE, 0, stream>>>(
          band, src, dst, valid, w, v, o, rows, E, NB, V, S, B, cap);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

template <class Op, bool kOneCol>
cudaError_t launch_tiled_min_cols(int weight_mode, const Tiled& a,
                                  cudaStream_t stream) {
  const unsigned grid = static_cast<unsigned>(a.NW);
  switch (weight_mode) {
    case kNone:
      tiled_min_kernel<Op, kNone, kOneCol><<<grid, kBlockE, 0, stream>>>(a);
      break;
    case kArray:
      tiled_min_kernel<Op, kArray, kOneCol><<<grid, kBlockE, 0, stream>>>(a);
      break;
    case kUnit:
      tiled_min_kernel<Op, kUnit, kOneCol><<<grid, kBlockE, 0, stream>>>(a);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

template <class Op>
cudaError_t launch_tiled_min(int weight_mode, const Tiled& a,
                             cudaStream_t stream) {
  return a.B == 1 ? launch_tiled_min_cols<Op, true>(weight_mode, a, stream)
                  : launch_tiled_min_cols<Op, false>(weight_mode, a, stream);
}

}  // namespace

// combine: 0 = add, 1 = min.  is_float: 0 = int32, 1 = float32 (vals,
// weight and out share it).  weight_mode: 0 none, 1 array, 2 unit.
// Edge planes are [rows, E] int32 with E a multiple of 256, band is
// [rows, 4, E / 256], vals [rows, V, B], out [rows, S, B] (already holding
// the identity or the init seed).  cap (min only): the order key
// (order_key in atomics.cuh) at and above which a contribution is skipped; out must
// hold no value whose key is above it.  Returns cudaGetLastError() after
// the launch (0 on success); launches nothing when there are no edge
// blocks.
extern "C" int fused_push_launch(int combine, int is_float, int weight_mode,
                                 const int* band, const int* src,
                                 const int* dst, const int* valid,
                                 const void* weight, const void* vals,
                                 void* out, long long rows, long long E,
                                 long long NB, long long V, long long S,
                                 int B, int cap, void* stream) {
  if (rows * NB == 0) return static_cast<int>(cudaSuccess);
  if (B < 1 || E != NB * kBlockE) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (combine == 0) {
    err = is_float ? launch<AddFloat>(weight_mode, band, src, dst, valid,
                                      weight, vals, out, rows, E, NB, V, S, B,
                                      cap, s)
                   : launch<AddInt>(weight_mode, band, src, dst, valid,
                                    weight, vals, out, rows, E, NB, V, S, B,
                                    cap, s);
  } else {
    err = is_float ? launch<MinFloat>(weight_mode, band, src, dst, valid,
                                      weight, vals, out, rows, E, NB, V, S, B,
                                      cap, s)
                   : launch<MinInt>(weight_mode, band, src, dst, valid,
                                    weight, vals, out, rows, E, NB, V, S, B,
                                    cap, s);
  }
  return static_cast<int>(err);
}

// The tiled add over the seg-sorted rows of a layout.  is_float: 0 = int32,
// 1 = float32.  weight_mode: 0 none, 1 array.  Operands as for
// fused_push_launch, plus the wrapper's schedule: chunks of kChunkBlocks
// edge blocks (NC, which must be ceil(NB / kChunkBlocks), a row);
// chunk_blocks [rows, NC, 2] int32, the first and last segment block of
// each chunk (bhi < blo: an empty chunk); tile_chunks [rows, NT, 2] int32,
// the first and last chunk whose range covers each segment block (c1 < c0:
// none); merge_tiles [NM] int32, the blocks r * NT + t that some chunk's
// range starts or ends in; work [NW, 3] int32, the tile pass's CTAs (chunk
// r * NC + c, and the first and last segment block of a piece of its
// range; a live chunk's pieces partition its range); and scratch
// [rows, NC, 2, 256, B] of the output type.  Segment blocks must lie in
// [0, ceil(S / 256)), and src, dst, valid and weight must be 16-byte
// aligned (they are read four edges at a time).  Launches the tile pass
// unless NW == 0, then the merge pass unless NM == 0; returns
// cudaGetLastError() after them (0 on success).
extern "C" int fused_push_add_tiled_launch(
    int is_float, int weight_mode, const int* band, const int* src,
    const int* dst, const int* valid, const void* weight, const void* vals,
    void* out, const int* chunk_blocks, const int* tile_chunks,
    const int* merge_tiles, const int* work, void* scratch, long long rows,
    long long E, long long NB, long long NC, long long V, long long S,
    long long NT, long long NM, long long NW, int B, void* stream) {
  if (rows * NB == 0 || NW == 0) return static_cast<int>(cudaSuccess);
  if (B < 1 || E != NB * kBlockE ||
      NC != (NB + kChunkBlocks - 1) / kChunkBlocks)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto bits = [](const void* p) { return reinterpret_cast<uintptr_t>(p); };
  if ((bits(src) | bits(dst) | bits(valid) | bits(weight)) & 15)
    return static_cast<int>(cudaErrorMisalignedAddress);
  const Tiled a{band, src, dst, valid, weight, vals, out, chunk_blocks,
                tile_chunks, merge_tiles, work, scratch, rows, E, NB, NC, V, S,
                NT, NM, NW, B, 0};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = is_float ? launch_tiled_add<AddFloat>(weight_mode, a, s)
                                   : launch_tiled_add<AddInt>(weight_mode, a, s);
  return static_cast<int>(err);
}

// The tiled min over the seg-sorted rows of a layout: one launch of
// tiled_min_kernel, one CTA per work item.  is_float: 0 = int32, 1 =
// float32.  weight_mode: 0 none, 1 array, 2 unit.  Operands and cap as for
// fused_push_launch, plus the work list [NW, 3] of the tiled add's
// schedule, on the rows the min tiles (chunk r * NC + c with NC =
// ceil(NB / kChunkBlocks), and the first and last segment block of a
// piece of its range).  Segment blocks must lie in [0, ceil(S / 256)),
// and src, dst, valid and weight must be 16-byte aligned.  Returns
// cudaGetLastError() after the launch (0 on success); launches nothing
// when NW == 0.
extern "C" int fused_push_min_tiled_launch(
    int is_float, int weight_mode, const int* band, const int* src,
    const int* dst, const int* valid, const void* weight, const void* vals,
    void* out, const int* work, long long rows, long long E, long long NB,
    long long NC, long long V, long long S, long long NW, int B, int cap,
    void* stream) {
  if (rows * NB == 0 || NW == 0) return static_cast<int>(cudaSuccess);
  if (B < 1 || E != NB * kBlockE ||
      NC != (NB + kChunkBlocks - 1) / kChunkBlocks)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto bits = [](const void* p) { return reinterpret_cast<uintptr_t>(p); };
  if ((bits(src) | bits(dst) | bits(valid) | bits(weight)) & 15)
    return static_cast<int>(cudaErrorMisalignedAddress);
  const Tiled a{band, src, dst, valid, weight, vals, out, nullptr,
                nullptr, nullptr, work, nullptr, rows, E, NB, NC, V, S,
                0, 0, NW, B, cap};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      is_float ? launch_tiled_min<MinFloat>(weight_mode, a, s)
               : launch_tiled_min<MinInt>(weight_mode, a, s);
  return static_cast<int>(err);
}
