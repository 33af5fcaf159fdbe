// Warp-segment helpers shared by the CSR kernels of this directory.
//
// ops/csr_spmm.py::prepare cuts every row of a CSR (or CSC) view into warp
// segments of at most SEG_EDGES edges.  A row cut into several segments is a
// split row: each of its segments writes a partial row to scratch, and the
// last warp of the row to arrive merges them in the same grid.  The CSR
// kernel (csr_spmm.cu) and gat_dwh (gat_attn.cu) take merge_split_row below;
// gat_fwd (gat_attn.cu), whose partial rows carry a softmax state each, has
// its own merge.
#pragma once

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

// The launch plan of one view: what never changes between calls, built once
// per view by ops/csr_spmm.py::LaunchPlan.  Field order and types match
// _PlanStruct there.  The CSR kernel and the GAT kernels of one view share
// it, arrival counters included: every launch leaves the counters at 0, and
// calls on one view are ordered on one stream, so no two launches count on
// them at once.
struct CsrPlan {
  const int64_t* seg_ptr;     // [S+1] edge span of each segment
  const int32_t* seg_row;     // [S]   output row of each segment
  const int32_t* seg_slot;    // [S]   -1: whole row; else its partial slot
  const int32_t* split_row;   // [R]   rows cut into several segments
  const int32_t* split_ptr;   // [R+1] their spans of partial slots
  const int32_t* slot_split;  // [n_slots] split row (index into split_row) of each slot
  const int32_t* empty_row;   // [K]   rows without a segment
  const int32_t* col;         // [L]   gathered table row of each position
  const float* w;             // [L]   edge weights
  int32_t* arrivals;          // [n_arrivals] zero between calls
  int64_t n_seg;
  int64_t n_split;
  int64_t n_empty;
  int64_t n_arrivals;
};

namespace gode {

constexpr int kWarpsPerBlock = 8;
constexpr int kThreads = kWarpsPerBlock * 32;
constexpr unsigned kFullMask = 0xffffffffu;

// Lanes of one edge slot: the smallest power of two >= F, at most 32.
inline int lanes_for(int64_t F) {
  return F >= 32 ? 32 : F > 8 ? 16 : F > 4 ? 8 : F > 2 ? 4 : F > 1 ? 2 : 1;
}

namespace {

// bfloat16 <-> float.  A bf16 value is the high half of its float, so the
// widening is exact: a shift (the low element of a 32-bit pair) or a mask
// (the high one).  Narrowing rounds once, to nearest even.
__device__ __forceinline__ float bf16_lo(uint32_t u) { return __uint_as_float(u << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t u) { return __uint_as_float(u & 0xffff0000u); }
__device__ __forceinline__ uint32_t bf16_bits(float x) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(x));
}
__device__ __forceinline__ uint32_t bf16_pair(float lo, float hi) {
  return bf16_bits(lo) | (bf16_bits(hi) << 16);
}

// V consecutive features of one lane, held as floats: a float or a float4.
// The loads and stores take the storage type by pointer: float (a float4 is
// one 16-byte load) or __nv_bfloat16 (4 bf16 are one 8-byte load, widened
// to floats; a store rounds each float once).  Every sum stays in floats.
template <int V> struct Lane;

template <> struct Lane<1> {
  float v;
  __device__ __forceinline__ static Lane zero() { return {0.f}; }
  __device__ __forceinline__ static Lane ldg(const float* p) { return {__ldg(p)}; }
  __device__ __forceinline__ static Lane ldg(const __nv_bfloat16* p) {
    return {bf16_lo(__ldg(reinterpret_cast<const unsigned short*>(p)))};
  }
  __device__ __forceinline__ static Lane ldcg(const float* p) { return {__ldcg(p)}; }
  __device__ __forceinline__ static Lane ld(const float* p) { return {*p}; }
  __device__ __forceinline__ static Lane ld(const __nv_bfloat16* p) {
    return {bf16_lo(*reinterpret_cast<const unsigned short*>(p))};
  }
  __device__ __forceinline__ void st(float* p) const { *p = v; }
  __device__ __forceinline__ void st(__nv_bfloat16* p) const { *p = __float2bfloat16_rn(v); }
  __device__ __forceinline__ void fma(float a, const Lane& b) { v = fmaf(a, b.v, v); }
  __device__ __forceinline__ void add(const Lane& b) { v += b.v; }
  __device__ __forceinline__ void div(float a) { v /= a; }
  __device__ __forceinline__ float dot(const Lane& b) const { return v * b.v; }
  __device__ __forceinline__ Lane shfl_xor(int off) const {
    return {__shfl_xor_sync(kFullMask, v, off)};
  }
};

template <> struct Lane<4> {
  float4 v;
  __device__ __forceinline__ static Lane zero() { return {make_float4(0.f, 0.f, 0.f, 0.f)}; }
  __device__ __forceinline__ static Lane ldg(const float* p) {
    return {__ldg(reinterpret_cast<const float4*>(p))};
  }
  __device__ __forceinline__ static Lane ldcg(const float* p) {
    return {__ldcg(reinterpret_cast<const float4*>(p))};
  }
  __device__ __forceinline__ static Lane ld(const float* p) {
    return {*reinterpret_cast<const float4*>(p)};
  }
  __device__ __forceinline__ static Lane ldg(const __nv_bfloat16* p) {
    return widen(__ldg(reinterpret_cast<const uint2*>(p)));
  }
  __device__ __forceinline__ static Lane ld(const __nv_bfloat16* p) {
    return widen(*reinterpret_cast<const uint2*>(p));
  }
  __device__ __forceinline__ static Lane widen(uint2 u) {
    return {make_float4(bf16_lo(u.x), bf16_hi(u.x), bf16_lo(u.y), bf16_hi(u.y))};
  }
  __device__ __forceinline__ void st(float* p) const { *reinterpret_cast<float4*>(p) = v; }
  __device__ __forceinline__ void st(__nv_bfloat16* p) const {
    *reinterpret_cast<uint2*>(p) = make_uint2(bf16_pair(v.x, v.y), bf16_pair(v.z, v.w));
  }
  __device__ __forceinline__ void fma(float a, const Lane& b) {
    v.x = fmaf(a, b.v.x, v.x);
    v.y = fmaf(a, b.v.y, v.y);
    v.z = fmaf(a, b.v.z, v.z);
    v.w = fmaf(a, b.v.w, v.w);
  }
  __device__ __forceinline__ void add(const Lane& b) {
    v.x += b.v.x;
    v.y += b.v.y;
    v.z += b.v.z;
    v.w += b.v.w;
  }
  __device__ __forceinline__ void div(float a) {
    v.x /= a;
    v.y /= a;
    v.z /= a;
    v.w /= a;
  }
  __device__ __forceinline__ float dot(const Lane& b) const {
    return fmaf(v.w, b.v.w, fmaf(v.z, b.v.z, fmaf(v.y, b.v.y, v.x * b.v.x)));
  }
  __device__ __forceinline__ Lane shfl_xor(int off) const {
    return {make_float4(__shfl_xor_sync(kFullMask, v.x, off), __shfl_xor_sync(kFullMask, v.y, off),
                        __shfl_xor_sync(kFullMask, v.z, off), __shfl_xor_sync(kFullMask, v.w, off))};
  }
};

// Adds the lanes of the warp's 32/G edge slots: lane l ends with the sum over
// the slots of its feature lane l % G, in a fixed order.
template <int G, int V>
__device__ __forceinline__ Lane<V> sum_slots(Lane<V> acc) {
#pragma unroll
  for (int off = 16; off >= G; off >>= 1) acc.add(acc.shfl_xor(off));
  return acc;
}

// The last-warp merge of a split row, for the warp item of a segment of a
// split row (partial slot `slot`) and feature chunk `chunk`.  Lane l holds in
// `acc` the segment's sum at features f .. f+V-1 of the row (`live`: f < F),
// its edge slots already added.  The lanes of edge slot 0 write it to the
// slot's row of `partial` [n_slots, F]; after a __threadfence the warp counts
// its arrival on the plan's counter of (split row, chunk).  Returns false in
// every warp but the last to arrive.  The last resets the counter to 0 (the
// next call starts from zero), reads the partial rows through L2 and adds
// them in slot order (edge slot sub takes slots k0 + sub, k0 + sub + 32/G,
// ..., then a fixed shuffle tree), and leaves the row's sum in `acc` and the
// split row in `row`.  So the sum does not depend on scheduling.
template <int G, int V>
__device__ __forceinline__ bool merge_split_row(const CsrPlan& plan, int slot, int64_t chunk,
                                                float* partial, int64_t F, int64_t f, bool live,
                                                Lane<V>& acc, int64_t& row) {
  constexpr int kSlots = 32 / G;
  const int lane = threadIdx.x & 31;
  const int sub = lane / G;
  if (sub == 0 && live) acc.st(partial + static_cast<int64_t>(slot) * F + f);
  __threadfence();
  __syncwarp();
  const int j = plan.slot_split[slot];
  const int k0 = plan.split_ptr[j];
  const int k1 = plan.split_ptr[j + 1];
  int32_t* counter = plan.arrivals + chunk * plan.n_split + j;
  int before = 0;
  if (lane == 0) before = atomicAdd(counter, 1);
  before = __shfl_sync(kFullMask, before, 0);
  if (before != k1 - k0 - 1) return false;  // not the last to arrive (uniform across the warp)
  // The last: every partial row of this split row and chunk is written.
  __threadfence();
  if (lane == 0) *counter = 0;
  Lane<V> sum = Lane<V>::zero();
  if (live) {
#pragma unroll 4
    for (int k = k0 + sub; k < k1; k += kSlots) {
      sum.add(Lane<V>::ldcg(partial + static_cast<int64_t>(k) * F + f));
    }
  }
  acc = sum_slots<G, V>(sum);
  row = plan.split_row[j];
  return true;
}

}  // namespace
}  // namespace gode
