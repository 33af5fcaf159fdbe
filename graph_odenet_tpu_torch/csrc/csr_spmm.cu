// CSR SpMM for Hopper (sm_90a): out[r, :] = sum_{p in row r} w[p] * x[col[p], :].
//
// Replaces: graph_odenet_tpu/ops/pallas_spmm.py::_sched_kernel, the CSR
// segment reduction that spmm_pallas runs forward over the receiver-sorted
// view and backward over the sender-sorted (CSC) view.  The TPU kernel left
// the gather x[senders] * w outside, materialised an [E, F] message array
// and reduced it with one-hot MXU matmuls.  Here gather, weight and
// reduction are one pass: no message array, and each output row is written
// once.
//
// What bounds it on the card: the bytes of the gather.  Each edge reads one
// row of x (4*F bytes from a random row) plus 8 bytes of column and weight;
// there are 2 flops per gathered float, far below what the card could
// compute per byte.  What the design does about it:
//   * a warp item is one warp segment (at most SEG_EDGES edges of one row;
//     ops/csr_spmm.py::prepare cuts the rows) times one feature chunk.  Its
//     lanes split into 32/G edge slots of G feature lanes, each lane holding
//     V consecutive features, so a chunk is G*V features wide.  The wrapper
//     picks G and V from F (ops/csr_spmm.py::_lanes): at F >= 32 (F a
//     multiple of 4, 16-byte aligned rows) a lane loads a float4, a 16-byte
//     gather, and a chunk holds up to 128 features; below, V = 1 and G is
//     the smallest power of two >= F, so at F = 16 or F = 3 a warp still
//     reads 32 useful floats per step from 2 or 8 edges at once.  The chunk
//     is the slowest axis of the grid.  A gathered table whose 128-feature
//     column slice outgrows L2 takes the resident walk below instead.
//   * with float4 lanes a warp loads 32 columns and weights at once, one per
//     lane, and broadcasts them with shuffles; four accumulators per lane
//     keep four gathers in flight.  With single lanes each edge slot loads
//     its own edges' columns and weights: a Pubmed row has about 5 edges,
//     too few to pay for a batch of 32 and its shuffles.  The edge slots are
//     added with shuffles;
//   * a hub row longer than one segment is spread over several warps, which
//     write partial rows to scratch.  The last of them to arrive (an integer
//     arrival counter per split row and chunk, after a __threadfence) adds
//     the partial rows in slot order and resets the counter to 0
//     (segments.cuh::merge_split_row, which gat_dwh shares).  So the
//     sum never depends on scheduling, repeated calls are bit-equal, and the
//     call is one launch that a CUDA graph can capture.
// Weighted mode (kAlpha): lane f of edge p is scaled by
// alpha[p * (F / feat) + f / feat] instead of w[p].  It replaces the same
// kernel's alpha3d mode, which the GAT backward without the score hint
// (pallas_gat.py::_dwh_csc) runs over the CSC view.  A lane's head is fixed
// for its chunk (the vector form needs feat % 4 == 0), so the mode costs one
// more load per edge.
//
// Bucket mode: out[r, :] (+)= sum_{p in row r} w[p] * x[col[p], :] over one
// bucket of the edge-partitioned graph.  It replaces
// pallas_spmm.py::_segment_reduce_kernel (B2), which parallel/halo.py runs per
// bucket of a receiver block: forward over the bucket's CSR view, backward over
// its CSC view.  The gathered table x is rectangular: a [B, F] feature chunk of
// the sender block, or, positional (kPositional), the bucket's [E, F] message
// array itself (column = edge position, weight 1).  The bucket's segments
// skip rows without edges, so an empty row costs no warp item.  Two forms:
//   * accumulate: the result is added into out, so a ring hop folds into the
//     running sum without a temporary; empty rows are untouched;
//   * write (the first bucket of a receiver block): out is written and never
//     read; extra warps of the same grid write zeros to the empty rows.
// Weighted bucket mode (kAlpha on a bucket; B2-w): out[r, h*feat + f] (+)=
// sum_{p in row r} alpha[p * H + h] * x[col[p], h*feat + f], the same
// kernel's alpha3d mode that parallel/halo.py::_bucket_spmm_weighted runs per
// ring hop of the edge-partitioned GAT, forward over the bucket's CSR view and
// backward (numerators permuted) over its CSC view.
//
// Resident walk (csr_reduce_kernel_l2): f32 calls in a gathering mode on the
// G = 32, V = 4 lanes whose table's 128-feature column slice outgrows L2
// (ops/csr_spmm.py::walk_width).  At the arxiv twin's 169,344 rows that slice
// is 86.7 MB, and its random gathers miss the 50 MB L2: the same F = 128 call
// with its columns remapped col % R took 0.280 ms at 86.7 MB, 0.223 at 43.4,
// 0.178 at 21.7 and 0.160 at 5.4 (H100).  The walk cuts F into chunks of 32
// features (21.7 MB at the twin), walked one after another by the grid, the
// gathers of x evict-last in L2, the columns, weights and partial rows
// evict-first, out streamed.  Narrow chunks pay per segment and chunk what
// wide ones pay per segment (the G = 8 schedule's four edge slots took 0.111
// ms an F = 32 chunk, 0.89 for F = 256), so a warp item here is four segments
// of 8 float4 lanes, each lane walking all of its segment's edges with the
// accumulators of G = 32, V = 4 (the same bits), and the registers are
// capped at 64 so that 32 warps fit an SM: uncapped, 8 gathers in flight
// took 90-100 registers and 0.73 ms a B2 call at F = 256; capped, 4 in
// flight, 0.44 ms against 0.56 for the G = 32 schedule (B2-w at H = 1: 0.49
// against 0.65).
//
// bfloat16 (gode_csr_reduce_bf16): x and out in bf16, the plain and bucket
// modes (scaled and positional), for JAX's bf16-training tier (spmm_pallas
// on bf16 messages, whose kernels add in f32 and write the messages' dtype).
// A lane loads 4 bf16 (8 bytes) or 1 and widens them to floats; weights,
// products, the edge slots' shuffles, the split rows' partial rows and
// their merge stay f32, and each output element is rounded once, when it is
// stored (the accumulate form adds the f32 sum to the widened out, then
// rounds).  The bytes halve; the schedule is the f32 one.  The weighted
// modes take f32 only: their tables (the GAT backward's g) are f32.
//
// Per-edge dot (gode_edge_dot_f32): out[p, h] = sum_f x[col[p], h*feat + f]
// * g[r_p, h*feat + f] over a view's receiver-sorted edges, r_p the row of
// position p: B2-w's gradient for its numerators (dpv), run over the
// bucket's CSR view.  It replaces no TPU kernel: the JAX package leaves dpv
// to XLA (graph_odenet_tpu/parallel/halo.py::_bucket_spmm_weighted_bwd, two
// [E, H*F] gathers, a product and a sum), and so did the port until this
// kernel, at three [E, H*F] f32 temporaries a call.  What bounds it: the
// bytes of the gather of x's rows, as in B2-w's forward (the same rows over
// the same plan); g is read once a row, out written once, 2 flops per
// gathered float.  What the design does about it:
//   * a warp item is one warp segment, so the segment's receiver row of g is
//     loaded once per feature chunk and 32 edges (one register a lane), and
//     the warp gathers the edges' rows of x with the lanes of the CSR kernel
//     (ops/csr_spmm.py::_lanes: float4 lanes at feat % 4 == 0 and aligned
//     rows, single lanes otherwise), four edges in flight per edge slot.
//     One chunk at a time keeps a lane at 64 registers at H*F = 256, so 32
//     warps fit an SM; holding two chunks a pass took 96 and half the
//     warps, and 1.17 ms where one chunk takes 0.62 (H100, H = 1, F = 256);
//   * each lane multiplies its features and the lanes of one head are added
//     by a segmented shuffle scan within the edge slot; the last lane of a
//     head in a chunk adds the chunk's sum into the warp's shared buffer of
//     32 edges x H (written by the chunk where the head starts, added by the
//     later ones, in chunk order), and the batch's [n, H] results leave in
//     one coalesced store;
//   * no split-row merge, no arrival counter and no atomic: every edge's dot
//     belongs to one warp, so repeated calls are bit-equal and the call is
//     one capturable launch.
//
// The attention softmax's order-free per-edge passes
// (parallel/sharded_gat.py::edge_softmax and the gathers around it, shared by
// the sharded GAT-ODE and GRAND-nl).  Neither replaces a TPU kernel: the JAX
// package leaves them to XLA, and the port left them to PyTorch, whose
// index_select took 1.23 ms a call on 2.04 M indices for rows of 16 bytes or
// more (H = 4 f32; 0.02 ms for rows of 4 or 8 bytes) and whose scatter_reduce
// "amax" 0.6-1.4 ms (a float CAS loop per edge, about 12 consecutive lanes of
// receiver-sorted edges on one address; H100).  Neither takes a sum, so both
// give the same bits in any order, and every sum of the softmax stays on
// index_add_.
//
// Narrow-row gather (gode_gather_rows): out[p, :] = table[idx[p], :].  What
// bounds it: bytes, [E, H] written and E indices read (the table's 169,344
// short rows sit in L2).  Design: one thread per 16-byte vector of output, so
// a warp's stores are one contiguous span and its index loads coalesce: a
// row that is a multiple of 16 bytes is copied in 16-byte units; a row of 2,
// 4 or 8 bytes (H = 1 in f32, H = 4 in bf16) is packed, a thread gathering
// the 16 / row-bytes consecutive rows of one 16-byte store, its loads all in
// flight; any other row (or a strided table) one element a thread.  A copy of
// bits, so any dtype of 2 or 4 bytes is exact.  An index out of range stops
// the kernel with a device-side assert, as index_select does.
//
// Per-receiver max (gode_segment_max): out[r, h] = max(out[r, h], max over
// the edges p with rows[p] = r of e[p, h]), out filled with the floor by the
// wrapper.  What bounds it: bytes, [E, H] values and E indices read.  Design:
// one thread per value (an edge's head), so the loads coalesce, each value
// mapped to an int that orders as the float does (NaN above everything, +0
// above -0).  Lanes l and l + H of a warp hold one head of consecutive edges:
// the lanes of one head and one run of equal rows are reduced by a segmented
// shuffle scan at strides H, 2H, ..., and the run's first lane makes one
// atomic on the float's own bits: an atomicMax of a non-negative float as an
// int, an atomicMin of a negative one as an unsigned (bf16: a CAS on the
// 32-bit word that holds it).  A warp's atomics land on the rows of its
// edges, the heads of a row side by side, so even rows in no order (every
// lane its own atomic) cost a row's sector per edge, not per value.  Rows in
// any order give the same result.
#include <cassert>
#include <climits>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <type_traits>

#include "segments.cuh"

namespace {

using gode::kFullMask;
using gode::kThreads;
using gode::kWarpsPerBlock;
using gode::Lane;
using gode::merge_split_row;
using gode::sum_slots;

// kScaled: w[p] * x[col[p]].  kAlpha: alpha-scaled lanes.  kPositional: x[p].
// Values match the wrapper's.
enum class Mode : int { kScaled = 0, kAlpha = 1, kPositional = 2 };

// One lane's share of a segment's sum, over the edges [p0, p1), at features
// f .. f+V-1 (`live`: f < F).  Every lane runs the same number of steps, so
// the shuffles see the whole warp.  Single lanes (V = 1): each edge slot
// loads its own edges' columns and weights.
template <int G, int V, Mode kMode, class T>
__device__ __forceinline__ Lane<V> gather_segment(const CsrPlan& plan, const T* __restrict__ x,
                                                  const float* __restrict__ alpha, int64_t F,
                                                  int64_t heads, int64_t head, int64_t p0,
                                                  int64_t p1, int lane, int64_t f, bool live) {
  constexpr int kSlots = 32 / G;
  const int sub = lane / G;
  if constexpr (V == 1) {
    Lane<V> acc = Lane<V>::zero();
    for (int64_t p = p0 + sub; live && p < p1; p += kSlots) {
      if constexpr (kMode == Mode::kPositional) {
        acc.add(Lane<V>::ldg(x + p * F + f));
      } else {
        const T* row = x + static_cast<int64_t>(__ldg(plan.col + p)) * F + f;
        acc.fma(kMode == Mode::kScaled ? __ldg(plan.w + p) : __ldg(alpha + p * heads + head),
                Lane<V>::ldg(row));
      }
    }
    return sum_slots<G, V>(acc);
  } else {  // float4 lanes: batches of 32 edges, four gathers in flight per lane
    constexpr int kUnroll = 4;  // kSlots <= 4, so kSlots * kUnroll divides 32
    Lane<V> acc[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) acc[u] = Lane<V>::zero();
    for (int64_t pb = p0; pb < p1; pb += 32) {
      const int n = static_cast<int>(p1 - pb < 32 ? p1 - pb : 32);
      // One lane per edge of the batch loads its column and weight.
      int c_mine = 0;
      float w_mine = 0.f;
      if constexpr (kMode != Mode::kPositional) {
        if (lane < n) {
          c_mine = __ldg(plan.col + pb + lane);
          if constexpr (kMode == Mode::kScaled) w_mine = __ldg(plan.w + pb + lane);
        }
      }
      for (int e0 = 0; e0 < n; e0 += kSlots * kUnroll) {
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int e = e0 + u * kSlots + sub;  // < 32
          if constexpr (kMode == Mode::kPositional) {
            if (live && e < n) acc[u].add(Lane<V>::ldg(x + (pb + e) * F + f));
          } else {
            const int64_t c = __shfl_sync(kFullMask, c_mine, e);
            if constexpr (kMode == Mode::kScaled) {
              const float wt = __shfl_sync(kFullMask, w_mine, e);
              if (live && e < n) acc[u].fma(wt, Lane<V>::ldg(x + c * F + f));
            } else {
              if (live && e < n) {
                acc[u].fma(__ldg(alpha + (pb + e) * heads + head), Lane<V>::ldg(x + c * F + f));
              }
            }
          }
        }
      }
    }
#pragma unroll
    for (int u = 1; u < kUnroll; ++u) acc[0].add(acc[u]);
    return sum_slots<G, V>(acc[0]);
  }
}

// Grid: warp items (segment s, chunk k) with the chunk slowest, then, in the
// write form, one warp per empty row.  A chunk is G*V features wide.  T is
// the storage type of x and out (float or __nv_bfloat16).
template <int G, int V, Mode kMode, class T>
__global__ void __launch_bounds__(kThreads)
csr_reduce_kernel(const CsrPlan plan, const T* __restrict__ x, const float* __restrict__ alpha,
                  T* __restrict__ out, float* __restrict__ partial, int64_t F, int64_t feat,
                  int64_t n_chunks, int add) {
  constexpr int64_t kWidth = G * V;
  const int64_t item = (static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  const int64_t n_items = plan.n_seg * n_chunks;
  if (item >= n_items) {  // the write form's empty rows: zeros
    const int64_t j = item - n_items;
    if (add || j >= plan.n_empty) return;
    T* dst = out + static_cast<int64_t>(plan.empty_row[j]) * F;
    for (int64_t f = static_cast<int64_t>(lane) * V; f < F; f += 32 * V) Lane<V>::zero().st(dst + f);
    return;
  }
  const int64_t chunk = item / plan.n_seg;
  const int64_t s = item - chunk * plan.n_seg;
  const int sub = lane / G;
  const int64_t f = chunk * kWidth + (lane % G) * V;
  const bool live = f < F;  // F % V == 0, so the lane's V features are all in range
  const int64_t heads = kMode == Mode::kAlpha ? F / feat : 1;
  const int64_t head = kMode == Mode::kAlpha ? (live ? f / feat : 0) : 0;
  Lane<V> acc = gather_segment<G, V, kMode, T>(plan, x, alpha, F, heads, head, plan.seg_ptr[s],
                                            plan.seg_ptr[s + 1], lane, f, live);
  int64_t row = plan.seg_row[s];
  const int slot = plan.seg_slot[s];
  // A segment of a split row: only the last of the row's warps to arrive writes it.
  if (slot >= 0 && !merge_split_row<G, V>(plan, slot, chunk, partial, F, f, live, acc, row)) return;
  if (sub == 0 && live) {
    T* dst = out + row * F + f;
    if (add) acc.add(Lane<V>::ld(dst));
    acc.st(dst);
  }
}

// L2 policies (createpolicy, sm_80+) and the loads that carry them.
__device__ __forceinline__ uint64_t l2_evict_last() {
  uint64_t p;
  asm("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;" : "=l"(p));
  return p;
}
__device__ __forceinline__ uint64_t l2_evict_first() {
  uint64_t p;
  asm("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;" : "=l"(p));
  return p;
}
__device__ __forceinline__ int ld_hint(const int32_t* p, uint64_t pol) {
  int v;
  asm("ld.global.nc.L2::cache_hint.b32 %0, [%1], %2;" : "=r"(v) : "l"(p), "l"(pol));
  return v;
}
__device__ __forceinline__ float ld_hint(const float* p, uint64_t pol) {
  float v;
  asm("ld.global.nc.L2::cache_hint.f32 %0, [%1], %2;" : "=f"(v) : "l"(p), "l"(pol));
  return v;
}

// A float4 lane of the resident walk through the non-coherent path with an
// L2 policy (the gathered table), or through L2 only with one (partial rows
// other warps wrote in this launch); streamed (evict-first) out and back.
__device__ __forceinline__ Lane<4> ldg_hint(const float* p, uint64_t pol) {
  float4 v;
  asm("ld.global.nc.L2::cache_hint.v4.f32 {%0, %1, %2, %3}, [%4], %5;"
      : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w) : "l"(p), "l"(pol));
  return {v};
}
__device__ __forceinline__ Lane<4> ldcg_hint(const float* p, uint64_t pol) {
  float4 v;
  asm volatile("ld.global.cg.L2::cache_hint.v4.f32 {%0, %1, %2, %3}, [%4], %5;"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w) : "l"(p), "l"(pol) : "memory");
  return {v};
}
__device__ __forceinline__ Lane<4> ldcs(const float* p) {
  return {__ldcs(reinterpret_cast<const float4*>(p))};
}
__device__ __forceinline__ void stcs(float* p, const Lane<4>& a) {
  __stcs(reinterpret_cast<float4*>(p), a.v);
}

// The resident walk's shape: kWalkLanes float4 lanes a segment (a chunk of
// 4 * kWalkLanes features), columns and weights of kWalkCols * kWalkLanes
// edges loaded at once, kWalkDepth gathers and kMergeDepth partial rows in
// flight a lane, registers capped for kWalkBlocks blocks an SM (64 a thread).
constexpr int kWalkLanes = 8;
constexpr int kWalkCols = 2;
constexpr int kWalkDepth = 4;
constexpr int kWalkBlocks = 4;
constexpr int kMergeDepth = 8;

// The resident walk (f32, scaled or weighted; see the header).  Grid: warp
// items (group of 32/L consecutive segments, chunk) with the chunk slowest,
// then, in the write form, one warp per empty row.  L = kWalkLanes lanes own
// one segment, lane j features f .. f+3 of the chunk (4L wide), and walk all
// of the segment's edges, the warp as long as its longest segment: lane j
// loads the columns and weights of edges b + j + L*i (i < kWalkCols) of each
// batch of kWalkCols*L edges, shuffles hand them round, and edge offset o
// (from the segment's start) goes into acc[o % 4], in order.  So every output
// element takes the G = 32, V = 4 schedule's association: ((acc0 + acc1) +
// acc2) + acc3, a split row's partial rows 0 + p[k0] + p[k0+1] + ... in slot
// order, the accumulate form's old out last.
template <Mode kMode>
__global__ void __launch_bounds__(kThreads, kWalkBlocks)
csr_reduce_kernel_l2(const CsrPlan plan, const float* __restrict__ x,
                     const float* __restrict__ alpha, float* __restrict__ out,
                     float* __restrict__ partial, int64_t F, int64_t feat, int64_t n_chunks,
                     int add) {
  static_assert(kMode != Mode::kPositional, "the walk gathers");
  constexpr int L = kWalkLanes, V = 4, D = kWalkDepth;
  constexpr int kGroups = 32 / L;  // segments a warp item
  constexpr int kBatch = kWalkCols * L;
  constexpr int64_t kWidth = L * V;
  const int64_t item = (static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  const int64_t n_quads = (plan.n_seg + kGroups - 1) / kGroups;
  const int64_t n_items = n_quads * n_chunks;
  if (item >= n_items) {  // the write form's empty rows: zeros
    const int64_t e = item - n_items;
    if (add || e >= plan.n_empty) return;
    float* dst = out + static_cast<int64_t>(plan.empty_row[e]) * F;
    for (int64_t f = static_cast<int64_t>(lane) * V; f < F; f += 32 * V) {
      stcs(dst + f, Lane<4>::zero());
    }
    return;
  }
  const int64_t chunk = item / n_quads;
  const int64_t s = (item - chunk * n_quads) * kGroups + lane / L;
  const bool real = s < plan.n_seg;  // a group past the last segment walks nothing
  const int j = lane % L;
  const int64_t f = chunk * kWidth + static_cast<int64_t>(j) * V;
  const int64_t heads = kMode == Mode::kAlpha ? F / feat : 1;
  const int64_t head = kMode == Mode::kAlpha ? f / feat : 0;
  const uint64_t keep = l2_evict_last(), once = l2_evict_first();
  const int64_t p0 = real ? plan.seg_ptr[s] : 0;
  const int len = real ? static_cast<int>(plan.seg_ptr[s + 1] - p0) : 0;
  const int64_t row0 = real ? plan.seg_row[s] : 0;
  const int slot = real ? plan.seg_slot[s] : -1;
  Lane<4> acc[4];
#pragma unroll
  for (int u = 0; u < 4; ++u) acc[u] = Lane<4>::zero();
  const int most = __reduce_max_sync(kFullMask, len);
  // b is a multiple of 4, so edge b + e goes to acc[e % 4].
  for (int b = 0; b < most; b += kBatch) {
    int c_mine[kWalkCols];
    float w_mine[kWalkCols];
#pragma unroll
    for (int i = 0; i < kWalkCols; ++i) {
      const int e = b + i * L + j;
      c_mine[i] = e < len ? ld_hint(plan.col + p0 + e, once) : 0;
      w_mine[i] = kMode == Mode::kScaled && e < len ? ld_hint(plan.w + p0 + e, once) : 0.f;
    }
    const int n = len - b;
#pragma unroll
    for (int e0 = 0; e0 < kBatch; e0 += D) {
      Lane<4> xv[D];
      float wt[D];
#pragma unroll
      for (int u = 0; u < D; ++u) {
        const int e = e0 + u;
        const int c = __shfl_sync(kFullMask, c_mine[e / L], e % L, L);
        if constexpr (kMode == Mode::kScaled) {
          wt[u] = __shfl_sync(kFullMask, w_mine[e / L], e % L, L);
        } else {
          if (e < n) wt[u] = ld_hint(alpha + (p0 + b + e) * heads + head, once);
        }
        if (e < n) xv[u] = ldg_hint(x + static_cast<int64_t>(c) * F + f, keep);
      }
#pragma unroll
      for (int u = 0; u < D; ++u) {
        if (e0 + u < n) acc[(e0 + u) % 4].fma(wt[u], xv[u]);
      }
    }
  }
  if (!real) return;
#pragma unroll
  for (int u = 1; u < 4; ++u) acc[0].add(acc[u]);
  int64_t row = row0;
  if (slot >= 0) {  // a split row's segment: only the last of its groups to arrive writes it
    acc[0].st(partial + static_cast<int64_t>(slot) * F + f);
    __threadfence();
    static_assert(L < 32, "a segment's lanes are part of a warp");
    const unsigned group = ((1u << L) - 1u) << (lane - j);  // the segment's lanes
    __syncwarp(group);
    const int r = plan.slot_split[slot];
    const int k0 = plan.split_ptr[r], k1 = plan.split_ptr[r + 1];
    int32_t* counter = plan.arrivals + chunk * plan.n_split + r;
    int before = 0;
    if (j == 0) before = atomicAdd(counter, 1);
    before = __shfl_sync(group, before, 0, L);
    if (before != k1 - k0 - 1) return;  // not the last to arrive (uniform across the group)
    __threadfence();
    if (j == 0) *counter = 0;
    Lane<4> sum = Lane<4>::zero();
    for (int k = k0; k < k1; k += kMergeDepth) {
      Lane<4> part[kMergeDepth];
#pragma unroll
      for (int u = 0; u < kMergeDepth; ++u) {
        if (k + u < k1) part[u] = ldcg_hint(partial + static_cast<int64_t>(k + u) * F + f, once);
      }
#pragma unroll
      for (int u = 0; u < kMergeDepth; ++u) {
        if (k + u < k1) sum.add(part[u]);
      }
    }
    acc[0] = sum;
    row = plan.split_row[r];
  }
  float* dst = out + row * F + f;
  if (add) acc[0].add(ldcs(dst));
  stcs(dst, acc[0]);
}

int launch_walk(const CsrPlan& plan, const float* x, const float* alpha, float* out,
                float* partial, int64_t F, int64_t feat, int mode, int add, cudaStream_t st) {
  constexpr int64_t kGroups = 32 / kWalkLanes;
  const int64_t n_chunks = F / (4 * kWalkLanes);
  if (F % (4 * kWalkLanes) != 0 || plan.n_split * n_chunks > plan.n_arrivals ||
      mode == static_cast<int>(Mode::kPositional)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t warps = (plan.n_seg + kGroups - 1) / kGroups * n_chunks + (add ? 0 : plan.n_empty);
  const int64_t blocks = (warps + kWarpsPerBlock - 1) / kWarpsPerBlock;
  if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  if (blocks == 0) return 0;
  const unsigned nb = static_cast<unsigned>(blocks);
  if (static_cast<Mode>(mode) == Mode::kScaled) {
    csr_reduce_kernel_l2<Mode::kScaled>
        <<<nb, kThreads, 0, st>>>(plan, x, alpha, out, partial, F, feat, n_chunks, add);
  } else {
    csr_reduce_kernel_l2<Mode::kAlpha>
        <<<nb, kThreads, 0, st>>>(plan, x, alpha, out, partial, F, feat, n_chunks, add);
  }
  return static_cast<int>(cudaGetLastError());
}

template <int G, int V, class T>
int launch(const CsrPlan& plan, const T* x, const float* alpha, T* out, float* partial,
           int64_t F, int64_t feat, int mode, int add, cudaStream_t st) {
  const int64_t n_chunks = (F + G * V - 1) / (G * V);
  if (plan.n_split * n_chunks > plan.n_arrivals) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t warps = plan.n_seg * n_chunks + (add ? 0 : plan.n_empty);
  const int64_t blocks = (warps + kWarpsPerBlock - 1) / kWarpsPerBlock;
  if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  if (blocks == 0) return 0;
  const unsigned nb = static_cast<unsigned>(blocks);
  switch (static_cast<Mode>(mode)) {
    case Mode::kScaled:
      csr_reduce_kernel<G, V, Mode::kScaled, T>
          <<<nb, kThreads, 0, st>>>(plan, x, alpha, out, partial, F, feat, n_chunks, add);
      break;
    case Mode::kAlpha:  // f32 only: the entries refuse bf16 in this mode
      if constexpr (std::is_same_v<T, float>) {
        csr_reduce_kernel<G, V, Mode::kAlpha, T>
            <<<nb, kThreads, 0, st>>>(plan, x, alpha, out, partial, F, feat, n_chunks, add);
      } else {
        return static_cast<int>(cudaErrorInvalidValue);
      }
      break;
    default:
      csr_reduce_kernel<G, V, Mode::kPositional, T>
          <<<nb, kThreads, 0, st>>>(plan, x, alpha, out, partial, F, feat, n_chunks, add);
      break;
  }
  return static_cast<int>(cudaGetLastError());
}

// Both entries: the checks, then one launch.  `kAlign` is the alignment of a
// V = 4 lane's x and out rows (16 bytes for f32, 8 for bf16).
template <class T>
int reduce_entry(const CsrPlan* plan, const T* x, const float* alpha, T* out, float* partial,
                 int64_t F, int64_t feat, int mode, int lanes, int vec, int accumulate, int walk,
                 void* stream) {
  const auto bad = static_cast<int>(cudaErrorInvalidValue);
  if (F < 1 || feat < 1 || F % feat != 0 || mode < 0 || mode > 2) return bad;
  if (plan->n_split > 0 && partial == nullptr) return bad;
  if (vec == 4) {
    const auto misaligned = [](const void* p, uintptr_t a) {
      return reinterpret_cast<uintptr_t>(p) % a != 0;
    };
    constexpr uintptr_t kAlign = 4 * sizeof(T);
    if (F % 4 != 0 || misaligned(x, kAlign) || misaligned(out, kAlign) ||
        misaligned(partial, 16)) {
      return bad;
    }
    if (mode == static_cast<int>(Mode::kAlpha) && feat % 4 != 0) return bad;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int add = accumulate != 0;
  if (walk != 0) {  // the resident walk: f32, a gathering mode, float4 lanes of a segment group
    if constexpr (std::is_same_v<T, float>) {
      if (lanes == kWalkLanes && vec == 4) {
        return launch_walk(*plan, x, alpha, out, partial, F, feat, mode, add, st);
      }
    }
    return bad;
  }
#define GODE_LAUNCH(G_, V_) \
  return launch<G_, V_, T>(*plan, x, alpha, out, partial, F, feat, mode, add, st)
  if (vec == 4) {
    switch (lanes) {
      case 8: GODE_LAUNCH(8, 4);
      case 16: GODE_LAUNCH(16, 4);
      case 32: GODE_LAUNCH(32, 4);
      default: return bad;
    }
  }
  if (vec != 1) return bad;
  switch (lanes) {
    case 1: GODE_LAUNCH(1, 1);
    case 2: GODE_LAUNCH(2, 1);
    case 4: GODE_LAUNCH(4, 1);
    case 8: GODE_LAUNCH(8, 1);
    case 16: GODE_LAUNCH(16, 1);
    case 32: GODE_LAUNCH(32, 1);
    default: return bad;
  }
#undef GODE_LAUNCH
}

// Most heads the per-edge dot takes: its shared buffer is 32 edges x heads
// floats per warp (32 KB a block at 32 heads).
constexpr int64_t kMaxDotHeads = 32;

// Where one lane's V features of feature chunk c lie among the heads: its
// first feature f (live: f < W), its head h, the first lane j0 of the head
// in the chunk (within the edge slot), whether it is the head's last lane
// in the chunk (its scan holds the chunk's sum of the head) and whether the
// head starts in the chunk (the sum is written, not added).  feat % V == 0,
// so a lane's features are in one head.
struct DotLane {
  int64_t f;
  int h, j0;
  bool live, end, first;
};

template <int G, int V>
__device__ __forceinline__ DotLane dot_lane(int64_t c, int j, int64_t W, int64_t feat) {
  constexpr int64_t kWidth = G * V;
  const int64_t base = c * kWidth;
  DotLane d;
  d.f = base + static_cast<int64_t>(j) * V;
  d.live = d.f < W;
  if (!d.live) {
    d.h = 0, d.j0 = j, d.end = d.first = false;
    return d;
  }
  const int64_t h = d.f / feat, lo = h * feat, hi = lo + feat;
  d.h = static_cast<int>(h);
  d.first = lo >= base;
  d.j0 = d.first ? static_cast<int>((lo - base) / V) : 0;
  d.end = d.f == (hi < base + kWidth ? hi : base + kWidth) - V;
  return d;
}

// Segmented inclusive scan over the G lanes of an edge slot: lane j ends with
// the sum of lanes j0 .. j, in a fixed order.
template <int G>
__device__ __forceinline__ float head_scan(float v, int j, int j0) {
#pragma unroll
  for (int off = 1; off < G; off <<= 1) {
    const float t = __shfl_up_sync(kFullMask, v, off, G);
    if (j - off >= j0) v += t;
  }
  return v;
}

// Grid: one warp per segment of the view.  Per batch of 32 of the segment's
// edges (lane e loads edge e's column) and per feature chunk (G*V features),
// edge slot `sub` takes edges e0 + u * kSlots + sub.
template <int G, int V>
__global__ void __launch_bounds__(kThreads)
edge_dot_kernel(const CsrPlan plan, const float* __restrict__ x, const float* __restrict__ g,
                float* __restrict__ out, int64_t W, int64_t feat, int64_t heads,
                int64_t n_chunks) {
  extern __shared__ float dot_buf[];  // [warps of the block][32 edges * heads]
  constexpr int kSlots = 32 / G;
  constexpr int kUnroll = kSlots <= 8 ? 4 : 32 / kSlots;  // kSlots * kUnroll divides 32
  const int64_t s = (static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x) >> 5;
  if (s >= plan.n_seg) return;  // uniform across the warp
  const int lane = threadIdx.x & 31;
  const int sub = lane / G;
  const int j = lane % G;
  float* buf = dot_buf + (threadIdx.x >> 5) * 32 * heads;
  const int64_t p0 = plan.seg_ptr[s], p1 = plan.seg_ptr[s + 1];
  const float* grow = g + static_cast<int64_t>(plan.seg_row[s]) * W;
  for (int64_t pb = p0; pb < p1; pb += 32) {
    const int n = static_cast<int>(p1 - pb < 32 ? p1 - pb : 32);
    const int c_mine = lane < n ? __ldg(plan.col + pb + lane) : 0;
    for (int64_t chunk = 0; chunk < n_chunks; ++chunk) {
      const DotLane d = dot_lane<G, V>(chunk, j, W, feat);
      const Lane<V> gv = d.live ? Lane<V>::ldg(grow + d.f) : Lane<V>::zero();
      for (int e0 = 0; e0 < n; e0 += kSlots * kUnroll) {
        Lane<V> xv[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {  // every gather of the group in flight
          const int e = e0 + u * kSlots + sub;  // < 32
          const int64_t c = __shfl_sync(kFullMask, c_mine, e);
          xv[u] = e < n && d.live ? Lane<V>::ldg(x + c * W + d.f) : Lane<V>::zero();
        }
        float v[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) v[u] = head_scan<G>(xv[u].dot(gv), j, d.j0);
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int e = e0 + u * kSlots + sub;
          if (d.end && e < n) {
            float* dst = buf + e * heads + d.h;
            *dst = d.first ? v[u] : *dst + v[u];
          }
        }
        __syncwarp();  // a later chunk's sums add to these
      }
    }
    // The batch's [n, heads] results, one coalesced store.
    for (int q = lane; q < n * heads; q += 32) out[pb * heads + q] = buf[q];
    __syncwarp();  // the next batch writes the buffer again
  }
}

template <int G, int V>
int launch_dot(const CsrPlan& plan, const float* x, const float* g, float* out, int64_t heads,
               int64_t feat, cudaStream_t st) {
  const int64_t W = heads * feat;
  const int64_t n_chunks = (W + G * V - 1) / (G * V);
  const int64_t blocks = (plan.n_seg + kWarpsPerBlock - 1) / kWarpsPerBlock;
  if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  if (blocks == 0) return 0;
  const size_t smem = static_cast<size_t>(kWarpsPerBlock) * 32 * heads * sizeof(float);
  edge_dot_kernel<G, V><<<static_cast<unsigned>(blocks), kThreads, smem, st>>>(
      plan, x, g, out, W, feat, heads, n_chunks);
  return static_cast<int>(cudaGetLastError());
}

constexpr int kPassThreads = 256;

// Grid-stride over the E * width units of out: unit c of out row p is unit c
// of table row idx[p].  U is the unit (a 16-byte vector or one element), I
// the index type; ld is the table's row stride in units.
template <class U, class I>
__global__ void __launch_bounds__(kPassThreads)
gather_rows_kernel(const U* __restrict__ table, const I* __restrict__ idx, U* __restrict__ out,
                   int64_t n_table, int64_t ld, int64_t width, int64_t n) {
  const int64_t step = static_cast<int64_t>(gridDim.x) * kPassThreads;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * kPassThreads + threadIdx.x; i < n;
       i += step) {
    const int64_t p = width == 1 ? i : i / width;
    const int64_t j = static_cast<int64_t>(__ldg(idx + p));
    assert(j >= 0 && j < n_table);
    out[i] = __ldg(table + j * ld + (i - p * width));
  }
}

// Packed rows: Row is one whole row of 2, 4 or 8 bytes (a contiguous table),
// and thread t writes rows t·R .. t·R + R - 1 (R = 16 / sizeof(Row)) as one
// 16-byte store; the last, partial vector row by row.
template <class Row, class I>
__global__ void __launch_bounds__(kPassThreads)
gather_packed_kernel(const Row* __restrict__ table, const I* __restrict__ idx,
                     Row* __restrict__ out, int64_t n_table, int64_t n_idx) {
  constexpr int R = 16 / sizeof(Row);
  const int64_t n_vec = (n_idx + R - 1) / R;
  const int64_t step = static_cast<int64_t>(gridDim.x) * kPassThreads;
  for (int64_t t = static_cast<int64_t>(blockIdx.x) * kPassThreads + threadIdx.x; t < n_vec;
       t += step) {
    const int64_t p0 = t * R;
    if (p0 + R <= n_idx) {
      int64_t j[R];
#pragma unroll
      for (int k = 0; k < R; ++k) j[k] = static_cast<int64_t>(__ldg(idx + p0 + k));
      union {
        uint4 v;
        Row r[R];
      } u;
#pragma unroll
      for (int k = 0; k < R; ++k) {
        assert(j[k] >= 0 && j[k] < n_table);
        u.r[k] = __ldg(table + j[k]);
      }
      reinterpret_cast<uint4*>(out)[t] = u.v;
    } else {
      for (int64_t p = p0; p < n_idx; ++p) {
        const int64_t jp = static_cast<int64_t>(__ldg(idx + p));
        assert(jp >= 0 && jp < n_table);
        out[p] = __ldg(table + jp);
      }
    }
  }
}

inline unsigned gather_blocks(int64_t threads) {
  const int64_t want = (threads + kPassThreads - 1) / kPassThreads;
  return static_cast<unsigned>(want < (1 << 20) ? want : (1 << 20));
}

template <class U, class I>
int launch_gather(const void* table, const void* idx, void* out, int64_t n_table, int64_t ld,
                  int64_t width, int64_t n, cudaStream_t st) {
  gather_rows_kernel<U, I><<<gather_blocks(n), kPassThreads, 0, st>>>(
      static_cast<const U*>(table), static_cast<const I*>(idx), static_cast<U*>(out), n_table, ld,
      width, n);
  return static_cast<int>(cudaGetLastError());
}

template <class Row, class I>
int launch_packed(const void* table, const void* idx, void* out, int64_t n_table, int64_t n_idx,
                  cudaStream_t st) {
  constexpr int R = 16 / sizeof(Row);
  gather_packed_kernel<Row, I><<<gather_blocks((n_idx + R - 1) / R), kPassThreads, 0, st>>>(
      static_cast<const Row*>(table), static_cast<const I*>(idx), static_cast<Row*>(out), n_table,
      n_idx);
  return static_cast<int>(cudaGetLastError());
}

// An int that orders as the float does: a non-negative float's bits, a
// negative one's bits with the magnitude flipped (so -0 < +0), NaN above all.
__device__ __forceinline__ int order_key(float v) {
  const int b = __float_as_int(v);
  return v != v ? INT_MAX : b >= 0 ? b : b ^ 0x7fffffff;
}
__device__ __forceinline__ unsigned int key_bits(int k) {
  return static_cast<unsigned int>(k >= 0 ? k : k ^ 0x7fffffff);
}

__device__ __forceinline__ float load_value(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load_value(const __nv_bfloat16* p) {
  return gode::bf16_lo(__ldg(reinterpret_cast<const unsigned short*>(p)));
}

// out = max(out, the float of `key`).  Non-negative floats order as ints,
// negative ones in reverse as unsigneds, and either order puts every
// non-negative float above every negative one.
__device__ __forceinline__ void max_into(float* out, int key) {
  if (key >= 0) {
    atomicMax(reinterpret_cast<int*>(out), key);
  } else {
    atomicMin(reinterpret_cast<unsigned int*>(out), key_bits(key));
  }
}

// bf16: a CAS on the aligned 32-bit word that holds out (the wrapper pads the
// buffer to whole words).  The key came from a bf16, so its float's low 16
// bits are 0.  A stale first read is older, hence no larger: it can only cost
// a CAS, never skip one.
__device__ __forceinline__ void max_into(__nv_bfloat16* out, int key) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(out);
  unsigned int* word = reinterpret_cast<unsigned int*>(a & ~static_cast<uintptr_t>(3));
  const int shift = (a & 2) ? 16 : 0;
  const unsigned int mine = (key_bits(key) >> 16) << shift;
  unsigned int old = *word;
  while (order_key(__uint_as_float(((old >> shift) & 0xffffu) << 16)) < key) {
    const unsigned int seen = atomicCAS(word, old, (old & ~(0xffffu << shift)) | mine);
    if (seen == old) return;
    old = seen;
  }
}

// One thread per value i of e (edge p = i / H, head i % H).  Lane l + H holds
// the same head of the next edge, so a reverse shuffle scan at strides H, 2H,
// 4H, ... folds the lanes of one head and one run of equal rows into the
// run's first lane (lane l takes lane l + H·2^k's value where that lane holds
// l's row: within a run, lane l ends with every value of the run, and perhaps
// other values of the same row, which a max may take twice), then one atomic
// a run.  At H >= 32 every lane is its own run.
// kH: H at compile time (1, 2, 4, 8: the edge of value i is a shift away), or
// 0 for H as given.
template <class T, class I, int kH>
__global__ void __launch_bounds__(kPassThreads)
segment_max_kernel(const T* __restrict__ e, const I* __restrict__ rows, T* __restrict__ out,
                   int64_t n, int64_t n_heads, int64_t n_rows) {
  const int64_t heads = kH ? kH : n_heads;
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kPassThreads + threadIdx.x;
  const int lane = threadIdx.x & 31;
  const bool live = i < n;
  const int64_t p = heads == 1 ? i : i / heads;
  const int64_t r = live ? static_cast<int64_t>(__ldg(rows + p)) : -1;
  assert(!live || (r >= 0 && r < n_rows));
  const int stride = heads < 32 ? static_cast<int>(heads) : 32;  // uniform across the warp
  const int64_t up = stride < 32 ? __shfl_up_sync(kFullMask, r, stride) : r;
  const bool first = live && (lane < stride || up != r);
  unsigned int same = 0;  // bit k: lane + stride·2^k is in the warp and holds this lane's row
#pragma unroll
  for (int k = 0; k < 5; ++k) {
    const int d = stride << k;
    if (d >= 32) break;
    const int64_t down = __shfl_down_sync(kFullMask, r, d);
    if (live && lane + d < 32 && down == r) same |= 1u << k;
  }
  int key = live ? order_key(load_value(e + i)) : INT_MIN;
#pragma unroll
  for (int k = 0; k < 5; ++k) {
    const int d = stride << k;
    if (d >= 32) break;
    const int other = __shfl_down_sync(kFullMask, key, d);
    if ((same >> k) & 1u) key = other > key ? other : key;
  }
  if (first) max_into(out + r * heads + (i - p * heads), key);
}

template <class T, class I>
int launch_max(const void* e, const void* rows, void* out, int64_t n_edge, int64_t heads,
               int64_t n_rows, cudaStream_t st) {
  const int64_t n = n_edge * heads;
  const int64_t blocks = (n + kPassThreads - 1) / kPassThreads;
  if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  const auto* ev = static_cast<const T*>(e);
  const auto* rv = static_cast<const I*>(rows);
  auto* ov = static_cast<T*>(out);
  const unsigned nb = static_cast<unsigned>(blocks);
#define GODE_MAX_H(H_) \
  segment_max_kernel<T, I, H_><<<nb, kPassThreads, 0, st>>>(ev, rv, ov, n, heads, n_rows)
  switch (heads) {
    case 1: GODE_MAX_H(1); break;
    case 2: GODE_MAX_H(2); break;
    case 4: GODE_MAX_H(4); break;
    case 8: GODE_MAX_H(8); break;
    default: GODE_MAX_H(0);
  }
#undef GODE_MAX_H
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// One launch: out (+)= A x over the view of `plan` (see the header).  `mode`:
// 0 scaled by the plan's weights, 1 weighted by alpha [L, F / feat] (feat
// divides F), 2 positional (x is the view's [>= L, F] message array).
// `lanes` (G, a power of two <= 32) and `vec` (V, 1 or 4) shape a warp item;
// V = 4 needs F % 4 == 0, G >= 8, x and out 16-byte aligned and, weighted,
// feat % 4 == 0.  `accumulate` nonzero adds into out; zero writes every row
// of out (the plan's empty rows with zeros) and reads none.  `partial` holds
// one row of F floats per slot of the split rows and may be null when the
// plan has none; the plan's arrival counters must cover n_split times the
// number of chunks.  `walk` nonzero takes the resident walk (modes 0 and 1,
// `lanes` 8 and `vec` 4: chunks of 32 features, F a multiple of 32), which
// gives the bits of G = 32, V = 4.  Launches on `stream`, does not
// synchronise, and returns cudaGetLastError() after the launch (0 on success).
extern "C" int gode_csr_reduce_f32(const CsrPlan* plan, const float* x, const float* alpha,
                                   float* out, float* partial, int64_t F, int64_t feat, int mode,
                                   int lanes, int vec, int accumulate, int walk, void* stream) {
  return reduce_entry<float>(plan, x, alpha, out, partial, F, feat, mode, lanes, vec, accumulate,
                             walk, stream);
}

// The same launch on bf16 x and out (modes 0 and 2; mode 1 is refused):
// features widened to f32, summed in f32 (partial rows included), each
// output element rounded once.  V = 4 needs x and out 8-byte aligned.
extern "C" int gode_csr_reduce_bf16(const CsrPlan* plan, const __nv_bfloat16* x,
                                    __nv_bfloat16* out, float* partial, int64_t F, int mode,
                                    int lanes, int vec, int accumulate, void* stream) {
  if (mode == static_cast<int>(Mode::kAlpha)) return static_cast<int>(cudaErrorInvalidValue);
  return reduce_entry<__nv_bfloat16>(plan, x, nullptr, out, partial, F, 1, mode, lanes, vec,
                                     accumulate, 0, stream);
}

// One launch of the per-edge dot over the view of `plan` (see the header):
// out [L, heads] (row-major, L the view's edges) = per head, the dot of
// x[col[p]] and g[row of p] over feat features; x [>= max col + 1, heads *
// feat] and g [rows, heads * feat] f32, row-major.  `lanes` and `vec` as for
// gode_csr_reduce_f32 (V = 4 needs feat % 4 == 0, G >= 8 and x and g 16-byte
// aligned); 1 <= heads <= 32.  Launches on `stream`, does not synchronise,
// and returns cudaGetLastError() after the launch (0 on success; nothing is
// launched for a view without segments).
extern "C" int gode_edge_dot_f32(const CsrPlan* plan, const float* x, const float* g, float* out,
                                 int64_t heads, int64_t feat, int lanes, int vec, void* stream) {
  const auto bad = static_cast<int>(cudaErrorInvalidValue);
  if (heads < 1 || heads > kMaxDotHeads || feat < 1) return bad;
  if (vec == 4) {
    const auto misaligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 != 0; };
    if (feat % 4 != 0 || misaligned(x) || misaligned(g)) return bad;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define GODE_DOT(G_, V_) return launch_dot<G_, V_>(*plan, x, g, out, heads, feat, st)
  if (vec == 4) {
    switch (lanes) {
      case 8: GODE_DOT(8, 4);
      case 16: GODE_DOT(16, 4);
      case 32: GODE_DOT(32, 4);
      default: return bad;
    }
  }
  if (vec != 1) return bad;
  switch (lanes) {
    case 1: GODE_DOT(1, 1);
    case 2: GODE_DOT(2, 1);
    case 4: GODE_DOT(4, 1);
    case 8: GODE_DOT(8, 1);
    case 16: GODE_DOT(16, 1);
    case 32: GODE_DOT(32, 1);
    default: return bad;
  }
#undef GODE_DOT
}

// One launch of the narrow-row gather (see the header): out [n_idx, width]
// units = table[idx[p]] row by row, the table [n_table, >= width] units with
// row stride ld.  `unit` is the bytes of a unit: 16 (table and out 16-byte
// aligned), 4 or 2; or, `packed` nonzero, the bytes of a whole row (2, 4 or
// 8; width = ld = 1, table aligned to it, out 16-byte aligned).  `idx64`
// nonzero for int64 indices, else int32.  Launches on `stream`, does not
// synchronise, and returns cudaGetLastError() after the launch (0 on
// success; nothing is launched for an empty out).
extern "C" int gode_gather_rows(const void* table, const void* idx, void* out, int64_t n_table,
                                int64_t ld, int64_t width, int64_t n_idx, int unit, int packed,
                                int idx64, void* stream) {
  const auto bad = static_cast<int>(cudaErrorInvalidValue);
  const auto t = reinterpret_cast<uintptr_t>(table), o = reinterpret_cast<uintptr_t>(out);
  if (n_table < 0 || n_idx < 0 || width < 1 || ld < width) return bad;
  if ((unit == 16 || packed) && (o % 16 || t % unit)) return bad;
  if (packed && (width != 1 || ld != 1)) return bad;
  const int64_t n = n_idx * width;
  if (n == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define GODE_GATHER(U_)                                                                        \
  return idx64 ? launch_gather<U_, long long>(table, idx, out, n_table, ld, width, n, st)     \
               : launch_gather<U_, int>(table, idx, out, n_table, ld, width, n, st)
#define GODE_PACKED(R_)                                                                        \
  return idx64 ? launch_packed<R_, long long>(table, idx, out, n_table, n_idx, st)            \
               : launch_packed<R_, int>(table, idx, out, n_table, n_idx, st)
  if (packed) {
    switch (unit) {
      case 8: GODE_PACKED(uint2);
      case 4: GODE_PACKED(unsigned int);
      case 2: GODE_PACKED(unsigned short);
      default: return bad;
    }
  }
  switch (unit) {
    case 16: GODE_GATHER(uint4);
    case 4: GODE_GATHER(unsigned int);
    case 2: GODE_GATHER(unsigned short);
    default: return bad;
  }
#undef GODE_GATHER
#undef GODE_PACKED
}

// One launch of the per-receiver max (see the header): out [n_rows, heads]
// (filled by the caller; bf16: in a buffer of whole 32-bit words) = the max
// of out and, per row, its edges' rows of e [n_edge, heads], row-major, f32 or
// (`bf16` nonzero) bf16; rows [n_edge] int64 (`idx64` nonzero) or int32, in
// any order.  Launches on `stream`, does not synchronise, and returns
// cudaGetLastError() after the launch (0 on success; nothing is launched
// without edges).
extern "C" int gode_segment_max(const void* e, const void* rows, void* out, int64_t n_edge,
                                int64_t heads, int64_t n_rows, int bf16, int idx64,
                                void* stream) {
  if (n_edge < 0 || heads < 1 || n_rows < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (n_edge == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define GODE_MAX(T_)                                                                           \
  return idx64 ? launch_max<T_, long long>(e, rows, out, n_edge, heads, n_rows, st)           \
               : launch_max<T_, int>(e, rows, out, n_edge, heads, n_rows, st)
  if (bf16) GODE_MAX(__nv_bfloat16);
  GODE_MAX(float);
#undef GODE_MAX
}
