// CSR SpMM for Hopper (sm_90a): out[r, :] = sum_{p in row r} w[p] * x[col[p], :].
//
// Replaces: graph_odenet_tpu/ops/pallas_spmm.py::_sched_kernel, the CSR
// segment reduction that spmm_pallas runs forward over the receiver-sorted
// view and backward over the sender-sorted (CSC) view.  The TPU kernel left
// the gather x[senders] * w outside, materialised an [E, F] message array
// and reduced it with one-hot MXU matmuls.  Here gather, weight and
// reduction are one pass: no message array, no atomics, and each output
// row is written once.
//
// What bounds it on the card: the bytes of the gather.  Each edge reads one
// row of x (4*F bytes from a random row) plus 8 bytes of column and weight;
// there are 2 flops per gathered float, far below what the card could
// compute per byte.  What the design does about it:
//   * a warp owns a segment of at most SEG_EDGES edges of one row
//     (ops/csr_spmm.py::prepare cuts the rows).  Its lanes split into
//     32/G edge slots of G feature lanes, G the smallest power of two >= F
//     (at most 32).  So at F = 16 or F = 3 a warp still reads 32 useful
//     floats per step from 2 or 8 edges at once instead of idling lanes,
//     and neighbouring lanes read neighbouring floats of one x row;
//   * sums stay in f32 registers; the edge slots are added with warp
//     shuffles, so no shared memory and no atomics are needed;
//   * a hub row longer than one segment is spread over several warps,
//     which write partial rows to scratch; a second small kernel adds
//     them in segment order.  The result does not depend on scheduling.
// Weighted mode (alpha != null): lane f of edge p is scaled by
// alpha[p * (F / feat) + f / feat] instead of w[p].  It replaces the same
// kernel's alpha3d mode, which the GAT backward without the score hint
// (pallas_gat.py::_dwh_csc) runs over the CSC view.  The head index of a lane
// is fixed for a feature chunk, so the mode costs one more load per edge.
//
// Bucket mode (gode_csr_bucket_f32): out[r, :] (+)= sum_{p in row r} w[p] * x[col[p], :]
// over one bucket of the edge-partitioned graph.  It replaces
// pallas_spmm.py::_segment_reduce_kernel (B2), which parallel/halo.py runs per
// bucket of a receiver block: forward over the bucket's CSR view, backward over
// its CSC view.  The gathered table x is rectangular: a [B, F] feature chunk of
// the sender block, or, with col == null, the bucket's [E, F] message array
// itself (column = edge position, weight 1).  The bucket's segments skip rows
// without edges, so an empty row costs no warp.  Two forms:
//   * accumulate: the result is added into out, so a ring hop folds into the
//     running sum without a temporary: a whole row adds its sum, and a split
//     row adds its partial rows in the second pass; empty rows are untouched;
//   * write (the first bucket of a receiver block): out is written and never
//     read; a third small kernel writes zeros to the empty rows.
// Weighted bucket mode (alpha != null; B2-w): out[r, h*feat + f] (+)=
// sum_{p in row r} alpha[p * H + h] * x[col[p], h*feat + f], the same kernel's
// alpha3d mode that parallel/halo.py::_bucket_spmm_weighted runs per ring hop
// of the edge-partitioned GAT: alpha holds the per-edge, per-head softmax
// numerators in the view's edge order, forward over the bucket's CSR view and
// backward (numerators permuted) over its CSC view.  It is the kAlpha lane
// scaling above on the bucket's rectangular table, in both forms.  Bytes
// bound it as they bound the unweighted mode: the numerators add 4*H bytes
// per edge to the 4*H*feat of the gathered row.
#include <cstdint>
#include <cuda_runtime.h>

#include "segments.cuh"

namespace {

using gode::kThreads;
using gode::kWarpsPerBlock;

// kScaled: w[p] * x[col[p]].  kAlpha: alpha-scaled lanes.  kPositional: x[p].
// kAdd: a whole row's sum is added into out instead of written.
enum class Mode { kScaled, kAlpha, kPositional };

template <int G, Mode kMode, bool kAdd>
__global__ void __launch_bounds__(kThreads)
segment_reduce_kernel(const int64_t* __restrict__ seg_ptr,
                      const int32_t* __restrict__ seg_row,
                      const int32_t* __restrict__ seg_slot,
                      int64_t n_seg,
                      const int32_t* __restrict__ col,
                      const float* __restrict__ w,
                      const float* __restrict__ alpha,
                      const float* __restrict__ x,
                      float* __restrict__ out,
                      float* __restrict__ partial,
                      int64_t F,
                      int64_t feat) {
  constexpr int kSlots = 32 / G;
  const int64_t s = (static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x) >> 5;
  if (s >= n_seg) return;  // uniform across the warp
  const int lane = threadIdx.x & 31;
  const int sub = lane / G;
  const int fl = lane % G;
  const int64_t p0 = seg_ptr[s];
  const int64_t p1 = seg_ptr[s + 1];
  const int slot = seg_slot[s];
  float* dst = slot < 0 ? out + static_cast<int64_t>(seg_row[s]) * F
                        : partial + static_cast<int64_t>(slot) * F;
  for (int64_t f0 = 0; f0 < F; f0 += G) {
    const int64_t f = f0 + fl;
    float acc = 0.f;
    if (f < F) {
      if constexpr (kMode == Mode::kAlpha) {
        const int64_t heads = F / feat;
        const int64_t h = f / feat;
        for (int64_t p = p0 + sub; p < p1; p += kSlots) {
          const int64_t c = __ldg(col + p);
          acc = fmaf(__ldg(alpha + p * heads + h), __ldg(x + c * F + f), acc);
        }
      } else if constexpr (kMode == Mode::kPositional) {
        for (int64_t p = p0 + sub; p < p1; p += kSlots) {
          acc += __ldg(x + p * F + f);
        }
      } else {
        for (int64_t p = p0 + sub; p < p1; p += kSlots) {
          const int64_t c = __ldg(col + p);
          acc = fmaf(__ldg(w + p), __ldg(x + c * F + f), acc);
        }
      }
    }
#pragma unroll
    for (int off = 16; off >= G; off >>= 1) {
      acc += __shfl_xor_sync(gode::kFullMask, acc, off);
    }
    if (sub == 0 && f < F) {
      // A split row's partial rows are written; the second pass adds them.
      dst[f] = (kAdd && slot < 0) ? dst[f] + acc : acc;
    }
  }
}

// out[empty_row[j], :] = 0.
__global__ void __launch_bounds__(kThreads)
zero_rows_kernel(const int32_t* __restrict__ empty_row, int64_t n_empty,
                 float* __restrict__ out, int64_t F) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= n_empty * F) return;
  const int64_t j = i / F;
  out[static_cast<int64_t>(empty_row[j]) * F + (i - j * F)] = 0.f;
}

template <Mode kMode, bool kAdd>
int launch(const int64_t* seg_ptr, const int32_t* seg_row, const int32_t* seg_slot,
           int64_t n_seg, const int32_t* split_row, const int32_t* split_ptr, int64_t n_split,
           const int32_t* col, const float* w, const float* alpha, const float* x, float* out,
           float* partial, int64_t F, int64_t feat, cudaStream_t st,
           const int32_t* empty_row = nullptr, int64_t n_empty = 0) {
  const int64_t max_blocks = 0x7fffffff;
  if (n_seg > 0) {
    const int64_t blocks = (n_seg + kWarpsPerBlock - 1) / kWarpsPerBlock;
    if (blocks > max_blocks) return static_cast<int>(cudaErrorInvalidValue);
#define GODE_SEGMENTS(G)                                                                      \
  segment_reduce_kernel<G, kMode, kAdd><<<static_cast<unsigned>(blocks), kThreads, 0, st>>>( \
      seg_ptr, seg_row, seg_slot, n_seg, col, w, alpha, x, out, partial, F, feat)
    switch (gode::lanes_for(F)) {
      case 1: GODE_SEGMENTS(1); break;
      case 2: GODE_SEGMENTS(2); break;
      case 4: GODE_SEGMENTS(4); break;
      case 8: GODE_SEGMENTS(8); break;
      case 16: GODE_SEGMENTS(16); break;
      default: GODE_SEGMENTS(32); break;
    }
#undef GODE_SEGMENTS
  }
  if (n_split > 0) {
    const int64_t blocks = (n_split * F + kThreads - 1) / kThreads;
    if (blocks > max_blocks) return static_cast<int>(cudaErrorInvalidValue);
    gode::split_rows_kernel<kAdd><<<static_cast<unsigned>(blocks), kThreads, 0, st>>>(
        split_row, split_ptr, n_split, partial, out, F);
  }
  if (!kAdd && n_empty > 0) {
    const int64_t blocks = (n_empty * F + kThreads - 1) / kThreads;
    if (blocks > max_blocks) return static_cast<int>(cudaErrorInvalidValue);
    zero_rows_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, st>>>(empty_row, n_empty,
                                                                          out, F);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Returns cudaGetLastError() after the launches (0 on success).  Launches on
// `stream` and does not synchronise.  `partial` holds one row of F floats per
// slot of the split rows and may be null when n_split is 0.  `alpha` null
// selects the unweighted mode (w); otherwise the weighted mode, with heads of
// `feat` lanes (feat divides F).
extern "C" int gode_csr_spmm_f32(const int64_t* seg_ptr, const int32_t* seg_row,
                                 const int32_t* seg_slot, int64_t n_seg,
                                 const int32_t* split_row, const int32_t* split_ptr,
                                 int64_t n_split, const int32_t* col, const float* w,
                                 const float* alpha, const float* x, float* out,
                                 float* partial, int64_t F, int64_t feat, void* stream) {
  if (F < 1 || feat < 1 || F % feat != 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (alpha != nullptr) {
    return launch<Mode::kAlpha, false>(seg_ptr, seg_row, seg_slot, n_seg, split_row,
                                       split_ptr, n_split, col, w, alpha, x, out, partial, F,
                                       feat, st);
  }
  return launch<Mode::kScaled, false>(seg_ptr, seg_row, seg_slot, n_seg, split_row,
                                      split_ptr, n_split, col, w, alpha, x, out, partial, F,
                                      feat, st);
}

// Bucket mode (see the header).  `alpha` given selects the weighted form
// (heads of `feat` lanes, feat divides F; `col` given, `w` unused).  Else
// `col` and `w` both null selects the positional form (x is the [E, F]
// message array); otherwise both are given.  `accumulate` nonzero adds into
// out; zero writes out, and `empty_row` lists the n_empty rows that have no
// segment, which are written with zeros.  Same return and stream contract as
// above.
extern "C" int gode_csr_bucket_f32(const int64_t* seg_ptr, const int32_t* seg_row,
                                   const int32_t* seg_slot, int64_t n_seg,
                                   const int32_t* split_row, const int32_t* split_ptr,
                                   int64_t n_split, const int32_t* empty_row, int64_t n_empty,
                                   const int32_t* col, const float* w, const float* alpha,
                                   const float* x, float* out, float* partial, int64_t F,
                                   int64_t feat, int accumulate, void* stream) {
  if (F < 1 || feat < 1 || F % feat != 0) return static_cast<int>(cudaErrorInvalidValue);
  if (alpha != nullptr ? col == nullptr : (col == nullptr) != (w == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define GODE_BUCKET(MODE, ADD)                                                            \
  return launch<MODE, ADD>(seg_ptr, seg_row, seg_slot, n_seg, split_row, split_ptr, n_split, \
                           col, w, alpha, x, out, partial, F, feat, st, empty_row, n_empty)
  if (alpha != nullptr) {
    if (accumulate) GODE_BUCKET(Mode::kAlpha, true);
    GODE_BUCKET(Mode::kAlpha, false);
  }
  if (col == nullptr) {
    if (accumulate) GODE_BUCKET(Mode::kPositional, true);
    GODE_BUCKET(Mode::kPositional, false);
  }
  if (accumulate) GODE_BUCKET(Mode::kScaled, true);
  GODE_BUCKET(Mode::kScaled, false);
#undef GODE_BUCKET
}
