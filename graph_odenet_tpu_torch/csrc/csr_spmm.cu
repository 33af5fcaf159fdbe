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
// Index math is 64-bit.  f32 only.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kThreads = kWarpsPerBlock * 32;

template <int G>
__global__ void __launch_bounds__(kThreads)
segment_reduce_kernel(const int64_t* __restrict__ seg_ptr,
                      const int32_t* __restrict__ seg_row,
                      const int32_t* __restrict__ seg_slot,
                      int64_t n_seg,
                      const int32_t* __restrict__ col,
                      const float* __restrict__ w,
                      const float* __restrict__ x,
                      float* __restrict__ out,
                      float* __restrict__ partial,
                      int64_t F) {
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
      for (int64_t p = p0 + sub; p < p1; p += kSlots) {
        const int64_t c = __ldg(col + p);
        acc = fmaf(__ldg(w + p), __ldg(x + c * F + f), acc);
      }
    }
#pragma unroll
    for (int off = 16; off >= G; off >>= 1) {
      acc += __shfl_xor_sync(0xffffffffu, acc, off);
    }
    if (sub == 0 && f < F) dst[f] = acc;
  }
}

// out[split_row[j], f] = sum of partial[k, f] over k in [split_ptr[j], split_ptr[j+1]).
__global__ void __launch_bounds__(kThreads)
split_rows_kernel(const int32_t* __restrict__ split_row,
                  const int32_t* __restrict__ split_ptr,
                  int64_t n_split,
                  const float* __restrict__ partial,
                  float* __restrict__ out,
                  int64_t F) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= n_split * F) return;
  const int64_t j = i / F;
  const int64_t f = i - j * F;
  float acc = 0.f;
  for (int64_t k = split_ptr[j]; k < split_ptr[j + 1]; ++k) {
    acc += partial[k * F + f];
  }
  out[static_cast<int64_t>(split_row[j]) * F + f] = acc;
}

template <int G>
void launch_segments(int64_t blocks, cudaStream_t stream, const int64_t* seg_ptr,
                     const int32_t* seg_row, const int32_t* seg_slot, int64_t n_seg,
                     const int32_t* col, const float* w, const float* x, float* out,
                     float* partial, int64_t F) {
  segment_reduce_kernel<G><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      seg_ptr, seg_row, seg_slot, n_seg, col, w, x, out, partial, F);
}

}  // namespace

// Returns cudaGetLastError() after the launches (0 on success).  Launches on
// `stream` and does not synchronise.  `partial` holds one row of F floats per
// slot of the split rows and may be null when n_split is 0.
extern "C" int gode_csr_spmm_f32(const int64_t* seg_ptr, const int32_t* seg_row,
                                 const int32_t* seg_slot, int64_t n_seg,
                                 const int32_t* split_row, const int32_t* split_ptr,
                                 int64_t n_split, const int32_t* col, const float* w,
                                 const float* x, float* out, float* partial, int64_t F,
                                 void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int64_t max_blocks = 0x7fffffff;
  if (F < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (n_seg > 0) {
    const int64_t blocks = (n_seg + kWarpsPerBlock - 1) / kWarpsPerBlock;
    if (blocks > max_blocks) return static_cast<int>(cudaErrorInvalidValue);
    const int g = F >= 32 ? 32 : F > 8 ? 16 : F > 4 ? 8 : F > 2 ? 4 : F > 1 ? 2 : 1;
    switch (g) {
      case 1: launch_segments<1>(blocks, st, seg_ptr, seg_row, seg_slot, n_seg, col, w, x, out, partial, F); break;
      case 2: launch_segments<2>(blocks, st, seg_ptr, seg_row, seg_slot, n_seg, col, w, x, out, partial, F); break;
      case 4: launch_segments<4>(blocks, st, seg_ptr, seg_row, seg_slot, n_seg, col, w, x, out, partial, F); break;
      case 8: launch_segments<8>(blocks, st, seg_ptr, seg_row, seg_slot, n_seg, col, w, x, out, partial, F); break;
      case 16: launch_segments<16>(blocks, st, seg_ptr, seg_row, seg_slot, n_seg, col, w, x, out, partial, F); break;
      default: launch_segments<32>(blocks, st, seg_ptr, seg_row, seg_slot, n_seg, col, w, x, out, partial, F); break;
    }
  }
  if (n_split > 0) {
    const int64_t blocks = (n_split * F + kThreads - 1) / kThreads;
    if (blocks > max_blocks) return static_cast<int>(cudaErrorInvalidValue);
    split_rows_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, st>>>(
        split_row, split_ptr, n_split, partial, out, F);
  }
  return static_cast<int>(cudaGetLastError());
}
