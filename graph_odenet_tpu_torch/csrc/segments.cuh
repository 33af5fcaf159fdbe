// Warp-segment helpers shared by the CSR kernels of this directory.
//
// ops/csr_spmm.py::prepare cuts every row of a CSR (or CSC) view into warp
// segments of at most SEG_EDGES edges.  A row cut into several segments is a
// split row: each of its segments writes a partial row to scratch.  In the
// GAT kernels (gat_attn.cu) split_rows_kernel, a second launch, adds the
// partial rows in segment order; the CSR kernel (csr_spmm.cu) adds them in
// its own grid, by the last warp of the row to arrive.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace gode {

constexpr int kWarpsPerBlock = 8;
constexpr int kThreads = kWarpsPerBlock * 32;
constexpr unsigned kFullMask = 0xffffffffu;

// Lanes of one edge slot: the smallest power of two >= F, at most 32.
inline int lanes_for(int64_t F) {
  return F >= 32 ? 32 : F > 8 ? 16 : F > 4 ? 8 : F > 2 ? 4 : F > 1 ? 2 : 1;
}

namespace {

// out[split_row[j], f] = sum of partial[k, f] over k in [split_ptr[j], split_ptr[j+1]),
// or, with kAccumulate, out[split_row[j], f] += that sum.
template <bool kAccumulate>
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
  float* dst = out + static_cast<int64_t>(split_row[j]) * F + f;
  *dst = kAccumulate ? *dst + acc : acc;
}

}  // namespace
}  // namespace gode
