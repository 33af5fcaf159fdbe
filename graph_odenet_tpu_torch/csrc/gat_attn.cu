// Fused GAT attention for Hopper (sm_90a): forward, α/dlogit backward and
// recompute-α dWh.  f32 only; index math is 64-bit; nothing is atomic, so
// every result is deterministic.
//
// Replaces, in graph_odenet_tpu/ops/:
//   gat_fwd  pallas_gat.py::_gat_kernel / _gat_kernel_packed (B4): per
//            receiver and head an online softmax of the edge logits,
//            out = Σ α·D·Wh[s], and the softmax state m (max logit) and
//            l = Σ exp(logit − m) over every real edge, dropped ones
//            included (D scales numerators only).  Edgeless rows write
//            out = 0, m = 0, l = 0.
//   gat_bwd  pallas_gat.py::_gat_bwd_kernel (B5): per edge and head
//            α = exp(logit − m[r]) / l[r] and
//            dlogit = α·(D·⟨g[r], Wh[s]⟩ − β[r]), optionally α·D.
//   gat_dwh  pallas_spmm.py::_segment_reduce_recompute_kernel (B3): over the
//            CSC view, dWh[s] = Σ α·D·g[r], α recomputed from the node tables
//            as exp(min(LeakyReLU(s_src[s] + s_dst[r]) − m[r], 0)) / l[r].
// D is the dropout scale of dropmask.cuh: none, an explicit [E, H] array, or
// the counter hash regenerated in place.
//
// What bounds them on the card: the gathers.  Per edge, gat_fwd reads one
// Wh row (4·H·F bytes from a random sender) and H logits; gat_bwd reads the
// same Wh row and writes H dlogits; gat_dwh reads one g row of a random
// receiver plus 3·H floats of its node tables.  A few flops per gathered
// float, far below what the card computes per byte.  What the designs do:
//   * a warp owns a segment of at most SEG_EDGES edges of one row (cut by
//     ops/csr_spmm.py::prepare, the same partition as the SpMM kernel).  Its
//     lanes split into 32/G edge slots of G lanes; neighbouring lanes read
//     neighbouring floats of one gathered row;
//   * gat_fwd keeps the online-softmax state (m, l, acc) of each lane in
//     registers and merges the slots with shuffles.  A hub row longer than
//     one segment is spread over several warps, each writing a partial
//     (m, l, acc); a second kernel merges them, rescaling by exp(m_i − m);
//   * gat_bwd needs a dot product per head, so its lanes are laid out by
//     head: each head takes Fp lanes (F rounded up to a power of two, or to
//     a multiple of 32 above 32) and the dot is a shuffle reduction over
//     them.  Edges are independent, so warps take flat runs of edges and a
//     hub row is spread over as many warps as it needs;
//   * gat_dwh is the SpMM kernel over the CSC view with the weight
//     recomputed per lane; hub senders take the split-row pass.

#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>

#include "dropmask.cuh"
#include "segments.cuh"

namespace {

using gode::DropMask;
using gode::kFullMask;
using gode::kThreads;
using gode::kWarpsPerBlock;

// ---------------------------------------------------------------- gat_fwd

// One warp per CSR segment; lane fl of slot `sub` handles feature f of the
// flattened [H·F] row, head f / F.
template <int G>
__global__ void __launch_bounds__(kThreads)
gat_fwd_kernel(const int64_t* __restrict__ seg_ptr, const int32_t* __restrict__ seg_row,
               const int32_t* __restrict__ seg_slot, int64_t n_seg,
               const int32_t* __restrict__ senders, const float* __restrict__ logits,
               const float* __restrict__ wh, DropMask mask,
               float* __restrict__ out, float* __restrict__ m_out, float* __restrict__ l_out,
               float* __restrict__ p_acc, float* __restrict__ p_m, float* __restrict__ p_l,
               int64_t H, int64_t F) {
  constexpr int kSlots = 32 / G;
  const int64_t s = (static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x) >> 5;
  if (s >= n_seg) return;  // uniform across the warp
  const int lane = threadIdx.x & 31;
  const int sub = lane / G;
  const int fl = lane % G;
  const int64_t p0 = seg_ptr[s];
  const int64_t p1 = seg_ptr[s + 1];
  const int32_t row = seg_row[s];
  const int slot = seg_slot[s];
  const int64_t HF = H * F;
  for (int64_t f0 = 0; f0 < HF; f0 += G) {
    const int64_t f = f0 + fl;
    const bool live = f < HF;
    const int64_t h = live ? f / F : 0;
    float m = -INFINITY;
    float l = 0.f;
    float acc = 0.f;
    if (live) {
      for (int64_t p = p0 + sub; p < p1; p += kSlots) {
        const float x = __ldg(logits + p * H + h);
        const int32_t c = __ldg(senders + p);
        if (x > m) {  // rescale the running sums to the new max
          const float sc = expf(m - x);
          l *= sc;
          acc *= sc;
          m = x;
        }
        const float e = expf(x - m);
        l += e;
        acc = fmaf(e * mask.at(p, H, h, c, row), __ldg(wh + static_cast<int64_t>(c) * HF + f), acc);
      }
    }
    // Merge the edge slots: every lane ends with the state of all of them.
#pragma unroll
    for (int off = 16; off >= G; off >>= 1) {
      const float m2 = __shfl_xor_sync(kFullMask, m, off);
      const float l2 = __shfl_xor_sync(kFullMask, l, off);
      const float acc2 = __shfl_xor_sync(kFullMask, acc, off);
      const float mn = fmaxf(m, m2);
      const float a = m == -INFINITY ? 0.f : expf(m - mn);
      const float b = m2 == -INFINITY ? 0.f : expf(m2 - mn);
      l = l * a + l2 * b;
      acc = acc * a + acc2 * b;
      m = mn;
    }
    if (sub == 0 && live) {
      const bool head_lane = f % F == 0;
      if (slot < 0) {
        out[static_cast<int64_t>(row) * HF + f] = l > 0.f ? acc / l : 0.f;
        if (head_lane) {
          m_out[static_cast<int64_t>(row) * H + h] = l > 0.f ? m : 0.f;
          l_out[static_cast<int64_t>(row) * H + h] = l;
        }
      } else {
        p_acc[static_cast<int64_t>(slot) * HF + f] = acc;
        if (head_lane) {
          p_m[static_cast<int64_t>(slot) * H + h] = m;
          p_l[static_cast<int64_t>(slot) * H + h] = l;
        }
      }
    }
  }
}

// Merge the partial softmax states of the split rows, in segment order.
// Every segment of a split row holds edges, so every m_k is finite.
__global__ void __launch_bounds__(kThreads)
gat_fwd_split_kernel(const int32_t* __restrict__ split_row, const int32_t* __restrict__ split_ptr,
                     int64_t n_split, const float* __restrict__ p_acc,
                     const float* __restrict__ p_m, const float* __restrict__ p_l,
                     float* __restrict__ out, float* __restrict__ m_out,
                     float* __restrict__ l_out, int64_t H, int64_t F) {
  const int64_t HF = H * F;
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= n_split * HF) return;
  const int64_t j = i / HF;
  const int64_t f = i - j * HF;
  const int64_t h = f / F;
  const int64_t k0 = split_ptr[j];
  const int64_t k1 = split_ptr[j + 1];
  float m = -INFINITY;
  for (int64_t k = k0; k < k1; ++k) m = fmaxf(m, p_m[k * H + h]);
  float l = 0.f;
  float acc = 0.f;
  for (int64_t k = k0; k < k1; ++k) {
    const float sc = expf(p_m[k * H + h] - m);
    l = fmaf(p_l[k * H + h], sc, l);
    acc = fmaf(p_acc[k * HF + f], sc, acc);
  }
  const int64_t row = split_row[j];
  out[row * HF + f] = acc / l;
  if (f % F == 0) {
    m_out[row * H + h] = m;
    l_out[row * H + h] = l;
  }
}

// ---------------------------------------------------------------- gat_bwd

constexpr int kBwdRounds = 4;  // rounds of edge slots per warp

// Edges are independent here, so warps take flat runs of edges (kBwdRounds
// rounds of 32/G slots) in CSR order, not row segments: a hub row is spread
// over many warps.  Consecutive edges mostly share their receiver, so its
// g, m, l and β come from L1.  Virtual lane v = h·Fp + f (f < Fp); a pass
// covers G of them, n_pass passes cover H·Fp.  A head's lanes never straddle
// a pass (Fp divides G, or is a multiple of G = 32), so after the pass that
// ends a head, a shuffle over min(Fp, 32) lanes completes its dot product.
template <int G>
__global__ void __launch_bounds__(kThreads)
gat_bwd_kernel(int64_t n_edge, const int32_t* __restrict__ senders,
               const int32_t* __restrict__ receivers, const float* __restrict__ logits,
               const float* __restrict__ wh, const float* __restrict__ g,
               const float* __restrict__ m, const float* __restrict__ l,
               const float* __restrict__ beta, DropMask mask, float* __restrict__ dlogits,
               float* __restrict__ alpha_d, int64_t H, int64_t F, int64_t Fp, int64_t n_pass) {
  constexpr int kSlots = 32 / G;
  const int64_t warp = (static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x) >> 5;
  const int64_t p0 = warp * kBwdRounds * kSlots;
  if (p0 >= n_edge) return;  // uniform across the warp
  const int lane = threadIdx.x & 31;
  const int sub = lane / G;
  const int fl = lane % G;
  const int64_t HF = H * F;
  const int group = Fp < 32 ? static_cast<int>(Fp) : 32;  // lanes of one reduction
  // Every lane runs every round, so that all of them reach the shuffles.
  for (int round = 0; round < kBwdRounds; ++round) {
    const int64_t p = p0 + round * kSlots + sub;
    const bool edge = p < n_edge;
    const int32_t c = edge ? __ldg(senders + p) : 0;
    const int32_t r = edge ? __ldg(receivers + p) : 0;
    const float* wh_row = wh + static_cast<int64_t>(c) * HF;
    const float* g_row = g + static_cast<int64_t>(r) * HF;
    float dot = 0.f;
    for (int64_t k = 0; k < n_pass; ++k) {
      const int64_t v = k * G + fl;
      const int64_t h = v / Fp;
      const int64_t f = v - h * Fp;
      if (edge && h < H && f < F) {
        dot = fmaf(__ldg(g_row + h * F + f), __ldg(wh_row + h * F + f), dot);
      }
      if (((k + 1) * G) % Fp != 0) continue;  // the head goes on in the next pass
      for (int off = group / 2; off >= 1; off >>= 1) {
        dot += __shfl_xor_sync(kFullMask, dot, off);
      }
      if (edge && h < H && fl % group == 0) {
        const int64_t rh = static_cast<int64_t>(r) * H + h;
        const float a = expf(__ldg(logits + p * H + h) - __ldg(m + rh)) / __ldg(l + rh);
        const float d = mask.at(p, H, h, c, r);
        dlogits[p * H + h] = a * (d * dot - __ldg(beta + rh));
        if (alpha_d != nullptr) alpha_d[p * H + h] = a * d;
      }
      dot = 0.f;
    }
  }
}

// ---------------------------------------------------------------- gat_dwh

// One warp per CSC segment (the rows are senders); lanes as in gat_fwd.
template <int G>
__global__ void __launch_bounds__(kThreads)
gat_dwh_kernel(const int64_t* __restrict__ seg_ptr, const int32_t* __restrict__ seg_row,
               const int32_t* __restrict__ seg_slot, int64_t n_seg,
               const int32_t* __restrict__ receivers, const float* __restrict__ s_src,
               const float* __restrict__ s_dst, const float* __restrict__ m,
               const float* __restrict__ l, const float* __restrict__ g, float slope,
               DropMask mask, float* __restrict__ out, float* __restrict__ partial,
               int64_t H, int64_t F) {
  constexpr int kSlots = 32 / G;
  const int64_t s = (static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x) >> 5;
  if (s >= n_seg) return;  // uniform across the warp
  const int lane = threadIdx.x & 31;
  const int sub = lane / G;
  const int fl = lane % G;
  const int64_t p0 = seg_ptr[s];
  const int64_t p1 = seg_ptr[s + 1];
  const int32_t sender = seg_row[s];
  const int slot = seg_slot[s];
  const int64_t HF = H * F;
  float* dst = slot < 0 ? out + static_cast<int64_t>(sender) * HF
                        : partial + static_cast<int64_t>(slot) * HF;
  for (int64_t f0 = 0; f0 < HF; f0 += G) {
    const int64_t f = f0 + fl;
    float acc = 0.f;
    if (f < HF) {
      const int64_t h = f / F;
      const float src = __ldg(s_src + static_cast<int64_t>(sender) * H + h);
      for (int64_t p = p0 + sub; p < p1; p += kSlots) {
        const int32_t r = __ldg(receivers + p);
        const int64_t rh = static_cast<int64_t>(r) * H + h;
        float x = src + __ldg(s_dst + rh);
        x = x > 0.f ? x : x * slope;
        const float a = expf(fminf(x - __ldg(m + rh), 0.f)) / __ldg(l + rh);
        acc = fmaf(a * mask.at(p, H, h, sender, r), __ldg(g + static_cast<int64_t>(r) * HF + f), acc);
      }
    }
#pragma unroll
    for (int off = 16; off >= G; off >>= 1) {
      acc += __shfl_xor_sync(kFullMask, acc, off);
    }
    if (sub == 0 && f < HF) dst[f] = acc;
  }
}

int check_launch(int64_t blocks) {
  return blocks > 0x7fffffff ? static_cast<int>(cudaErrorInvalidValue) : 0;
}

DropMask make_mask(int mode, const float* dmask, uint32_t seed, uint32_t keep24, float inv_keep) {
  return DropMask{mode, dmask, seed, keep24, inv_keep};
}

}  // namespace

// Each entry point launches on `stream`, does not synchronise, and returns
// cudaGetLastError() after its launches (0 on success).  Tensors are
// contiguous f32 (int32 / int64 for the graph):
//   logits [E, H] and dlogits, alpha_d [E, H] in CSR order;
//   wh, g, out, dwh [N, H, F]; m, l, beta, s_src, s_dst [N, H];
//   dmask [E, H] in CSR order (mask_mode 1 only).
// p_acc [n_slots, H·F], p_m and p_l [n_slots, H] and `partial` are scratch
// for the split rows and may be null when n_split is 0.

extern "C" int gode_gat_fwd_f32(const int64_t* seg_ptr, const int32_t* seg_row,
                                const int32_t* seg_slot, int64_t n_seg,
                                const int32_t* split_row, const int32_t* split_ptr,
                                int64_t n_split, const int32_t* senders, const float* logits,
                                const float* wh, int mask_mode, const float* dmask,
                                uint32_t seed, uint32_t keep24, float inv_keep, float* out,
                                float* m, float* l, float* p_acc, float* p_m, float* p_l,
                                int64_t H, int64_t F, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (H < 1 || F < 1 || mask_mode < 0 || mask_mode > 2) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const DropMask mask = make_mask(mask_mode, dmask, seed, keep24, inv_keep);
  const int64_t HF = H * F;
  if (n_seg > 0) {
    const int64_t blocks = (n_seg + kWarpsPerBlock - 1) / kWarpsPerBlock;
    if (int rc = check_launch(blocks)) return rc;
    const unsigned nb = static_cast<unsigned>(blocks);
#define GODE_FWD(G_)                                                                     \
  gat_fwd_kernel<G_><<<nb, kThreads, 0, st>>>(seg_ptr, seg_row, seg_slot, n_seg, senders, \
                                               logits, wh, mask, out, m, l, p_acc, p_m,   \
                                               p_l, H, F)
    switch (gode::lanes_for(HF)) {
      case 1: GODE_FWD(1); break;
      case 2: GODE_FWD(2); break;
      case 4: GODE_FWD(4); break;
      case 8: GODE_FWD(8); break;
      case 16: GODE_FWD(16); break;
      default: GODE_FWD(32); break;
    }
#undef GODE_FWD
  }
  if (n_split > 0) {
    const int64_t blocks = (n_split * HF + kThreads - 1) / kThreads;
    if (int rc = check_launch(blocks)) return rc;
    gat_fwd_split_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, st>>>(
        split_row, split_ptr, n_split, p_acc, p_m, p_l, out, m, l, H, F);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int gode_gat_bwd_f32(int64_t n_edge, const int32_t* senders, const int32_t* receivers,
                                const float* logits, const float* wh, const float* g,
                                const float* m, const float* l, const float* beta,
                                int mask_mode, const float* dmask, uint32_t seed,
                                uint32_t keep24, float inv_keep, float* dlogits, float* alpha_d,
                                int64_t H, int64_t F, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (H < 1 || F < 1 || mask_mode < 0 || mask_mode > 2) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const DropMask mask = make_mask(mask_mode, dmask, seed, keep24, inv_keep);
  // Lanes per head: F rounded up to a power of two, or to a multiple of 32.
  const int64_t Fp = F > 32 ? (F + 31) / 32 * 32 : gode::lanes_for(F);
  const int64_t V = H * Fp;
  const int lanes = gode::lanes_for(V);
  const int64_t n_pass = (V + lanes - 1) / lanes;
  if (n_edge > 0) {
    const int64_t per_warp = static_cast<int64_t>(kBwdRounds) * (32 / lanes);
    const int64_t warps = (n_edge + per_warp - 1) / per_warp;
    const int64_t blocks = (warps + kWarpsPerBlock - 1) / kWarpsPerBlock;
    if (int rc = check_launch(blocks)) return rc;
    const unsigned nb = static_cast<unsigned>(blocks);
#define GODE_BWD(G_)                                                                       \
  gat_bwd_kernel<G_><<<nb, kThreads, 0, st>>>(n_edge, senders, receivers, logits, wh, g, m, \
                                               l, beta, mask, dlogits, alpha_d, H, F, Fp,   \
                                               n_pass)
    switch (lanes) {
      case 1: GODE_BWD(1); break;
      case 2: GODE_BWD(2); break;
      case 4: GODE_BWD(4); break;
      case 8: GODE_BWD(8); break;
      case 16: GODE_BWD(16); break;
      default: GODE_BWD(32); break;
    }
#undef GODE_BWD
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int gode_gat_dwh_f32(const int64_t* seg_ptr, const int32_t* seg_row,
                                const int32_t* seg_slot, int64_t n_seg,
                                const int32_t* split_row, const int32_t* split_ptr,
                                int64_t n_split, const int32_t* receivers, const float* s_src,
                                const float* s_dst, const float* m, const float* l,
                                const float* g, float slope, int mask_mode, uint32_t seed,
                                uint32_t keep24, float inv_keep, float* out, float* partial,
                                int64_t H, int64_t F, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  // The CSC walk regenerates the mask; an explicit CSR-order mask cannot be read here.
  if (H < 1 || F < 1 || (mask_mode != gode::kNone && mask_mode != gode::kHash)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const DropMask mask = make_mask(mask_mode, nullptr, seed, keep24, inv_keep);
  const int64_t HF = H * F;
  if (n_seg > 0) {
    const int64_t blocks = (n_seg + kWarpsPerBlock - 1) / kWarpsPerBlock;
    if (int rc = check_launch(blocks)) return rc;
    const unsigned nb = static_cast<unsigned>(blocks);
#define GODE_DWH(G_)                                                                        \
  gat_dwh_kernel<G_><<<nb, kThreads, 0, st>>>(seg_ptr, seg_row, seg_slot, n_seg, receivers, \
                                               s_src, s_dst, m, l, g, slope, mask, out,     \
                                               partial, H, F)
    switch (gode::lanes_for(HF)) {
      case 1: GODE_DWH(1); break;
      case 2: GODE_DWH(2); break;
      case 4: GODE_DWH(4); break;
      case 8: GODE_DWH(8); break;
      case 16: GODE_DWH(16); break;
      default: GODE_DWH(32); break;
    }
#undef GODE_DWH
  }
  if (n_split > 0) {
    const int64_t blocks = (n_split * HF + kThreads - 1) / kThreads;
    if (int rc = check_launch(blocks)) return rc;
    gode::split_rows_kernel<false><<<static_cast<unsigned>(blocks), kThreads, 0, st>>>(
        split_row, split_ptr, n_split, partial, out, HF);
  }
  return static_cast<int>(cudaGetLastError());
}
