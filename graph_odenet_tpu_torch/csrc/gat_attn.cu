// Fused GAT attention for Hopper (sm_90a): forward, α/dlogit backward and
// recompute-α dWh.  f32, and gat_fwd and gat_bwd also on a bf16 Wh (below);
// index math is 64-bit where it indexes edges.
// Every sum is taken in a fixed order, so every result is deterministic.
//
// Replaces, in graph_odenet_tpu/ops/:
//   gat_fwd  pallas_gat.py::_gat_kernel / _gat_kernel_packed (B4): per
//            receiver and head the softmax of the edge logits,
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
// What bounds them on the card: bytes.  Per edge, gat_fwd reads one Wh row
// (4·H·F bytes from a random sender) and H logits; gat_bwd reads the same Wh
// row and writes H dlogits; gat_dwh reads one g row of a random receiver plus
// 3·H floats of its node tables.  About two flops per gathered float, from
// random rows: there is no matrix product for the tensor cores (wgmma) to
// take, and TMA copies rectangular tiles, not scattered rows, so neither is
// used.  What the designs do about the bytes:
//   * the host path: gat_fwd and gat_bwd take the receiver-sorted view's
//     LaunchPlan (segments.cuh::CsrPlan, built once per view by
//     ops/csr_spmm.py) by pointer, gat_dwh the sender-sorted (CSC) view's,
//     plus only what varies, and each call is one launch;
//   * a warp item is one warp segment (at most SEG_EDGES edges of one row;
//     ops/csr_spmm.py::prepare cuts the rows) times one feature chunk, the
//     chunk the grid's slowest axis, as in the CSR kernel.  Its lanes split
//     into 32/G edge slots of G lanes; at F % 4 == 0, H·F >= 32 and 16-byte
//     aligned rows a lane loads a float4 of one head (a 16-byte gather) and a
//     chunk holds up to 128 features; otherwise lanes are single floats;
//   * the softmax weight is computed once per (edge, head), not per feature
//     lane: per batch of up to 32 edges the warp loads their senders
//     (gat_fwd) or receivers (gat_dwh), coalesced, and the batch's (edge,
//     head) pairs compute exp and the dropout hash once each into a per-warp
//     tile of shared memory, from which every lane reads its head's weight
//     and its gathered row as a broadcast.  gat_fwd first passes over the
//     segment's logits alone for the max per head (a batch's by shuffles) and
//     the sum (rescaled once a batch), then gathers with the normalised
//     weight α·D; a segment of one batch (every row of up to 32 edges) keeps
//     its exps in the tile between the passes;
//   * four independent gathers of Wh (g in gat_dwh) in flight per lane,
//     added in edge order into one accumulator;
//   * gat_fwd: a hub row cut into several segments is merged in the same
//     grid.  Each segment writes its partial (out, m, l), its own softmax of
//     its edges, to the slot of its split row; after a __threadfence it counts its arrival on
//     the plan's counter of (split row, chunk); the last warp to arrive reads
//     the partial states through L2 in slot order, its lanes striding over
//     the slots, adds them weighted by l_k·exp(m_k − m) in a fixed shuffle
//     tree, writes the row and resets the counter to 0.  So the result does
//     not depend on scheduling, repeated calls are bit-equal, and the launch
//     can be captured in a CUDA graph;
//   * gat_bwd walks the same receiver segments: a warp loads its receiver's
//     g row (its lanes' float4s), m, l and β once per segment and keeps them
//     in registers, so per edge it gathers only Wh[s] and the logits.  Lanes
//     are laid out by head: each head takes Lh lanes (a power of two, at most
//     32; a lane adds several float4 of its head where the head is wider), a
//     head never spans warps, and the per-head dot is a shuffle tree over its
//     lanes.  Edges are independent, so a split row needs no merge.  Extra
//     warps of the same grid write zeros to the padding rows of dlogits;
//   * gat_dwh walks the CSC view's segments with gat_fwd's lanes and tile.
//     A segment's row is its sender, so its s_src is loaded once per warp
//     item; per batch the (edge, head) pairs gather the receiver's s_dst, m
//     and l and compute α·D once each, the dropout hash included, for all
//     the feature lanes of the chunk to read.  The first rows of g[r] are
//     loaded before the weights are computed (both wait only on the
//     receivers).  A hub sender's segments merge their partial rows by
//     the last warp to arrive (segments.cuh::merge_split_row, as the CSR
//     kernel does), so a call is one launch; an edgeless row's one empty
//     segment writes zeros, so every row is written.
// bfloat16 (gode_gat_fwd_bf16, gode_gat_bwd_bf16): the counterpart of JAX's
// kernels on a bf16 Wh, which upcast the gathered values and compute and
// return f32 (pallas_gat.py::_vals_edge_major, out_shape f32).  Only the Wh
// gathers change: a lane loads 4 bf16 (8 bytes) or 1 and widens them
// (segments.cuh::Lane), so the dominant bytes halve.  The logits, the
// per-warp weight tile, the dropout hash, g, m, l, β and every output (out,
// the partial states, dlogits) stay f32.  gat_dwh reads g and the score
// tables only, all f32, and has no bf16 form; its caller rounds dWh to Wh's
// dtype.

#include <cmath>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "dropmask.cuh"
#include "segments.cuh"

namespace {

using gode::DropMask;
using gode::kFullMask;
using gode::kThreads;
using gode::kWarpsPerBlock;
using gode::Lane;
using gode::merge_split_row;
using gode::sum_slots;

constexpr int kUnroll = 4;  // gathers in flight per lane

// Heads that the chunk [c·W, (c+1)·W) of an H·F row touches, and the first.
__host__ __device__ __forceinline__ int chunk_heads(int c, int W, int H, int F, int* first) {
  const int f0 = c * W;
  const int f1 = (f0 + W < H * F ? f0 + W : H * F) - 1;
  *first = f0 / F;
  return f1 / F - f0 / F + 1;
}

// ---------------------------------------------------------------- gat_fwd

// x[u] = row(j) for the j = j0 + u·32/G + l / G < n of this lane's edge slot.
template <int G, int V, class Row>
__device__ __forceinline__ void load_rows(Lane<V> (&x)[kUnroll], int j0, int n, int sub, bool live,
                                          Row row) {
  constexpr int kSlots = 32 / G;
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const int j = j0 + u * kSlots + sub;
    x[u] = live && j < n ? row(j) : Lane<V>::zero();
  }
}

// acc += tile[j·Hp + hf] · x[u] over the same j, in order.
template <int G, int V>
__device__ __forceinline__ void fma_rows(Lane<V>& acc, const Lane<V> (&x)[kUnroll],
                                         const float* tile, int Hp, int hf, int j0, int n, int sub,
                                         bool live) {
  constexpr int kSlots = 32 / G;
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const int j = j0 + u * kSlots + sub;
    if (live && j < n) acc.fma(tile[j * Hp + hf], x[u]);
  }
}

// acc += Σ tile[j·Hp + hf] · row(j) over the j < n of this lane's edge slot
// (j ≡ l / G mod 32/G), in order, four rows loaded at a time.
template <int G, int V, class Row>
__device__ __forceinline__ void add_weighted(Lane<V>& acc, const float* tile, int Hp, int hf,
                                             int n, int sub, bool live, Row row) {
  constexpr int kSlots = 32 / G;
  for (int j0 = 0; j0 < n; j0 += kSlots * kUnroll) {
    Lane<V> x[kUnroll];
    load_rows<G, V>(x, j0, n, sub, live, row);
    fma_rows<G, V>(acc, x, tile, Hp, hf, j0, n, sub, live);
  }
}

// A warp item is (segment s, chunk c): lane l covers the V features
// f = c·G·V + (l % G)·V of head f / F, for the edges of slot l / G.  The tile
// holds a batch's weights [32][Hp] (Hp: a power of two >= the chunk's heads)
// and its senders [32].  The (edge, head) pairs of a batch are taken as
// j = l / Hp + k·(32 / Hp), head l % Hp: every lane keeps the softmax state
// (m, l) of head l % Hp of the chunk, and a shuffle over offsets >= Hp
// reduces over the edges of one head.  Two passes over the segment:
//   1. its logits only: the max per head per batch and the sum l of
//      exp(logit − m), rescaled once a batch when the max grows;
//   2. the gather, each edge weighted by α·D = exp(logit − m) / l · D, the
//      same value gat_bwd computes, so out needs no division at the end.
// A segment of one batch (every row of at most 32 edges) keeps its exps in
// the tile from pass 1; a longer one reads its logits again and takes the
// exp again in pass 2.  Normalised weights make the rounding of each
// product depend on its row: with unnormalised ones the max edge weighs
// exactly D, so a sender that dominates many rows rounds its D·Wh the same
// way in each of them, and the backward's sums over that sender (its dWh)
// add those errors up instead of averaging them out.
template <int G, int V, class TW>
__global__ void __launch_bounds__(kThreads)
gat_fwd_kernel(const CsrPlan plan, const float* __restrict__ logits,
               const TW* __restrict__ wh, DropMask mask, float* __restrict__ out,
               float* __restrict__ m_out, float* __restrict__ l_out,
               float* __restrict__ p_acc, float* __restrict__ p_stat, int H, int F, int Hp,
               int n_chunks) {
  constexpr int kSlots = 32 / G;
  constexpr int kWidth = G * V;
  const int64_t item = (static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x) >> 5;
  if (item >= plan.n_seg * n_chunks) return;  // uniform across the warp
  const int lane = threadIdx.x & 31;
  extern __shared__ float4 gode_smem[];
  float* tile = reinterpret_cast<float*>(gode_smem) + (threadIdx.x >> 5) * 32 * (Hp + 1);
  int32_t* cols = reinterpret_cast<int32_t*>(tile + 32 * Hp);
  const int chunk = static_cast<int>(item / plan.n_seg);
  const int64_t s = item - static_cast<int64_t>(chunk) * plan.n_seg;
  const int HF = H * F;
  int h0;
  const int n_heads = chunk_heads(chunk, kWidth, H, F, &h0);
  const int sub = lane / G;
  const int f = chunk * kWidth + (lane % G) * V;
  const bool live = f < HF;  // F % V == 0: the lane's V features are in one head
  const int hf = live ? f / F - h0 : 0;  // the lane's head, within the chunk
  const int hs = lane % Hp;              // the head whose softmax state the lane keeps
  const bool hs_live = hs < n_heads;
  const int per = 32 / Hp;
  const int64_t p0 = plan.seg_ptr[s];
  const int64_t p1 = plan.seg_ptr[s + 1];
  const int32_t row = plan.seg_row[s];

  // Pass 1: max and sum per head, exp once per (edge, head).
  float m_run = -INFINITY;
  float l_run = 0.f;
  for (int64_t pb = p0; pb < p1; pb += 32) {
    const int n = static_cast<int>(p1 - pb < 32 ? p1 - pb : 32);
    float bmax = -INFINITY;
    for (int j = lane / Hp; hs_live && j < n; j += per) {
      const float x = __ldg(logits + (pb + j) * H + h0 + hs);
      tile[j * Hp + hs] = x;  // each lane reads back only its own pairs
      bmax = fmaxf(bmax, x);
    }
    for (int off = 16; off >= Hp; off >>= 1) {
      bmax = fmaxf(bmax, __shfl_xor_sync(kFullMask, bmax, off));
    }
    const float m_new = fmaxf(m_run, bmax);
    float lsum = 0.f;
    for (int j = lane / Hp; hs_live && j < n; j += per) {
      const float e = expf(tile[j * Hp + hs] - m_new);
      tile[j * Hp + hs] = e;
      lsum += e;
    }
    for (int off = 16; off >= Hp; off >>= 1) lsum += __shfl_xor_sync(kFullMask, lsum, off);
    l_run = m_run == -INFINITY ? lsum : fmaf(l_run, expf(m_run - m_new), lsum);
    m_run = m_new;
  }
  // Pass 2: the weights α·D, then the gather.  Four rows in flight per lane,
  // added in edge order into one accumulator.
  const bool one_batch = p1 - p0 <= 32;
  Lane<V> acc = Lane<V>::zero();
  for (int64_t pb = p0; pb < p1; pb += 32) {
    const int n = static_cast<int>(p1 - pb < 32 ? p1 - pb : 32);
    if (lane < n) cols[lane] = __ldg(plan.col + pb + lane);
    __syncwarp();  // the senders are in the tile
    for (int j = lane / Hp; hs_live && j < n; j += per) {
      const float e = one_batch ? tile[j * Hp + hs]
                                : expf(__ldg(logits + (pb + j) * H + h0 + hs) - m_run);
      tile[j * Hp + hs] = e / l_run * mask.at(pb + j, H, h0 + hs, cols[j], row);
    }
    __syncwarp();  // the weights are in the tile
    add_weighted<G, V>(acc, tile, Hp, hf, n, sub, live, [&](int e) {
      return Lane<V>::ldg(wh + static_cast<int64_t>(cols[e]) * HF + f);
    });
    __syncwarp();  // the next batch overwrites the tile
  }
  const Lane<V> sum = sum_slots<G, V>(acc);
  const float m_f = __shfl_sync(kFullMask, m_run, hf);
  const float l_f = __shfl_sync(kFullMask, l_run, hf);
  const bool first_of_head = live && f % F == 0;
  const int slot = plan.seg_slot[s];
  if (slot < 0) {  // a whole row; an edgeless one writes zeros
    if (sub == 0 && live) {
      sum.st(out + static_cast<int64_t>(row) * HF + f);
      if (first_of_head) {
        m_out[static_cast<int64_t>(row) * H + h0 + hf] = l_f > 0.f ? m_f : 0.f;
        l_out[static_cast<int64_t>(row) * H + h0 + hf] = l_f;
      }
    }
    return;
  }
  // A segment of a split row: its partial state (its own softmax of its
  // edges), then its arrival.  The state of slot k and chunk c: p_acc[k, f]
  // and p_stat[(k·n_chunks + c)·2Hp + {0, Hp} + head within the chunk].
  if (sub == 0 && live) sum.st(p_acc + static_cast<int64_t>(slot) * HF + f);
  const int64_t stat_stride = 2 * static_cast<int64_t>(Hp);
  if (lane < n_heads) {  // hs == lane
    float* st = p_stat + (static_cast<int64_t>(slot) * n_chunks + chunk) * stat_stride;
    st[lane] = m_run;
    st[Hp + lane] = l_run;
  }
  __threadfence();
  __syncwarp();
  const int j = plan.slot_split[slot];
  const int k0 = plan.split_ptr[j];
  const int k1 = plan.split_ptr[j + 1];
  int32_t* counter = plan.arrivals + static_cast<int64_t>(chunk) * plan.n_split + j;
  int before = 0;
  if (lane == 0) before = atomicAdd(counter, 1);
  before = __shfl_sync(kFullMask, before, 0);
  if (before != k1 - k0 - 1) return;  // not the last to arrive (uniform across the warp)
  // The last: every partial state of this split row and chunk is written.
  __threadfence();
  if (lane == 0) *counter = 0;  // the next call starts from zero
  // Every segment of a split row holds edges, so every m_k is finite.  The
  // (slot, head) pairs take the max per head, then the weights
  // c_k = l_k·exp(m_k − m) of 32 slots at a time into the tile (slot k's row
  // is its own softmax), and the lanes add the partial rows as in pass 2.
  const auto stat = [&](int k) {
    return p_stat + (static_cast<int64_t>(k) * n_chunks + chunk) * stat_stride;
  };
  float m = -INFINITY;
  for (int k = k0 + lane / Hp; hs_live && k < k1; k += per) m = fmaxf(m, __ldcg(stat(k) + hs));
  for (int off = 16; off >= Hp; off >>= 1) m = fmaxf(m, __shfl_xor_sync(kFullMask, m, off));
  float lsum = 0.f;
  Lane<V> merged = Lane<V>::zero();
  for (int kb = k0; kb < k1; kb += 32) {
    const int n = k1 - kb < 32 ? k1 - kb : 32;
    for (int i = lane / Hp; hs_live && i < n; i += per) {
      const float* st = stat(kb + i);
      const float c = __ldcg(st + Hp + hs) * expf(__ldcg(st + hs) - m);
      tile[i * Hp + hs] = c;
      lsum += c;
    }
    __syncwarp();  // the weights are in the tile
    add_weighted<G, V>(merged, tile, Hp, hf, n, sub, live, [&](int i) {
      return Lane<V>::ldcg(p_acc + static_cast<int64_t>(kb + i) * HF + f);
    });
    __syncwarp();  // the next slots overwrite the tile
  }
  for (int off = 16; off >= Hp; off >>= 1) lsum += __shfl_xor_sync(kFullMask, lsum, off);
  merged = sum_slots<G, V>(merged);
  const float m_r = __shfl_sync(kFullMask, m, hf);
  const float l_r = __shfl_sync(kFullMask, lsum, hf);
  if (sub == 0 && live) {
    const int64_t r = plan.split_row[j];
    merged.div(l_r);
    merged.st(out + r * HF + f);
    if (first_of_head) {
      m_out[r * H + h0 + hf] = m_r;
      l_out[r * H + h0 + hf] = l_r;
    }
  }
}

// ---------------------------------------------------------------- gat_bwd

constexpr int kZeroPerWarp = 1024;  // padding floats of dlogits one warp zeroes

// A warp item is (segment s, chunk c of Hk = Ge / Lh heads): lane l is lane
// q = l % Lh of head c·Hk + (l % Ge) / Lh for the edges of slot l / Ge, and
// covers the V features (q + k·Lh)·V of that head for k < K.  The tile holds
// a batch's α [32][Hk], its D [32][Hk] and its senders [32]; the (edge, head)
// pairs are j = l / Hk + k·(32 / Hk), head l % Hk of the chunk.  Then the
// warp items past n_seg·n_chunks: zeros for dlogits[E·H, n_rows·H).
template <int V, class TW>
__global__ void __launch_bounds__(kThreads)
gat_bwd_kernel(const CsrPlan plan, const float* __restrict__ logits,
               const TW* __restrict__ wh, const float* __restrict__ g,
               const float* __restrict__ m, const float* __restrict__ l,
               const float* __restrict__ beta, DropMask mask, float* __restrict__ dlogits,
               float* __restrict__ alpha_d, int H, int F, int Lh, int K, int Ge, int n_chunks,
               int64_t n_edge, int64_t n_rows) {
  const int64_t item = (static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  const int64_t n_items = plan.n_seg * n_chunks;
  if (item >= n_items) {  // zeros for the padding rows
    const int64_t i0 = n_edge * H + (item - n_items) * kZeroPerWarp;
    const int64_t i1 = i0 + kZeroPerWarp < n_rows * H ? i0 + kZeroPerWarp : n_rows * H;
    for (int64_t i = i0 + lane; i < i1; i += 32) dlogits[i] = 0.f;
    return;
  }
  const int chunk = static_cast<int>(item / plan.n_seg);
  const int64_t s = item - static_cast<int64_t>(chunk) * plan.n_seg;
  const int64_t p0 = plan.seg_ptr[s];
  const int64_t p1 = plan.seg_ptr[s + 1];
  if (p0 == p1) return;  // an edgeless row (uniform across the warp)
  const int Hk = Ge / Lh;
  const int slots = 32 / Ge;
  extern __shared__ float4 gode_smem[];
  float* ta = reinterpret_cast<float*>(gode_smem) + (threadIdx.x >> 5) * (64 * Hk + 32);
  float* td = ta + 32 * Hk;
  int32_t* cols = reinterpret_cast<int32_t*>(td + 32 * Hk);
  const int HF = H * F;
  const int Q = F / V;
  const int64_t r = plan.seg_row[s];
  // The lane's head (feature lanes) and its pair head (the batch's α and D).
  const int sub = lane / Ge;
  const int hc = (lane % Ge) / Lh;
  const int q = lane % Lh;
  const int h = chunk * Hk + hc;
  const bool live = h < H;
  const int hk = lane % Hk;
  const int hp = chunk * Hk + hk;
  const bool hp_live = hp < H;
  const float m_p = hp_live ? __ldg(m + r * H + hp) : 0.f;
  const float l_p = hp_live ? __ldg(l + r * H + hp) : 1.f;
  const float beta_h = live ? __ldg(beta + r * H + h) : 0.f;
  const float* g_row = g + r * HF + static_cast<int64_t>(h) * F;
  const Lane<V> g0 = live && q < Q ? Lane<V>::ldg(g_row + q * V) : Lane<V>::zero();
  const int per = 32 / Hk;
  for (int64_t pb = p0; pb < p1; pb += 32) {
    const int n = static_cast<int>(p1 - pb < 32 ? p1 - pb : 32);
    if (lane < n) cols[lane] = __ldg(plan.col + pb + lane);
    for (int j = lane / Hk; hp_live && j < n; j += per) {
      ta[j * Hk + hk] = __ldg(logits + (pb + j) * H + hp);  // read back by this lane only
    }
    __syncwarp();  // the senders are in the tile
    for (int j = lane / Hk; hp_live && j < n; j += per) {
      const int64_t p = pb + j;
      const float a = expf(ta[j * Hk + hk] - m_p) / l_p;
      const float d = mask.at(p, H, hp, cols[j], static_cast<int32_t>(r));
      ta[j * Hk + hk] = a;
      td[j * Hk + hk] = d;
      if (alpha_d != nullptr) alpha_d[p * H + hp] = a * d;
    }
    __syncwarp();  // α and D are in the tile
    for (int e0 = 0; e0 < n; e0 += slots * kUnroll) {
      float dot[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) dot[u] = 0.f;
      for (int k = 0; k < K; ++k) {
        const int qq = q + k * Lh;
        const bool on = live && qq < Q;
        const Lane<V> gk = k == 0 ? g0 : (on ? Lane<V>::ldg(g_row + qq * V) : Lane<V>::zero());
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int e = e0 + u * slots + sub;
          if (on && e < n) {
            dot[u] += gk.dot(Lane<V>::ldg(wh + static_cast<int64_t>(cols[e]) * HF +
                                          static_cast<int64_t>(h) * F + qq * V));
          }
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        for (int off = Lh / 2; off >= 1; off >>= 1) {
          dot[u] += __shfl_xor_sync(kFullMask, dot[u], off);
        }
        const int e = e0 + u * slots + sub;
        if (live && q == 0 && e < n) {
          const float a = ta[e * Hk + hc];
          dlogits[(pb + e) * H + h] = a * (td[e * Hk + hc] * dot[u] - beta_h);
        }
      }
    }
    __syncwarp();  // the next batch overwrites the tile
  }
}

// ---------------------------------------------------------------- gat_dwh

// A warp item is (CSC segment s, chunk c) with gat_fwd's lanes: lane l covers
// the V features f = c·G·V + (l % G)·V of head f / F for the edges of slot
// l / G.  The segment's row is its sender.  Per batch of up to 32 edges the
// tile holds the receivers [32] and the weights [32][Hp]: the (edge, head)
// pairs j = l / Hp + k·(32 / Hp), head l % Hp of the chunk, compute
//   α·D = exp(min(LeakyReLU(s_src[s] + s_dst[r]) − m[r], 0)) / l[r] · D
// once each (the TPU kernel's clamp, exact for real edges since m[r] is the
// receiver's max logit; D scales the numerator only), and the lanes gather
// their float4s of g[r] weighted by their head's.  Then the edge slots' sums are added; a split row's
// partial rows are merged by the last of its warps to arrive.
template <int G, int V>
__global__ void __launch_bounds__(kThreads)
gat_dwh_kernel(const CsrPlan plan, const float* __restrict__ s_src,
               const float* __restrict__ s_dst, const float* __restrict__ m,
               const float* __restrict__ l, const float* __restrict__ g, float slope,
               DropMask mask, float* __restrict__ out, float* __restrict__ partial, int H, int F,
               int Hp, int n_chunks) {
  constexpr int kSlots = 32 / G;
  constexpr int kWidth = G * V;
  const int64_t item = (static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x) >> 5;
  if (item >= plan.n_seg * n_chunks) return;  // uniform across the warp
  const int lane = threadIdx.x & 31;
  extern __shared__ float4 gode_smem[];
  float* tile = reinterpret_cast<float*>(gode_smem) + (threadIdx.x >> 5) * 32 * (Hp + 1);
  int32_t* cols = reinterpret_cast<int32_t*>(tile + 32 * Hp);
  const int chunk = static_cast<int>(item / plan.n_seg);
  const int64_t s = item - static_cast<int64_t>(chunk) * plan.n_seg;
  const int HF = H * F;
  int h0;
  const int n_heads = chunk_heads(chunk, kWidth, H, F, &h0);
  const int sub = lane / G;
  const int f = chunk * kWidth + (lane % G) * V;
  const bool live = f < HF;  // F % V == 0: the lane's V features are in one head
  const int hf = live ? f / F - h0 : 0;  // the lane's head, within the chunk
  const int hs = lane % Hp;              // the head of the lane's (edge, head) pairs
  const bool hs_live = hs < n_heads;
  const int per = 32 / Hp;
  const int64_t p0 = plan.seg_ptr[s];
  const int64_t p1 = plan.seg_ptr[s + 1];
  const int32_t sender = plan.seg_row[s];
  const float src = hs_live ? __ldg(s_src + static_cast<int64_t>(sender) * H + h0 + hs) : 0.f;
  const auto row = [&](int e) {
    return Lane<V>::ldg(g + static_cast<int64_t>(cols[e]) * HF + f);
  };
  Lane<V> acc = Lane<V>::zero();
  for (int64_t pb = p0; pb < p1; pb += 32) {
    const int n = static_cast<int>(p1 - pb < 32 ? p1 - pb : 32);
    if (lane < n) cols[lane] = __ldg(plan.col + pb + lane);
    __syncwarp();  // the receivers are in the tile
    Lane<V> x[kUnroll];
    load_rows<G, V>(x, 0, n, sub, live, row);  // in flight while the weights are computed
    for (int j = lane / Hp; hs_live && j < n; j += per) {
      const int32_t r = cols[j];
      const int64_t rh = static_cast<int64_t>(r) * H + h0 + hs;
      float z = src + __ldg(s_dst + rh);
      z = z > 0.f ? z : z * slope;
      const float a = expf(fminf(z - __ldg(m + rh), 0.f)) / __ldg(l + rh);
      tile[j * Hp + hs] = a * mask.at(pb + j, H, h0 + hs, sender, r);
    }
    __syncwarp();  // the weights are in the tile
    for (int j0 = 0; j0 < n; j0 += kSlots * kUnroll) {
      if (j0 > 0) load_rows<G, V>(x, j0, n, sub, live, row);
      fma_rows<G, V>(acc, x, tile, Hp, hf, j0, n, sub, live);
    }
    __syncwarp();  // the next batch overwrites the tile
  }
  acc = sum_slots<G, V>(acc);
  int64_t r_out = sender;
  const int slot = plan.seg_slot[s];
  // A segment of a split row: only the last of the row's warps to arrive writes it.
  if (slot >= 0 && !merge_split_row<G, V>(plan, slot, chunk, partial, HF, f, live, acc, r_out)) {
    return;
  }
  if (sub == 0 && live) acc.st(out + r_out * HF + f);
}

int check_launch(int64_t blocks) {
  return blocks > 0x7fffffff ? static_cast<int>(cudaErrorInvalidValue) : 0;
}

DropMask make_mask(int mode, const float* dmask, uint32_t seed, uint32_t keep24, float inv_keep) {
  return DropMask{mode, dmask, seed, keep24, inv_keep};
}

bool misaligned(const void* p, uintptr_t align = 16) {
  return reinterpret_cast<uintptr_t>(p) % align != 0;
}

bool power_of_two_to_32(int x) { return x >= 1 && x <= 32 && (x & (x - 1)) == 0; }

template <int G, int V, class TW>
int launch_fwd(const CsrPlan& plan, const float* logits, const TW* wh, DropMask mask,
               float* out, float* m, float* l, float* p_acc, float* p_stat, int H, int F, int Hp,
               int n_chunks, cudaStream_t st) {
  const int64_t blocks = (plan.n_seg * n_chunks + kWarpsPerBlock - 1) / kWarpsPerBlock;
  if (int rc = check_launch(blocks)) return rc;
  if (blocks == 0) return 0;
  const size_t smem = static_cast<size_t>(kWarpsPerBlock) * 32 * (Hp + 1) * sizeof(float);
  gat_fwd_kernel<G, V, TW><<<static_cast<unsigned>(blocks), kThreads, smem, st>>>(
      plan, logits, wh, mask, out, m, l, p_acc, p_stat, H, F, Hp, n_chunks);
  return static_cast<int>(cudaGetLastError());
}

template <int V, class TW>
int launch_bwd(const CsrPlan& plan, const float* logits, const TW* wh, const float* g,
               const float* m, const float* l, const float* beta, DropMask mask, float* dlogits,
               float* alpha_d, int H, int F, int Lh, int K, int Ge, int n_chunks, int64_t n_edge,
               int64_t n_rows, cudaStream_t st) {
  const int64_t n_zero = (n_rows - n_edge) * H;
  const int64_t warps = plan.n_seg * n_chunks + (n_zero + kZeroPerWarp - 1) / kZeroPerWarp;
  const int64_t blocks = (warps + kWarpsPerBlock - 1) / kWarpsPerBlock;
  if (int rc = check_launch(blocks)) return rc;
  if (blocks == 0) return 0;
  const int Hk = Ge / Lh;
  const int smem = kWarpsPerBlock * (64 * Hk + 32) * static_cast<int>(sizeof(float));
  if (smem > 48 * 1024) {  // above 48 KB only by the kernel's attribute
    cudaError_t rc = cudaFuncSetAttribute(gat_bwd_kernel<V, TW>,
                                          cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (rc != cudaSuccess) return static_cast<int>(rc);
  }
  gat_bwd_kernel<V, TW><<<static_cast<unsigned>(blocks), kThreads, smem, st>>>(
      plan, logits, wh, g, m, l, beta, mask, dlogits, alpha_d, H, F, Lh, K, Ge, n_chunks, n_edge,
      n_rows);
  return static_cast<int>(cudaGetLastError());
}

template <int G, int V>
int launch_dwh(const CsrPlan& plan, const float* s_src, const float* s_dst, const float* m,
               const float* l, const float* g, float slope, DropMask mask, float* out,
               float* partial, int H, int F, int Hp, int n_chunks, cudaStream_t st) {
  const int64_t blocks = (plan.n_seg * n_chunks + kWarpsPerBlock - 1) / kWarpsPerBlock;
  if (int rc = check_launch(blocks)) return rc;
  if (blocks == 0) return 0;
  const size_t smem = static_cast<size_t>(kWarpsPerBlock) * 32 * (Hp + 1) * sizeof(float);
  gat_dwh_kernel<G, V><<<static_cast<unsigned>(blocks), kThreads, smem, st>>>(
      plan, s_src, s_dst, m, l, g, slope, mask, out, partial, H, F, Hp, n_chunks);
  return static_cast<int>(cudaGetLastError());
}

// The checks and the launch of gode_gat_fwd_{f32,bf16}: TW is wh's storage
// type, and a float4 lane's wh rows are aligned to 4 of it.
template <class TW>
int fwd_entry(const CsrPlan* plan, const float* logits, const TW* wh, int mask_mode,
              const float* dmask, uint32_t seed, uint32_t keep24, float inv_keep, float* out,
              float* m, float* l, float* p_acc, float* p_stat, int64_t H, int64_t F, int lanes,
              int vec, int hp, void* stream) {
  const auto bad = static_cast<int>(cudaErrorInvalidValue);
  if (H < 1 || F < 1 || H * F > 0x7fffffff || mask_mode < 0 || mask_mode > 2) return bad;
  if (!power_of_two_to_32(lanes) || !power_of_two_to_32(hp) || (vec != 1 && vec != 4)) return bad;
  const int h = static_cast<int>(H), f = static_cast<int>(F), width = lanes * vec;
  const int n_chunks = (h * f + width - 1) / width;
  for (int c = 0, first; c < n_chunks; ++c) {
    if (chunk_heads(c, width, h, f, &first) > hp) return bad;
  }
  if (plan->n_split > 0 && (p_acc == nullptr || p_stat == nullptr)) return bad;
  if (plan->n_split * n_chunks > plan->n_arrivals) return bad;
  if (vec == 4 && (f % 4 != 0 || lanes < 8 || misaligned(wh, 4 * sizeof(TW)) || misaligned(out) ||
                   (p_acc != nullptr && misaligned(p_acc)))) {
    return bad;
  }
  const DropMask mask = make_mask(mask_mode, dmask, seed, keep24, inv_keep);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define GODE_FWD(G_, V_)                                                                     \
  return launch_fwd<G_, V_, TW>(*plan, logits, wh, mask, out, m, l, p_acc, p_stat, h, f, hp, \
                                n_chunks, st)
  if (vec == 4) {
    switch (lanes) {
      case 8: GODE_FWD(8, 4);
      case 16: GODE_FWD(16, 4);
      case 32: GODE_FWD(32, 4);
      default: return bad;
    }
  }
  switch (lanes) {
    case 1: GODE_FWD(1, 1);
    case 2: GODE_FWD(2, 1);
    case 4: GODE_FWD(4, 1);
    case 8: GODE_FWD(8, 1);
    case 16: GODE_FWD(16, 1);
    default: GODE_FWD(32, 1);
  }
#undef GODE_FWD
}

// The checks and the launch of gode_gat_bwd_{f32,bf16}.
template <class TW>
int bwd_entry(const CsrPlan* plan, int64_t n_edge, int64_t n_rows, const float* logits,
              const TW* wh, const float* g, const float* m, const float* l, const float* beta,
              int mask_mode, const float* dmask, uint32_t seed, uint32_t keep24, float inv_keep,
              float* dlogits, float* alpha_d, int64_t H, int64_t F, int lanes_per_head, int vec,
              void* stream) {
  const auto bad = static_cast<int>(cudaErrorInvalidValue);
  if (H < 1 || F < 1 || H * F > 0x7fffffff || mask_mode < 0 || mask_mode > 2) return bad;
  if (!power_of_two_to_32(lanes_per_head) || (vec != 1 && vec != 4) || n_rows < n_edge) return bad;
  if (vec == 4 && (F % 4 != 0 || misaligned(wh, 4 * sizeof(TW)) || misaligned(g))) return bad;
  const int h = static_cast<int>(H), f = static_cast<int>(F), Lh = lanes_per_head;
  const int Q = f / vec;
  const int K = (Q + Lh - 1) / Lh;
  int Ge = 1;
  while (Ge < 32 && Ge < h * Lh) Ge *= 2;
  const int n_chunks = (h + Ge / Lh - 1) / (Ge / Lh);
  const DropMask mask = make_mask(mask_mode, dmask, seed, keep24, inv_keep);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (vec == 4) {
    return launch_bwd<4, TW>(*plan, logits, wh, g, m, l, beta, mask, dlogits, alpha_d, h, f, Lh,
                             K, Ge, n_chunks, n_edge, n_rows, st);
  }
  return launch_bwd<1, TW>(*plan, logits, wh, g, m, l, beta, mask, dlogits, alpha_d, h, f, Lh, K,
                           Ge, n_chunks, n_edge, n_rows, st);
}

}  // namespace

// Each entry point launches on `stream`, does not synchronise, and returns
// cudaGetLastError() after its launch (0 on success).  Tensors are
// contiguous f32 (int32 / int64 for the graph):
//   logits [>= E, H] and dlogits [n_rows >= E, H], alpha_d [E, H] in CSR order;
//   wh, g, out, dwh [N, H, F]; m, l, beta, s_src, s_dst [N, H];
//   dmask [E, H] in CSR order (mask_mode 1 only).
// `plan` is the LaunchPlan of the receiver-sorted (CSR) view, for gat_dwh
// that of the sender-sorted (CSC) view.

// gat_fwd, one launch.  `lanes` (G, a power of two <= 32) and `vec` (V, 1 or
// 4) shape a warp item: a chunk is G·V features of the H·F row; V = 4 needs
// F % 4 == 0, G >= 8 and wh, out and p_acc 16-byte aligned.  `hp` is a power
// of two <= 32 and >= the heads any chunk touches.  With split rows, p_acc
// [n_slots, H·F] and p_stat [n_slots, n_chunks, 2, hp] are scratch, and the
// plan's arrival counters cover n_split times the number of chunks.
extern "C" int gode_gat_fwd_f32(const CsrPlan* plan, const float* logits, const float* wh,
                                int mask_mode, const float* dmask, uint32_t seed,
                                uint32_t keep24, float inv_keep, float* out, float* m, float* l,
                                float* p_acc, float* p_stat, int64_t H, int64_t F, int lanes,
                                int vec, int hp, void* stream) {
  return fwd_entry<float>(plan, logits, wh, mask_mode, dmask, seed, keep24, inv_keep, out, m, l,
                          p_acc, p_stat, H, F, lanes, vec, hp, stream);
}

// gat_fwd on a bf16 wh: the same arguments; V = 4 needs wh 8-byte aligned
// (out and p_acc stay f32, 16-byte aligned).
extern "C" int gode_gat_fwd_bf16(const CsrPlan* plan, const float* logits,
                                 const __nv_bfloat16* wh, int mask_mode, const float* dmask,
                                 uint32_t seed, uint32_t keep24, float inv_keep, float* out,
                                 float* m, float* l, float* p_acc, float* p_stat, int64_t H,
                                 int64_t F, int lanes, int vec, int hp, void* stream) {
  return fwd_entry<__nv_bfloat16>(plan, logits, wh, mask_mode, dmask, seed, keep24, inv_keep,
                                  out, m, l, p_acc, p_stat, H, F, lanes, vec, hp, stream);
}

// gat_bwd, one launch.  `lanes_per_head` (Lh, a power of two <= 32) and `vec`
// (V, 1 or 4; 4 needs F % 4 == 0 and wh, g 16-byte aligned) shape the lanes:
// a lane adds K = ceil(F / V / Lh) of its head's V-float groups, an edge
// takes Ge = min(32, the power of two >= H·Lh) lanes, and a warp item covers
// Ge / Lh heads, so a head never spans warps.  `n_rows` is dlogits' row
// count: rows [n_edge, n_rows) are written with zeros.
extern "C" int gode_gat_bwd_f32(const CsrPlan* plan, int64_t n_edge, int64_t n_rows,
                                const float* logits, const float* wh, const float* g,
                                const float* m, const float* l, const float* beta,
                                int mask_mode, const float* dmask, uint32_t seed,
                                uint32_t keep24, float inv_keep, float* dlogits, float* alpha_d,
                                int64_t H, int64_t F, int lanes_per_head, int vec, void* stream) {
  return bwd_entry<float>(plan, n_edge, n_rows, logits, wh, g, m, l, beta, mask_mode, dmask, seed,
                          keep24, inv_keep, dlogits, alpha_d, H, F, lanes_per_head, vec, stream);
}

// gat_bwd on a bf16 wh: the same arguments; V = 4 needs wh 8-byte aligned
// and g 16-byte aligned.
extern "C" int gode_gat_bwd_bf16(const CsrPlan* plan, int64_t n_edge, int64_t n_rows,
                                 const float* logits, const __nv_bfloat16* wh, const float* g,
                                 const float* m, const float* l, const float* beta,
                                 int mask_mode, const float* dmask, uint32_t seed,
                                 uint32_t keep24, float inv_keep, float* dlogits,
                                 float* alpha_d, int64_t H, int64_t F, int lanes_per_head,
                                 int vec, void* stream) {
  return bwd_entry<__nv_bfloat16>(plan, n_edge, n_rows, logits, wh, g, m, l, beta, mask_mode,
                                  dmask, seed, keep24, inv_keep, dlogits, alpha_d, H, F,
                                  lanes_per_head, vec, stream);
}

// gat_dwh, one launch, over the CSC view (rows are senders, the plan's
// columns their receivers): dwh, every row written (an edgeless row's one
// empty segment writes zeros; a plan with rows that have no segment is
// refused).  `lanes`, `vec` and `hp` shape a warp item as gat_fwd's do; V = 4
// needs F % 4 == 0, G >= 8 and g, out and partial 16-byte aligned.  With
// split rows, `partial` [n_slots, H·F] is scratch, and the plan's arrival
// counters cover n_split times the number of chunks.  The CSC walk
// regenerates the mask: an explicit CSR-order mask cannot be read here.
extern "C" int gode_gat_dwh_f32(const CsrPlan* plan, const float* s_src, const float* s_dst,
                                const float* m, const float* l, const float* g, float slope,
                                int mask_mode, uint32_t seed, uint32_t keep24, float inv_keep,
                                float* out, float* partial, int64_t H, int64_t F, int lanes,
                                int vec, int hp, void* stream) {
  const auto bad = static_cast<int>(cudaErrorInvalidValue);
  if (H < 1 || F < 1 || H * F > 0x7fffffff) return bad;
  if (mask_mode != gode::kNone && mask_mode != gode::kHash) return bad;
  if (!power_of_two_to_32(lanes) || !power_of_two_to_32(hp) || (vec != 1 && vec != 4)) return bad;
  const int h = static_cast<int>(H), f = static_cast<int>(F), width = lanes * vec;
  const int n_chunks = (h * f + width - 1) / width;
  for (int c = 0, first; c < n_chunks; ++c) {
    if (chunk_heads(c, width, h, f, &first) > hp) return bad;
  }
  if (plan->n_empty > 0) return bad;
  if (plan->n_split > 0 && partial == nullptr) return bad;
  if (plan->n_split * n_chunks > plan->n_arrivals) return bad;
  if (vec == 4 && (f % 4 != 0 || lanes < 8 || misaligned(g) || misaligned(out) ||
                   (partial != nullptr && misaligned(partial)))) {
    return bad;
  }
  const DropMask mask = make_mask(mask_mode, nullptr, seed, keep24, inv_keep);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define GODE_DWH(G_, V_)                                                                   \
  return launch_dwh<G_, V_>(*plan, s_src, s_dst, m, l, g, slope, mask, out, partial, h, f, \
                            hp, n_chunks, st)
  if (vec == 4) {
    switch (lanes) {
      case 8: GODE_DWH(8, 4);
      case 16: GODE_DWH(16, 4);
      case 32: GODE_DWH(32, 4);
      default: return bad;
    }
  }
  switch (lanes) {
    case 1: GODE_DWH(1, 1);
    case 2: GODE_DWH(2, 1);
    case 4: GODE_DWH(4, 1);
    case 8: GODE_DWH(8, 1);
    case 16: GODE_DWH(16, 1);
    default: GODE_DWH(32, 1);
  }
#undef GODE_DWH
}
