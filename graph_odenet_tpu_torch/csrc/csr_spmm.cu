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
//     is the slowest axis of the grid.  (Chunks of 32 features, whose column
//     slice of x fits the 50 MB L2 at arxiv size, were slower: more warp
//     items, each reading its columns again.)
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
                 int64_t F, int64_t feat, int mode, int lanes, int vec, int accumulate,
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
// number of chunks.  Launches on `stream`, does not synchronise, and returns
// cudaGetLastError() after the launch (0 on success).
extern "C" int gode_csr_reduce_f32(const CsrPlan* plan, const float* x, const float* alpha,
                                   float* out, float* partial, int64_t F, int64_t feat, int mode,
                                   int lanes, int vec, int accumulate, void* stream) {
  return reduce_entry<float>(plan, x, alpha, out, partial, F, feat, mode, lanes, vec, accumulate,
                             stream);
}

// The same launch on bf16 x and out (modes 0 and 2; mode 1 is refused):
// features widened to f32, summed in f32 (partial rows included), each
// output element rounded once.  V = 4 needs x and out 8-byte aligned.
extern "C" int gode_csr_reduce_bf16(const CsrPlan* plan, const __nv_bfloat16* x,
                                    __nv_bfloat16* out, float* partial, int64_t F, int mode,
                                    int lanes, int vec, int accumulate, void* stream) {
  if (mode == static_cast<int>(Mode::kAlpha)) return static_cast<int>(cudaErrorInvalidValue);
  return reduce_entry<__nv_bfloat16>(plan, x, nullptr, out, partial, F, 1, mode, lanes, vec,
                                     accumulate, stream);
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
