// Counter-based attention dropout, the CUDA side of ops/dropmask.py.
//
// The mask of edge (s, r) and head h is a pure function of (s, r, h, seed):
// a murmur3 finaliser over a mixed key, bit-identical to
// graph_odenet_tpu/ops/dropmask.py.  Each kernel regenerates it in the edge
// order it walks, so no [E, H] mask is stored.
#pragma once

#include <cstdint>

namespace gode {

constexpr uint32_t kSnd = 0x9E3779B9u;
constexpr uint32_t kRcv = 0x85EBCA6Bu;
constexpr uint32_t kHead = 0xC2B2AE35u;
constexpr uint32_t kF1 = 0x7FEB352Du;
constexpr uint32_t kF2 = 0x846CA68Bu;

__device__ __forceinline__ uint32_t hash_edge_head(uint32_t s, uint32_t r, uint32_t h,
                                                   uint32_t seed) {
  uint32_t x = (s * kSnd) ^ (r * kRcv) ^ (h * kHead) ^ seed;
  x ^= x >> 16;
  x *= kF1;
  x ^= x >> 15;
  x *= kF2;
  x ^= x >> 16;
  return x;
}

// The α scale of one edge and head: how the kernels apply dropout.
//   kNone:     1
//   kExplicit: dmask[p * H + h], an [E, H] array in the kernel's edge order
//   kHash:     inv_keep where the hash's top 24 bits are below keep24, else 0
enum MaskMode : int { kNone = 0, kExplicit = 1, kHash = 2 };

struct DropMask {
  int mode;
  const float* dmask;
  uint32_t seed;
  uint32_t keep24;
  float inv_keep;

  __device__ __forceinline__ float at(int64_t p, int64_t H, int64_t h, int32_t sender,
                                      int32_t receiver) const {
    if (mode == kExplicit) return __ldg(dmask + p * H + h);
    if (mode == kHash) {
      const uint32_t x = hash_edge_head(static_cast<uint32_t>(sender),
                                        static_cast<uint32_t>(receiver),
                                        static_cast<uint32_t>(h), seed);
      return (x >> 8) < keep24 ? inv_keep : 0.f;
    }
    return 1.f;
  }
};

}  // namespace gode
