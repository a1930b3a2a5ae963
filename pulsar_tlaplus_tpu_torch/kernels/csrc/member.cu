// K1 — the flush's blocked membership prefilter.
//
// Replaces: pulsar_tlaplus_tpu/ops/tiles.py:member_block_pallas (plain
// twin member_block / _member_plane).
//
// For lane i with key (k0, k1[, k2]) and valid[i]: h = slot_hash(key)
// (the fmix chain of ops/fpset.py), then the triangular probe sequence
// s_r = (h + r(r+1)/2) & (cap - 1), r < rounds, over the K table
// columns.  member = the key is seen before the first empty
// (all-SENTINEL) slot; resolved = member, or an empty slot was seen.
// Invalid lanes read as resolved non-members.  The Pallas kernel
// gathers all `rounds` slots of a lane tile at once and reduces
// first-match against first-empty; here a lane stops at whichever it
// meets first, which gives the same two flags with fewer loads.
//
// Bound on the card: bytes, and of those the random table gathers: a
// probe reads K words from K columns at a random slot, i.e. K 32-byte
// sectors of which 4 bytes each are used.  At load <= 1/2 a lane stops
// after ~2 probes on average.  Design: one thread per lane with the
// table whole in device memory, the early exit above (the average
// probe count, not `rounds`, sets the traffic), and coalesced loads of
// the key columns and stores of the flags.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ uint32_t fmix32(uint32_t h) {
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  return h ^ (h >> 16);
}

constexpr uint32_t kSent = 0xFFFFFFFFu;

__global__ void member_kernel(const uint32_t* __restrict__ t0,
                              const uint32_t* __restrict__ t1,
                              const uint32_t* __restrict__ t2,
                              const uint32_t* __restrict__ q0,
                              const uint32_t* __restrict__ q1,
                              const uint32_t* __restrict__ q2,
                              const uint8_t* __restrict__ valid,
                              uint8_t* __restrict__ member,
                              uint8_t* __restrict__ resolved, int64_t nq,
                              uint32_t capm, int k, int rounds) {
  int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= nq) return;
  if (!valid[i]) {
    member[i] = 0;
    resolved[i] = 1;
    return;
  }
  const bool three = k == 3;
  const uint32_t a = q0[i], b = q1[i], c = three ? q2[i] : 0u;
  uint32_t h = fmix32(a ^ 0x9E3779B9u);
  h = fmix32(h ^ b);
  if (three) h = fmix32(h ^ c);
  uint8_t m = 0, res = 0;
  for (int r = 0; r < rounds; ++r) {
    const uint32_t s = (h + (uint32_t)((r * (r + 1)) >> 1)) & capm;
    const uint32_t x = t0[s], y = t1[s];
    const uint32_t z = three ? t2[s] : kSent;
    if (x == kSent && y == kSent && z == kSent) {  // empty: a new key
      res = 1;
      break;
    }
    if (x == a && y == b && (!three || z == c)) {  // the key: a member
      m = 1;
      res = 1;
      break;
    }
  }
  member[i] = m;
  resolved[i] = res;
}

}  // namespace

// t*: u32[cap + 1] table columns (t2 null when k == 2); q*: u32[nq] keys;
// valid, member, resolved: bool[nq]; capm = cap - 1 (cap a power of 2).
extern "C" int ptt_member_block(const void* t0, const void* t1,
                                const void* t2, const void* q0,
                                const void* q1, const void* q2,
                                const void* valid, void* member,
                                void* resolved, int64_t nq, uint32_t capm,
                                int k, int rounds, void* stream) {
  if (nq > 0) {
    int64_t blocks = (nq + 255) / 256;
    member_kernel<<<(unsigned)blocks, 256, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)t0, (const uint32_t*)t1, (const uint32_t*)t2,
        (const uint32_t*)q0, (const uint32_t*)q1, (const uint32_t*)q2,
        (const uint8_t*)valid, (uint8_t*)member, (uint8_t*)resolved, nq,
        capm, k, rounds);
  }
  return (int)cudaGetLastError();
}
