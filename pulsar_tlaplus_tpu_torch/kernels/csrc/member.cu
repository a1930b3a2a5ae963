// K1 — the flush's blocked membership prefilter.
//
// Replaces: pulsar_tlaplus_tpu/ops/tiles.py:member_block_pallas (plain
// twin member_block / _member_plane).
//
// For lane i with key (k0, k1[, k2]) and valid[i]: h = slot_hash(key)
// (the fmix chain of ops/fpset.py), then the triangular probe sequence
// s_r = (h + r(r+1)/2) & (cap - 1), r < rounds, over the slot-major
// table tab[cap + 1][K].  member = the key is seen before the first
// empty (all-SENTINEL) slot; resolved = member, or an empty slot was
// seen.  Invalid lanes read as resolved non-members.  The Pallas kernel
// gathers all `rounds` slots of a lane tile at once and reduces
// first-match against first-empty; here a lane stops at whichever it
// meets first, which gives the same two flags with fewer loads.
//
// Bound on the card: random 32-byte sectors.  The byte bound counts 4
// bytes a probed word (0.0138 ms at the scaled run's flush: nq =
// 2,228,224 lanes on a 2^26-slot table holding 16M keys, ~1.2 probes a
// lane), but every probe lands on a random sector of a table far
// larger than the 50 MB L2, so the sectors it touches, not the bytes it
// uses, set the time.  In the slot-major layout a K = 2 slot is one
// aligned 8-byte load, one sector, and the triangular offsets 0, 1, 3
// mostly stay inside it: about 2.4M random sectors at those shapes
// (77 MB; chip_smoke.py phase 2b counts them), half what K separate
// columns cost.  K = 3 reads three consecutive words (a quarter of the
// slots straddle two sectors), unpadded so the table's bytes stay 4K a
// slot.  Design: four consecutive lanes a thread, their probes issued
// together so four independent random loads are in flight a thread;
// the lanes' flags move as one uchar4 and their keys as one uint4 a
// column where aligned; the early exit above.
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
constexpr int kLanes = 4;  // lanes a thread
constexpr int kThreads = 256;

template <int K>
__global__ void __launch_bounds__(kThreads)
    member_kernel(const uint32_t* __restrict__ tab,
                  const uint32_t* __restrict__ q0,
                  const uint32_t* __restrict__ q1,
                  const uint32_t* __restrict__ q2,
                  const uint8_t* __restrict__ valid,
                  uint8_t* __restrict__ member,
                  uint8_t* __restrict__ resolved, int64_t nq, uint32_t capm,
                  int rounds) {
  const int64_t i0 =
      ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) * kLanes;
  if (i0 >= nq) return;
  const bool full = i0 + kLanes <= nq;
  const uint32_t* q[3] = {q0, q1, q2};

  bool live[kLanes];
  if (full) {  // valid is 4-byte aligned (checked by the wrapper)
    const uchar4 v = *reinterpret_cast<const uchar4*>(valid + i0);
    live[0] = v.x;
    live[1] = v.y;
    live[2] = v.z;
    live[3] = v.w;
  } else {
#pragma unroll
    for (int j = 0; j < kLanes; ++j)
      live[j] = i0 + j < nq && valid[i0 + j] != 0;
  }

  uint32_t key[kLanes][K];
  bool vec = full;
#pragma unroll
  for (int c = 0; c < K; ++c)
    vec = vec && ((uintptr_t)(q[c] + i0) & 15) == 0;
#pragma unroll
  for (int c = 0; c < K; ++c) {
    if (vec) {
      const uint4 w = *reinterpret_cast<const uint4*>(q[c] + i0);
      key[0][c] = w.x;
      key[1][c] = w.y;
      key[2][c] = w.z;
      key[3][c] = w.w;
    } else {
#pragma unroll
      for (int j = 0; j < kLanes; ++j)
        key[j][c] = live[j] ? q[c][i0 + j] : 0u;
    }
  }

  uint32_t h[kLanes];
  uint8_t m[kLanes], res[kLanes];
#pragma unroll
  for (int j = 0; j < kLanes; ++j) {
    uint32_t x = fmix32(key[j][0] ^ 0x9E3779B9u);
#pragma unroll
    for (int c = 1; c < K; ++c) x = fmix32(x ^ key[j][c]);
    h[j] = x;
    m[j] = 0;
    res[j] = !live[j];
  }

  for (int r = 0; r < rounds; ++r) {
    const uint32_t tri = (uint32_t)((r * (r + 1)) >> 1);
    uint32_t w[kLanes][K];
    // all live lanes' loads first: up to four random sectors in flight
#pragma unroll
    for (int j = 0; j < kLanes; ++j) {
      if (!live[j]) continue;
      const uint32_t s = (h[j] + tri) & capm;
      if constexpr (K == 2) {
        const uint2 v = *reinterpret_cast<const uint2*>(tab + 2 * (size_t)s);
        w[j][0] = v.x;
        w[j][1] = v.y;
      } else {
#pragma unroll
        for (int c = 0; c < K; ++c) w[j][c] = tab[(size_t)K * s + c];
      }
    }
    bool any = false;
#pragma unroll
    for (int j = 0; j < kLanes; ++j) {
      if (!live[j]) continue;
      bool empty = true, eq = true;
#pragma unroll
      for (int c = 0; c < K; ++c) {
        empty = empty && w[j][c] == kSent;
        eq = eq && w[j][c] == key[j][c];
      }
      if (empty) {  // an empty slot first: a new key
        res[j] = 1;
        live[j] = false;
      } else if (eq) {  // the key: a member
        m[j] = 1;
        res[j] = 1;
        live[j] = false;
      }
      any = any || live[j];
    }
    if (!any) break;
  }

  if (full) {
    *reinterpret_cast<uchar4*>(member + i0) = make_uchar4(m[0], m[1], m[2], m[3]);
    *reinterpret_cast<uchar4*>(resolved + i0) =
        make_uchar4(res[0], res[1], res[2], res[3]);
  } else {
#pragma unroll
    for (int j = 0; j < kLanes; ++j) {
      if (i0 + j < nq) {
        member[i0 + j] = m[j];
        resolved[i0 + j] = res[j];
      }
    }
  }
}

}  // namespace

// tab: u32[cap + 1][k] slot-major table (8-byte aligned when k == 2);
// q*: u32[nq] keys (q2 null when k == 2); valid, member, resolved:
// bool[nq], 4-byte aligned; capm = cap - 1 (cap a power of 2).
extern "C" int ptt_member_block(const void* tab, const void* q0,
                                const void* q1, const void* q2,
                                const void* valid, void* member,
                                void* resolved, int64_t nq, uint32_t capm,
                                int k, int rounds, void* stream) {
  if (nq > 0) {
    const int64_t threads = (nq + kLanes - 1) / kLanes;
    const unsigned blocks = (unsigned)((threads + kThreads - 1) / kThreads);
    cudaStream_t s = (cudaStream_t)stream;
    const auto* t = (const uint32_t*)tab;
    const auto* a = (const uint32_t*)q0;
    const auto* b = (const uint32_t*)q1;
    const auto* c = (const uint32_t*)q2;
    const auto* v = (const uint8_t*)valid;
    auto* m = (uint8_t*)member;
    auto* r = (uint8_t*)resolved;
    if (k == 3)
      member_kernel<3><<<blocks, kThreads, 0, s>>>(t, a, b, c, v, m, r, nq,
                                                   capm, rounds);
    else
      member_kernel<2><<<blocks, kThreads, 0, s>>>(t, a, b, c, v, m, r, nq,
                                                   capm, rounds);
  }
  return (int)cudaGetLastError();
}
