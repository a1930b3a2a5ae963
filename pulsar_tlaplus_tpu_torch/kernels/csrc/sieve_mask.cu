// K3 — the tiered store's sieve-mask plane.
//
// Replaces: pulsar_tlaplus_tpu/ops/tiles.py:sieve_mask_planes
// (impl="pallas"; plain twin: the three jnp.wheres of impl="tile").
//
// Over the cap + 1 slots of the slot-major visited table tab[n][K],
// with cold[i] the eviction mask of slot i:
//   masked_c[i] = cold ? t_c[i] : SENTINEL   (the run the sort sees)
//   holed_c[i]  = cold ? SENTINEL : t_c[i]   (the table after eviction)
//   gen'[i]     = cold ? 0 : gen[i]
// for each of the K = 2 or 3 key columns.  The Pallas kernel walks
// 4096-slot tiles in grid order; here every slot is independent, so
// one thread takes a slot and a grid-stride loop covers the table.
//
// Bound on the card: bytes.  Per slot it reads 4K + 4 + 1 bytes and
// writes 8K + 4 (33 B at K = 2) and does a handful of selects, far
// under the ALU rate.  Design: consecutive threads take consecutive
// slots, so a warp's table loads are one contiguous span (one uint2 a
// slot at K = 2, three words at K = 3) and every store is one coalesced
// 128-byte line per plane (32 bytes for the cold bytes); the 2K + 1
// outputs are planes of one [2K + 1, n] buffer.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr uint32_t kSent = 0xFFFFFFFFu;

template <int K>
__global__ void sieve_mask_kernel(const uint32_t* __restrict__ tab,
                                  const int32_t* __restrict__ gen,
                                  const uint8_t* __restrict__ cold,
                                  uint32_t* __restrict__ out, int64_t n) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const bool c = cold[i] != 0;
    uint32_t v[K];
    if constexpr (K == 2) {
      const uint2 s = reinterpret_cast<const uint2*>(tab)[i];
      v[0] = s.x;
      v[1] = s.y;
    } else {
#pragma unroll
      for (int j = 0; j < K; ++j) v[j] = tab[K * i + j];
    }
#pragma unroll
    for (int j = 0; j < K; ++j) {
      out[j * n + i] = c ? v[j] : kSent;
      out[(K + j) * n + i] = c ? kSent : v[j];
    }
    out[2 * K * n + i] = c ? 0u : (uint32_t)gen[i];
  }
}

}  // namespace

// tab: u32[n][k] slot-major table (8-byte aligned when k == 2);
// gen: i32[n]; cold: bool[n]; out: u32[2k + 1, n] (masked planes,
// holed planes, cleared generations).
extern "C" int ptt_sieve_mask(const void* tab, const void* gen,
                              const void* cold, void* out, int64_t n,
                              int k, void* stream) {
  if (n > 0) {
    int64_t blocks = (n + 255) / 256;
    if (blocks > 8192) blocks = 8192;  // grid-stride past this
    cudaStream_t s = (cudaStream_t)stream;
    if (k == 3) {
      sieve_mask_kernel<3><<<(unsigned)blocks, 256, 0, s>>>(
          (const uint32_t*)tab, (const int32_t*)gen, (const uint8_t*)cold,
          (uint32_t*)out, n);
    } else {
      sieve_mask_kernel<2><<<(unsigned)blocks, 256, 0, s>>>(
          (const uint32_t*)tab, (const int32_t*)gen, (const uint8_t*)cold,
          (uint32_t*)out, n);
    }
  }
  return (int)cudaGetLastError();
}
