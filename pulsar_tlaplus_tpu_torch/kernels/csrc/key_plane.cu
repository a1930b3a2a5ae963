// K2 — the expand key plane: K key columns of a packed successor matrix.
//
// Replaces: pulsar_tlaplus_tpu/ops/tiles.py:key_plane (impl="pallas";
// body _key_cols_kernel, _murmur3_words_k, _fmix_k, _rotl_k).
//
// For row i of packed u32[nc, W] with valid[i]:
//   exact mode  — out[c][i] = c < W ? packed[i][c] : 0
//   hashed mode — out[c][i] = murmur3_32(packed[i], seed_c) over the W
//                 words (seeds 0x9E3779B9, 0x85EBCA6B, 0xC2B2AE35, the
//                 first K; length mix 4*W); an all-SENTINEL tuple gets
//                 its last column XOR 1
// and out[c][i] = SENTINEL (0xFFFFFFFF) where !valid[i].  The words are
// int32 bit patterns in PyTorch and read here as uint32.
//
// Bound on the card: bytes.  Each row reads W*4 + 1 bytes and writes
// K*4; the mixing is ~10 integer operations a word, far below the
// integer rate.  Design: one thread per row, every key column from one
// pass over the row (each word is loaded once and feeds all K hashes),
// column-major output so the K stores of a warp are coalesced.  The row
// loads are strided across a warp (W*4 bytes apart); the 32-byte
// sectors they touch are read whole by the warp over the row loop, so
// no byte is fetched from memory twice.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ uint32_t rotl32(uint32_t x, int r) {
  return (x << r) | (x >> (32 - r));
}

__device__ __forceinline__ uint32_t fmix32(uint32_t h) {
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  return h ^ (h >> 16);
}

__global__ void key_plane_kernel(const uint32_t* __restrict__ packed,
                                 const uint8_t* __restrict__ valid,
                                 uint32_t* __restrict__ out, int64_t nc,
                                 int w, int k, int exact) {
  int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= nc) return;
  const uint32_t* row = packed + i * w;
  uint32_t h[3];
  if (exact) {
    for (int c = 0; c < k; ++c) h[c] = c < w ? row[c] : 0u;
  } else {
    const uint32_t seeds[3] = {0x9E3779B9u, 0x85EBCA6Bu, 0xC2B2AE35u};
    for (int c = 0; c < k; ++c) h[c] = seeds[c];
    for (int j = 0; j < w; ++j) {
      uint32_t kw = row[j] * 0xCC9E2D51u;
      kw = rotl32(kw, 15) * 0x1B873593u;
      for (int c = 0; c < k; ++c) {
        uint32_t x = h[c] ^ kw;
        h[c] = rotl32(x, 13) * 5u + 0xE6546B64u;
      }
    }
    bool all_sent = true;
    for (int c = 0; c < k; ++c) {
      h[c] = fmix32(h[c] ^ (uint32_t)(4 * w));
      all_sent = all_sent && h[c] == 0xFFFFFFFFu;
    }
    if (all_sent) h[k - 1] ^= 1u;
  }
  bool v = valid[i] != 0;
  for (int c = 0; c < k; ++c) out[c * nc + i] = v ? h[c] : 0xFFFFFFFFu;
}

}  // namespace

// packed: u32[nc, w] row-major; valid: bool[nc]; out: u32[k, nc].
extern "C" int ptt_key_plane(const void* packed, const void* valid,
                             void* out, int64_t nc, int w, int k,
                             int exact, void* stream) {
  if (nc > 0) {
    int64_t blocks = (nc + 255) / 256;
    key_plane_kernel<<<(unsigned)blocks, 256, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)packed, (const uint8_t*)valid, (uint32_t*)out, nc,
        w, k, exact);
  }
  return (int)cudaGetLastError();
}
