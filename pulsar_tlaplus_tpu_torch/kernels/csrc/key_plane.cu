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
// K*4 (nc = 2,228,224, W = 20, K = 2: 198 MB, 0.059 ms at 3.35 TB/s);
// the mixing is ~9 integer operations a word, well under the ALU rate.
// One thread a row reading its own row from device memory makes every
// warp-wide load touch 32 sectors W*4 bytes apart, with one dependent
// miss a row in flight.  Design: a block owns tiles of kRows rows, and
// row-major `packed` makes a tile one contiguous span of kRows*W*4
// bytes, copied into shared memory by one bulk asynchronous copy
// (cp.async.bulk, completion counted on an mbarrier).  A persistent
// loop over tiles double-buffers the copies, so the next tile's bytes
// arrive while this tile is hashed.  Each thread then reads its row
// from shared memory, as uint4s where W % 4 == 0 (at W = 20 the eight
// threads of a quarter-warp hit 32 distinct banks).  W and K are
// template parameters, so the murmur chain unrolls; the main path's
// hashed W = 20 (K = 2 and 3) has its own instantiation, other widths a
// runtime-W one.  Exact W = 2 keys are the row itself: one coalesced
// uint2 read a row, no staging.  The ragged last tile is read straight
// from device memory.  Column-major output keeps the K stores of a warp
// coalesced.  The packed pointer must be 16-byte aligned (checked by
// the wrapper): the bulk copy needs it, and the tile span is a multiple
// of 16 bytes because kRows is.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr uint32_t kSent = 0xFFFFFFFFu;
constexpr int kRows = 256;  // rows a tile = threads a block

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

template <int K>
__device__ __forceinline__ void seed(uint32_t (&h)[K]) {
  const uint32_t seeds[3] = {0x9E3779B9u, 0x85EBCA6Bu, 0xC2B2AE35u};
#pragma unroll
  for (int c = 0; c < K; ++c) h[c] = seeds[c];
}

// one word into all K murmur3 states
template <int K>
__device__ __forceinline__ void mix(uint32_t (&h)[K], uint32_t word) {
  uint32_t kw = word * 0xCC9E2D51u;
  kw = rotl32(kw, 15) * 0x1B873593u;
#pragma unroll
  for (int c = 0; c < K; ++c) h[c] = rotl32(h[c] ^ kw, 13) * 5u + 0xE6546B64u;
}

template <int K>
__device__ __forceinline__ void finish(uint32_t (&h)[K], int w) {
  bool all_sent = true;
#pragma unroll
  for (int c = 0; c < K; ++c) {
    h[c] = fmix32(h[c] ^ (uint32_t)(4 * w));
    all_sent = all_sent && h[c] == kSent;
  }
  if (all_sent) h[K - 1] ^= 1u;
}

// the K keys of one row (in shared or device memory).  W > 0: hashed,
// W words, 16-byte aligned rows when W % 4 == 0; W == 0: the runtime
// width w, exact or hashed.
template <int W, int K>
__device__ __forceinline__ void row_keys(const uint32_t* row, int w,
                                         int exact, uint32_t (&h)[K]) {
  if constexpr (W > 0) {
    seed<K>(h);
    if constexpr (W % 4 == 0) {
#pragma unroll
      for (int j = 0; j < W / 4; ++j) {
        const uint4 v = reinterpret_cast<const uint4*>(row)[j];
        mix<K>(h, v.x);
        mix<K>(h, v.y);
        mix<K>(h, v.z);
        mix<K>(h, v.w);
      }
    } else {
#pragma unroll
      for (int j = 0; j < W; ++j) mix<K>(h, row[j]);
    }
    finish<K>(h, W);
  } else if (exact) {
#pragma unroll
    for (int c = 0; c < K; ++c) h[c] = c < w ? row[c] : 0u;
  } else {
    seed<K>(h);
    for (int j = 0; j < w; ++j) mix<K>(h, row[j]);
    finish<K>(h, w);
  }
}

template <int K>
__device__ __forceinline__ void store_keys(uint32_t* __restrict__ out,
                                           const uint8_t* __restrict__ valid,
                                           int64_t nc, int64_t i,
                                           const uint32_t (&h)[K]) {
  const bool v = valid[i] != 0;
#pragma unroll
  for (int c = 0; c < K; ++c) out[c * nc + i] = v ? h[c] : kSent;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(1u)
               : "memory");
}

// one arrival that also expects `bytes` of transactions this phase
__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::
                   "r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n"
        " .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// device memory -> shared memory, `bytes` (a multiple of 16, both ends
// 16-byte aligned), completion counted on `bar`
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

template <int W, int K>
__global__ void __launch_bounds__(kRows)
    key_plane_kernel(const uint32_t* __restrict__ packed,
                     const uint8_t* __restrict__ valid,
                     uint32_t* __restrict__ out, int64_t nc, int w_rt,
                     int exact) {
  extern __shared__ __align__(16) uint32_t tiles[];  // two tiles
  __shared__ uint64_t bar[2];
  const int w = W > 0 ? W : w_rt;
  const uint32_t tile_words = (uint32_t)kRows * w;
  const uint32_t tile_bytes = tile_words * 4u;
  const int64_t nfull = nc / kRows;  // whole tiles; the rest is ragged
  if (threadIdx.x == 0) {
    mbar_init(&bar[0]);
    mbar_init(&bar[1]);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  int64_t tile = blockIdx.x;
  if (threadIdx.x == 0 && tile < nfull) {
    mbar_expect(&bar[0], tile_bytes);
    bulk_load(tiles, packed + tile * tile_words, tile_bytes, &bar[0]);
  }
  for (int it = 0; tile < nfull; ++it, tile += gridDim.x) {
    const int st = it & 1;
    // the other buffer was released by the __syncthreads() that ended
    // the previous iteration: refill it with this block's next tile
    const int64_t next = tile + gridDim.x;
    if (threadIdx.x == 0 && next < nfull) {
      mbar_expect(&bar[st ^ 1], tile_bytes);
      bulk_load(tiles + (st ^ 1) * tile_words, packed + next * tile_words,
                tile_bytes, &bar[st ^ 1]);
    }
    // buffer st's (it / 2)-th fill completes phase it / 2
    mbar_wait(&bar[st], (uint32_t)(it >> 1) & 1u);
    uint32_t h[K];
    row_keys<W, K>(tiles + st * tile_words + threadIdx.x * w, w, exact, h);
    store_keys<K>(out, valid, nc, tile * kRows + threadIdx.x, h);
    __syncthreads();
  }

  // the ragged last tile, straight from device memory, by the block
  // whose turn it would be
  const int64_t i = nfull * kRows + threadIdx.x;
  if (blockIdx.x == nfull % gridDim.x && i < nc) {
    uint32_t h[K];
    row_keys<W, K>(packed + i * w, w, exact, h);
    store_keys<K>(out, valid, nc, i, h);
  }
}

// exact W = 2: the key is the row; one coalesced uint2 load a row
template <int K>
__global__ void __launch_bounds__(kRows)
    key_plane_kernel_w2(const uint2* __restrict__ packed,
                        const uint8_t* __restrict__ valid,
                        uint32_t* __restrict__ out, int64_t nc) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= nc) return;
  const uint2 r = packed[i];
  uint32_t h[K];
  h[0] = r.x;
  h[1] = r.y;
  if constexpr (K == 3) h[2] = 0u;
  store_keys<K>(out, valid, nc, i, h);
}

template <int W, int K>
cudaError_t launch_staged(const uint32_t* packed, const uint8_t* valid,
                          uint32_t* out, int64_t nc, int w, int exact,
                          cudaStream_t stream) {
  auto kern = key_plane_kernel<W, K>;
  const size_t smem = 2 * (size_t)kRows * w * sizeof(uint32_t);
  cudaError_t err = cudaSuccess;
  if (smem > 48 * 1024)
    err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  int dev = 0, sms = 0, per_sm = 0;
  if (!err) err = cudaGetDevice(&dev);
  if (!err)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (!err)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, kRows,
                                                        smem);
  if (err) return err;
  // persistent: at most as many blocks as fit on the card at once
  int64_t grid = nc / kRows;
  const int64_t resident = (int64_t)sms * (per_sm > 0 ? per_sm : 1);
  if (grid > resident) grid = resident;
  if (grid < 1) grid = 1;
  kern<<<(unsigned)grid, kRows, smem, stream>>>(packed, valid, out, nc, w,
                                                exact);
  return cudaGetLastError();
}

}  // namespace

// packed: u32[nc, w] row-major, 16-byte aligned; valid: bool[nc];
// out: u32[k, nc].
extern "C" int ptt_key_plane(const void* packed, const void* valid,
                             void* out, int64_t nc, int w, int k,
                             int exact, void* stream) {
  if (nc <= 0) return (int)cudaGetLastError();
  const auto* p = (const uint32_t*)packed;
  const auto* v = (const uint8_t*)valid;
  auto* o = (uint32_t*)out;
  auto s = (cudaStream_t)stream;
  if (exact && w == 2) {
    const unsigned blocks = (unsigned)((nc + kRows - 1) / kRows);
    if (k == 3)
      key_plane_kernel_w2<3><<<blocks, kRows, 0, s>>>((const uint2*)p, v, o,
                                                      nc);
    else
      key_plane_kernel_w2<2><<<blocks, kRows, 0, s>>>((const uint2*)p, v, o,
                                                      nc);
    return (int)cudaGetLastError();
  }
  cudaError_t err;
  if (!exact && w == 20)
    err = k == 3 ? launch_staged<20, 3>(p, v, o, nc, w, exact, s)
                 : launch_staged<20, 2>(p, v, o, nc, w, exact, s);
  else
    err = k == 3 ? launch_staged<0, 3>(p, v, o, nc, w, exact, s)
                 : launch_staged<0, 2>(p, v, o, nc, w, exact, s);
  return (int)err;
}
