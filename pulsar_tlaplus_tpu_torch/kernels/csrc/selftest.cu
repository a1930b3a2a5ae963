// K0 — capability probe: o[i] = x[i] + 1 over int32.
//
// Replaces: pulsar_tlaplus_tpu/ops/tiles.py:pallas_lowers_natively (its
// probe kernel _k, run once before any Pallas kernel is trusted).  The
// loader launches this after building and each checker run launches it
// once on its card, so a library built for another architecture, or a
// card that cannot run it, fails before the BFS starts.
//
// Bound on the card: 64 bytes moved; launch latency dominates.  Design:
// one thread per element, nothing more.
#include <cstdint>
#include <cuda_runtime.h>

__global__ void ptt_selftest_kernel(const int32_t* __restrict__ x,
                                    int32_t* __restrict__ o, int n) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) o[i] = x[i] + 1;
}

extern "C" int ptt_selftest(const void* x, void* o, int n, void* stream) {
  if (n > 0) {
    ptt_selftest_kernel<<<(n + 255) / 256, 256, 0, (cudaStream_t)stream>>>(
        (const int32_t*)x, (int32_t*)o, n);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* ptt_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
