// H1 — the flush's insert tail: triangular-probing lookup-or-insert of
// the survivor lanes of the membership prefilter, in one launch.
//
// Replaces: pulsar_tlaplus_tpu/ops/fpset.py:probe_insert as the tiled
// flush's tail runs it (ops/tiles.py:flush_acc_tiles' chunk loop; XLA
// there, no Pallas kernel).  Its plain twin is the port's chunk loop
// over ops/fpset.py:probe_insert (fpset.insert_tail_plain).
//
// Input: the prefilter's survivors compacted in lane order — K key
// columns q*[i] and original lane ids ids[i] for i < *npend, where the
// count *npend lives in device memory, so the host never learns it.
// The lanes go in chunks of cw, in order; a chunk runs probe rounds
// r = 0, 1, ... while any of its lanes is pending and r < max_probes.
// Round r of a pending lane with slot hash h looks at slot
// s = (h + r(r+1)/2) & capm of the slot-major table tab[cap + 1][K]:
//
//   phase A  the slot holds the lane's key: resolved (a duplicate);
//            the slot is empty: the lane bids atomicMin(claims[s], id);
//   phase B  a bidder whose id is claims[s] won: it writes its key to
//            the slot and flags is_new[id]; the others lost;
//   phase C  a winner resets claims[s]; a loser re-reads the slot and
//            resolves if it now holds its key; the lanes still pending
//            are counted.
//
// A grid-wide barrier (cooperative_groups::this_grid().sync()) ends
// each phase, so every read of a phase sees every write of the one
// before, exactly as the plain loop's whole-batch ops do: the same
// winners, the same table slot for slot (slot cap, the plain loop's
// write-only trash row, is never touched here), the same is_new, and
// the same round and failure counts.  The count of pending lanes goes
// to one of two device counters by the parity of the global round, so
// the counter a round adds to was cleared a round earlier, after
// everyone had read it; every thread reads it after the last barrier
// of the round, so all agree on when the chunk ends.
//
// Bound on the card: random 32-byte sectors, as for K1 (member.cu):
// each probe round of a lane reads one random slot of a table far
// larger than the 50 MB L2; the lane streams (keys, ids, a state byte)
// are small beside them.  A round also costs three grid barriers
// (~a few us each), which bound the flushes whose chunks run many
// rounds on few lanes.  Design: the lanes of a chunk are spread over a
// grid sized to what is co-resident (the occupancy API), in
// grid-stride loops whose thread-to-lane map is the same in every
// phase, so a lane's state byte never crosses threads; a K = 2 slot is
// one aligned uint2 load (K = 3 three words); the table and the bids
// are read through L2 (__ldcg), which the barriers keep coherent.
#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

__device__ __forceinline__ uint32_t fmix32(uint32_t h) {
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  return h ^ (h >> 16);
}

constexpr uint32_t kSent = 0xFFFFFFFFu;
constexpr int32_t kNoLane = 0x7FFFFFFF;  // an unclaimed slot's bid
constexpr int kThreads = 256;

// a lane's state between phases
enum : uint8_t { kDone = 0, kPending = 1, kBid = 2, kWon = 3, kLost = 4 };

struct Args {
  uint32_t* tab;           // [cap + 1][K] slot-major table (in place)
  const uint32_t* q0;      // survivor key columns, [>= npend]
  const uint32_t* q1;
  const uint32_t* q2;      // null when K == 2
  const int32_t* ids;      // original lane ids, [>= npend]
  const int64_t* npend;    // survivor count (device scalar)
  int32_t* claims;         // [cap + 1], all kNoLane (left so)
  uint8_t* is_new;         // [> max id], zeroed by the caller
  uint8_t* state;          // [cw] scratch
  int32_t* cnt;            // [2] scratch: pending lanes by round parity
  int64_t* stats;          // [2] out: probe rounds, failed lanes
  int64_t cw;              // chunk width
  uint32_t capm;           // cap - 1
  int max_probes;
};

template <int K>
__device__ __forceinline__ void load_key(const Args& a, int64_t i,
                                         uint32_t (&key)[K]) {
  key[0] = __ldg(a.q0 + i);
  key[1] = __ldg(a.q1 + i);
  if constexpr (K == 3) key[2] = __ldg(a.q2 + i);
}

template <int K>
__device__ __forceinline__ uint32_t slot_of(const uint32_t (&key)[K],
                                            uint32_t tri, uint32_t capm) {
  uint32_t h = fmix32(key[0] ^ 0x9E3779B9u);
#pragma unroll
  for (int c = 1; c < K; ++c) h = fmix32(h ^ key[c]);
  return (h + tri) & capm;
}

// the slot's words through L2 (other blocks wrote them before the last
// barrier)
template <int K>
__device__ __forceinline__ void load_slot(const uint32_t* tab, uint32_t s,
                                          uint32_t (&w)[K]) {
  if constexpr (K == 2) {
    const uint2 v = __ldcg(reinterpret_cast<const uint2*>(tab + 2 * (size_t)s));
    w[0] = v.x;
    w[1] = v.y;
  } else {
#pragma unroll
    for (int c = 0; c < K; ++c) w[c] = __ldcg(tab + (size_t)K * s + c);
  }
}

template <int K>
__device__ __forceinline__ bool is_key(const uint32_t (&w)[K],
                                       const uint32_t (&key)[K]) {
  bool eq = true;
#pragma unroll
  for (int c = 0; c < K; ++c) eq = eq && w[c] == key[c];
  return eq;
}

template <int K>
__device__ __forceinline__ bool is_empty(const uint32_t (&w)[K]) {
  bool e = true;
#pragma unroll
  for (int c = 0; c < K; ++c) e = e && w[c] == kSent;
  return e;
}

// sum of one value a thread over the block; thread 0 adds it to *dst
__device__ __forceinline__ void block_add(int v, int32_t* dst) {
  __shared__ int part[kThreads / 32];
  v = __reduce_add_sync(0xFFFFFFFFu, v);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) part[warp] = v;
  __syncthreads();
  if (warp == 0) {
    int s = lane < kThreads / 32 ? part[lane] : 0;
    s = __reduce_add_sync(0xFFFFFFFFu, s);
    if (lane == 0 && s) atomicAdd(dst, s);
  }
  __syncthreads();  // part[] is reused by the next call
}

template <int K>
__global__ void __launch_bounds__(kThreads) insert_tail_kernel(Args a) {
  cg::grid_group grid = cg::this_grid();
  const int64_t tid = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t nthreads = (int64_t)gridDim.x * blockDim.x;
  const bool lead = tid == 0;
  const int64_t npend = *a.npend;
  if (lead) {
    a.cnt[0] = 0;
    a.cnt[1] = 0;
  }
  int64_t rounds = 0, failed = 0;
  uint32_t g = 0;  // rounds run so far over all chunks: the counter parity
  for (int64_t base = 0; base < npend; base += a.cw) {
    const int64_t n = npend - base < a.cw ? npend - base : a.cw;
    for (int r = 0;; ++g) {
      const uint32_t tri = (uint32_t)((r * (r + 1)) >> 1);
      // ---- phase A: probe, resolve duplicates, bid for empty slots
      for (int64_t j = tid; j < n; j += nthreads) {
        if (r > 0 && a.state[j] != kPending) continue;
        uint32_t key[K], w[K];
        load_key<K>(a, base + j, key);
        const uint32_t s = slot_of<K>(key, tri, a.capm);
        load_slot<K>(a.tab, s, w);
        uint8_t st = kPending;
        if (is_empty<K>(w)) {
          atomicMin(a.claims + s, a.ids[base + j]);
          st = kBid;
        } else if (is_key<K>(w, key)) {
          st = kDone;
        }
        a.state[j] = st;
      }
      grid.sync();
      // ---- phase B: the lowest bid of a slot writes its key
      if (lead) a.cnt[(g + 1) & 1] = 0;  // read by all before phase A
      for (int64_t j = tid; j < n; j += nthreads) {
        if (a.state[j] != kBid) continue;
        uint32_t key[K];
        load_key<K>(a, base + j, key);
        const uint32_t s = slot_of<K>(key, tri, a.capm);
        const int32_t id = a.ids[base + j];
        if (__ldcg(a.claims + s) == id) {
          if constexpr (K == 2) {
            *reinterpret_cast<uint2*>(a.tab + 2 * (size_t)s) =
                make_uint2(key[0], key[1]);
          } else {
#pragma unroll
            for (int c = 0; c < K; ++c) a.tab[(size_t)K * s + c] = key[c];
          }
          a.is_new[id] = 1;
          a.state[j] = kWon;
        } else {
          a.state[j] = kLost;
        }
      }
      grid.sync();
      // ---- phase C: winners clear their bid, losers re-read, count
      int pend = 0;
      for (int64_t j = tid; j < n; j += nthreads) {
        const uint8_t st = a.state[j];
        if (st == kPending) {
          ++pend;
        } else if (st == kWon || st == kLost) {
          uint32_t key[K];
          load_key<K>(a, base + j, key);
          const uint32_t s = slot_of<K>(key, tri, a.capm);
          if (st == kWon) {
            a.claims[s] = kNoLane;
            a.state[j] = kDone;
          } else {
            uint32_t w[K];
            load_slot<K>(a.tab, s, w);
            const bool hit = is_key<K>(w, key);
            a.state[j] = hit ? kDone : kPending;
            pend += !hit;
          }
        }
      }
      block_add(pend, a.cnt + (g & 1));
      grid.sync();
      const int left = __ldcg(a.cnt + (g & 1));
      ++r;
      if (left == 0 || r >= a.max_probes) {
        rounds += r;
        failed += left;
        ++g;
        break;
      }
    }
  }
  if (lead) {
    a.stats[0] = rounds;
    a.stats[1] = failed;
  }
}

// co-resident blocks of each instantiation on each device (0 = unknown)
constexpr int kMaxDevices = 64;
int g_max_blocks[2][kMaxDevices];

template <int K>
cudaError_t launch(const Args& a, int64_t grid_cap, cudaStream_t stream) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  int& max_blocks = g_max_blocks[K - 2][dev];
  if (max_blocks == 0) {
    int coop = 0, sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
    if (err != cudaSuccess) return err;
    if (!coop) return cudaErrorNotSupported;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, insert_tail_kernel<K>, kThreads, 0);
    if (err != cudaSuccess) return err;
    if (per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;
    max_blocks = per_sm * sms;
  }
  // no more threads than a chunk has lanes: fewer blocks meet sooner at
  // the barriers
  const int64_t want = (grid_cap + kThreads - 1) / kThreads;
  const unsigned blocks =
      (unsigned)(want < 1 ? 1 : (want < max_blocks ? want : max_blocks));
  void* params[] = {const_cast<Args*>(&a)};
  return cudaLaunchCooperativeKernel((const void*)insert_tail_kernel<K>,
                                     dim3(blocks), dim3(kThreads), params, 0,
                                     stream);
}

}  // namespace

// tab: u32[cap + 1][k] slot-major table (8-byte aligned when k == 2);
// q*: u32 survivor keys (q2 null when k == 2), ids: i32 lane ids, both
// >= *npend long; npend: i64 device scalar; claims: i32[cap + 1], all
// 0x7FFFFFFF; is_new: u8, zeroed, longer than the largest id; state:
// u8[cw]; cnt: i32[2]; stats: i64[2] <- (probe rounds, failed lanes).
// grid_cap: the most lanes a chunk can hold (min(cw, lanes)).  Returns
// the launch's cudaError_t: a refused cooperative launch is an error.
extern "C" int ptt_insert_tail(void* tab, const void* q0, const void* q1,
                               const void* q2, const void* ids,
                               const void* npend, void* claims, void* is_new,
                               void* state, void* cnt, void* stats,
                               int64_t cw, uint32_t capm, int k,
                               int max_probes, int64_t grid_cap,
                               void* stream) {
  Args a;
  a.tab = (uint32_t*)tab;
  a.q0 = (const uint32_t*)q0;
  a.q1 = (const uint32_t*)q1;
  a.q2 = (const uint32_t*)q2;
  a.ids = (const int32_t*)ids;
  a.npend = (const int64_t*)npend;
  a.claims = (int32_t*)claims;
  a.is_new = (uint8_t*)is_new;
  a.state = (uint8_t*)state;
  a.cnt = (int32_t*)cnt;
  a.stats = (int64_t*)stats;
  a.cw = cw;
  a.capm = capm;
  a.max_probes = max_probes;
  const cudaError_t err = k == 3 ? launch<3>(a, grid_cap, (cudaStream_t)stream)
               : launch<2>(a, grid_cap, (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
