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
// s_r = (h + r(r+1)/2) & capm of the slot-major table tab[cap + 1][K]:
//
//   A_r  the slot holds the lane's key: resolved (a duplicate); the
//        slot is empty: the lane bids atomicMin(claims[s_r], id)
//        (round 0 of a grid chunk bids otherwise, below);
//   B_r  a bidder whose id is claims[s_r] won: it writes its key to the
//        slot and flags is_new[id]; the others lost;
//   C_r  a winner resets claims[s_r]; a loser re-reads the slot and
//        resolves if it now holds its key.  The lanes still pending
//        after C_r are round r + 1's set P_{r+1}.
//
// Exactness.  Every read of a phase must see every write of the phase
// before, as the plain loop's whole-batch ops do; then the winners, the
// table slot for slot (slot cap, the plain loop's write-only trash row,
// is never touched here), is_new and the round and failure counts are
// the plain loop's.  C_r and A_{r+1} run as one phase: the table is
// written only in B, so the merged phase reads one fixed table, and a
// slot whose bid C_r clears already holds the winner's key, so no lane
// bids on it in A_{r+1}: clears and fresh bids never touch one word.
// A round therefore ends in two barriers, not three.  The round's count
// is |P_{r+1}|, counted before the lanes' probe of round r + 1 and read
// after the barrier, so the chunk ends exactly where the plain loop's
// `while r < max_probes and pending.any()` does; no lane probes round
// max_probes.  Bids are an atomicMin of lane ids, so a round's outcome
// depends only on its set of active lanes and the fixed table, never on
// their order.
//
// Bound on the card: random 32-byte sectors, as for K1 (member.cu):
// each probe reads one random slot of a table far larger than the 50 MB
// L2, and a bid, a win and a clear each touch one more random word of
// claims.  Round 0, which holds every lane, is most of the time; the
// set of active lanes then shrinks about geometrically (by the table's
// load a round), so after a few rounds a grid barrier (a few us) costs
// more than the round's work.  Design:
//
//   * round 0 of a chunk bids in the slots, not in claims: A_0 only
//     reads; a bidder then takes atomicMin of its id on the empty
//     slot's first word (SENTINEL, above every id), reads it back after
//     a barrier to learn whether it won, and writes its key after one
//     more (a loser's read must not meet a winner's key, whose first
//     word could equal the loser's id).  Two more barriers, and no
//     claims word touched by the bulk of the lanes;
//   * grid rounds: the active lanes of round r + 1 are appended to one
//     of two lists by the parity of r + 1 (one atomicAdd a block; the
//     list's counter is the round's count), so a round touches only
//     live lanes.  An entry holds the lane's key words, id and state as
//     rows of the list, so a round reads its lanes coalesced, by list
//     position, never gathered by lane; round 0 reads the chunk's lanes
//     in place and keeps their states in list 0's state row.  Blocks of
//     kThreads = 1,024 threads, as many as are co-resident (one an SM);
//   * the block-local tail: once a chunk's count is at most kTail
//     (a chunk of at most kTail lanes from its start), block 0 stages
//     the active lanes' keys, ids and states in shared memory and runs
//     the chunk's remaining rounds with __syncthreads() in place of
//     grid barriers; the other blocks wait at one grid barrier that
//     ends the chunk (none after the last chunk), so the next chunk
//     sees the whole table;
//   * a K = 2 slot is one aligned uint2 load (K = 3 three words); the
//     table, bids and lists are read through L2 (__ldcg): other blocks
//     wrote them before the last barrier.
//
// kThreads and kTail were picked on the card by
// scripts/torch_kernel_ab.py's sweep (PERF.md); -DPTT_H1_THREADS and
// -DPTT_H1_TAIL build the other points of the sweep.
#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

#ifndef PTT_H1_THREADS
#define PTT_H1_THREADS 1024
#endif
#ifndef PTT_H1_TAIL
#define PTT_H1_TAIL 2048
#endif

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
constexpr int kThreads = PTT_H1_THREADS;
constexpr int kTail = PTT_H1_TAIL;  // most lanes the block-local tail takes
static_assert(kThreads % 32 == 0 && kThreads <= 1024, "block width");
static_assert(kTail >= 1 && kTail < (1 << 24), "tail width");

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
  int32_t* lists;          // [2][K + 2][cw] scratch: the active lanes'
                           // key words, ids and states, rows of a list
  int32_t* cnt;            // [2] scratch: list lengths
  int64_t* stats;          // [4] out: probe rounds, failed lanes, grid
                           // rounds, grid barriers
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

// list p (0 or 1): row c < K holds key word c of each entry, row K the
// lane id, row K + 1 the state
template <int K>
__device__ __forceinline__ int32_t* list_at(const Args& a, int p) {
  return a.lists + (int64_t)p * (K + 2) * a.cw;
}

// the key and id of entry i of round r's active set L: the chunk's lane
// base + i in round 0, else L's entry i
template <int K>
__device__ __forceinline__ int32_t entry(const Args& a, int64_t base,
                                         const int32_t* L, int r, int64_t i,
                                         uint32_t (&key)[K]) {
  if (r == 0) {
    load_key<K>(a, base + i, key);
    return __ldg(a.ids + base + i);
  }
#pragma unroll
  for (int c = 0; c < K; ++c) key[c] = (uint32_t)__ldcg(L + c * a.cw + i);
  return __ldcg(L + K * a.cw + i);
}

template <int K>
__device__ __forceinline__ uint32_t hash_of(const uint32_t (&key)[K]) {
  uint32_t h = fmix32(key[0] ^ 0x9E3779B9u);
#pragma unroll
  for (int c = 1; c < K; ++c) h = fmix32(h ^ key[c]);
  return h;
}

__device__ __forceinline__ uint32_t slot_at(uint32_t h, int r,
                                            uint32_t capm) {
  return (h + (uint32_t)((r * (r + 1)) >> 1)) & capm;
}

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

// A_r of one lane: its state after the probe (kBid for an empty slot,
// with the bid made in claims unless the round bids in the slot itself)
template <int K>
__device__ __forceinline__ uint8_t probe(const Args& a,
                                         const uint32_t (&key)[K],
                                         uint32_t h, int r, int32_t id,
                                         bool bid = true) {
  const uint32_t s = slot_at(h, r, a.capm);
  uint32_t w[K];
  load_slot<K>(a.tab, s, w);
  if (is_empty<K>(w)) {
    if (bid) atomicMin(a.claims + s, id);
    return kBid;
  }
  return is_key<K>(w, key) ? kDone : kPending;
}

// a won slot gets its key, and the lane's is_new flag
template <int K>
__device__ __forceinline__ void put_key(const Args& a,
                                        const uint32_t (&key)[K],
                                        uint32_t s, int32_t id) {
  if constexpr (K == 2) {
    *reinterpret_cast<uint2*>(a.tab + 2 * (size_t)s) =
        make_uint2(key[0], key[1]);
  } else {
#pragma unroll
    for (int c = 0; c < K; ++c) a.tab[(size_t)K * s + c] = key[c];
  }
  a.is_new[id] = 1;
}

// B_r of a bidder: kWon (its key written, is_new flagged) or kLost
template <int K>
__device__ __forceinline__ uint8_t claim(const Args& a,
                                         const uint32_t (&key)[K],
                                         uint32_t h, int r, int32_t id) {
  const uint32_t s = slot_at(h, r, a.capm);
  if (__ldcg(a.claims + s) != id) return kLost;
  put_key<K>(a, key, s, id);
  return kWon;
}

// C_r of a lane in state st: a winner clears its bid (when it bid in
// claims), a loser re-reads its slot; true while the lane is still
// pending
template <int K>
__device__ __forceinline__ bool settle(const Args& a, uint8_t st,
                                       const uint32_t (&key)[K], uint32_t h,
                                       int r, bool claimed = true) {
  if (st == kWon) {
    if (claimed) a.claims[slot_at(h, r, a.capm)] = kNoLane;
    return false;
  }
  if (st == kLost) {
    uint32_t w[K];
    load_slot<K>(a.tab, slot_at(h, r, a.capm), w);
    return !is_key<K>(w, key);
  }
  return st == kPending;
}

// append the entry (key, id, st) to list L (length *cnt) where pend,
// one atomicAdd a block (one a warp, all on one counter, doubled the
// time of a 200k-lane round on the card): every thread of the block
// calls it together
template <int K>
__device__ __forceinline__ void append(bool pend, const uint32_t (&key)[K],
                                       int32_t id, uint8_t st, int32_t* L,
                                       int64_t cw, int32_t* cnt) {
  __shared__ int woff[kThreads / 32];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const unsigned m = __ballot_sync(0xFFFFFFFFu, pend);
  if (lane == 0) woff[warp] = __popc(m);
  __syncthreads();
  if (warp == 0) {
    const int c = lane < kThreads / 32 ? woff[lane] : 0;
    int incl = c;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(0xFFFFFFFFu, incl, d);
      if (lane >= d) incl += y;
    }
    int b = 0;
    if (lane == 31 && incl) b = atomicAdd(cnt, incl);
    b = __shfl_sync(0xFFFFFFFFu, b, 31);
    if (lane < kThreads / 32) woff[lane] = b + incl - c;
  }
  __syncthreads();
  if (pend) {
    const int64_t i = woff[warp] + __popc(m & ((1u << lane) - 1u));
#pragma unroll
    for (int c = 0; c < K; ++c) L[c * cw + i] = (int32_t)key[c];
    L[K * cw + i] = id;
    L[(K + 1) * cw + i] = st;
  }
  __syncthreads();  // woff is reused by the next call
}

// The block-local tail of a chunk at offset base: the np (<= kTail)
// lanes of round r's active set — the chunk's lanes when fresh (A_r not
// yet run), else list r & 1's entries with their A_r states — run the
// chunk's remaining rounds in this block alone.  Leaves r = the chunk's
// round count and np = its failed lanes.
template <int K>
__device__ void tail(const Args& a, int64_t base, int& r, int64_t& np,
                     bool fresh) {
  extern __shared__ uint32_t smem[];
  uint32_t* skey = smem;                                   // [K][kTail]
  int32_t* sid = reinterpret_cast<int32_t*>(smem + K * kTail);  // [kTail]
  uint8_t* sst = reinterpret_cast<uint8_t*>(sid + kTail);       // [kTail]
  __shared__ int scnt[2];
  const int t = threadIdx.x;
  const int n = (int)np;
  const int32_t* L = list_at<K>(a, r & 1);
  for (int i = t; i < n; i += kThreads) {
    uint32_t key[K];
    const int32_t id = entry<K>(a, base, L, fresh ? 0 : r, i, key);
#pragma unroll
    for (int c = 0; c < K; ++c) skey[c * kTail + i] = key[c];
    sid[i] = id;
    sst[i] = fresh ? probe<K>(a, key, hash_of<K>(key), r, id)
                   : (uint8_t)__ldcg(L + (K + 1) * a.cw + i);
  }
  __syncthreads();
  for (;;) {
    // B_r
    for (int i = t; i < n; i += kThreads) {
      if (sst[i] != kBid) continue;
      uint32_t key[K];
#pragma unroll
      for (int c = 0; c < K; ++c) key[c] = skey[c * kTail + i];
      sst[i] = claim<K>(a, key, hash_of<K>(key), r, sid[i]);
    }
    if (t == 0) scnt[(r + 1) & 1] = 0;  // last read two rounds ago
    __syncthreads();
    // C_r + A_{r+1}
    const bool more = r + 1 < a.max_probes;
    int pend = 0;
    for (int i = t; i < n; i += kThreads) {
      const uint8_t st = sst[i];
      if (st == kDone) continue;
      uint32_t key[K];
#pragma unroll
      for (int c = 0; c < K; ++c) key[c] = skey[c * kTail + i];
      const uint32_t h = hash_of<K>(key);
      if (settle<K>(a, st, key, h, r)) {
        ++pend;
        sst[i] = more ? probe<K>(a, key, h, r + 1, sid[i]) : (uint8_t)kPending;
      } else {
        sst[i] = kDone;
      }
    }
    pend = __reduce_add_sync(0xFFFFFFFFu, pend);
    if ((t & 31) == 0 && pend) atomicAdd(&scnt[(r + 1) & 1], pend);
    __syncthreads();
    np = scnt[(r + 1) & 1];
    ++r;
    if (np == 0 || r >= a.max_probes) return;
  }
}

template <int K>
__global__ void __launch_bounds__(kThreads) insert_tail_kernel(Args a) {
  cg::grid_group grid = cg::this_grid();
  const int64_t tid = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t nthreads = (int64_t)gridDim.x * blockDim.x;
  const bool lead = tid == 0;
  const int64_t npend = *a.npend;
  int64_t rounds = 0, failed = 0, grid_rounds = 0, barriers = 0;
  for (int64_t base = 0; base < npend; base += a.cw) {
    const int64_t n = npend - base < a.cw ? npend - base : a.cw;
    int r = 0;
    int64_t np = n;  // |P_r|
    bool fresh = true;  // A_r not yet run for P_r
    if (n > kTail && a.max_probes > 0) {
      // ---- round 0 bids in the slots (header): A_0 over every lane of
      // the chunk, states in list 0, no bid yet
      int32_t* st0 = list_at<K>(a, 0) + (K + 1) * a.cw;
      for (int64_t i = tid; i < n; i += nthreads) {
        uint32_t key[K];
        load_key<K>(a, base + i, key);
        st0[i] = probe<K>(a, key, hash_of<K>(key), 0,
                          __ldg(a.ids + base + i), false);
      }
      grid.sync();
      for (int64_t i = tid; i < n; i += nthreads) {  // bid
        if (__ldcg(st0 + i) != kBid) continue;
        uint32_t key[K];
        load_key<K>(a, base + i, key);
        atomicMin(a.tab + (size_t)K * slot_at(hash_of<K>(key), 0, a.capm),
                  (uint32_t)__ldg(a.ids + base + i));
      }
      grid.sync();
      for (int64_t i = tid; i < n; i += nthreads) {  // the lowest id won
        if (__ldcg(st0 + i) != kBid) continue;
        uint32_t key[K];
        load_key<K>(a, base + i, key);
        const uint32_t s = slot_at(hash_of<K>(key), 0, a.capm);
        st0[i] = __ldcg(a.tab + (size_t)K * s) ==
                         (uint32_t)__ldg(a.ids + base + i)
                     ? kWon : kLost;
      }
      grid.sync();
      barriers += 3;
      fresh = false;
      for (;;) {
        int32_t* L = list_at<K>(a, r & 1);  // P_r (its keys: the
        int32_t* Lst = L + (K + 1) * a.cw;  // chunk's lanes in round 0)
        int32_t* nxt = list_at<K>(a, (r + 1) & 1);
        int32_t* ncnt = a.cnt + ((r + 1) & 1);
        // ---- B_r: the lowest bid of a slot writes its key (round 0's
        // winners are known already)
        if (lead) *ncnt = 0;  // read by all after round r - 1
        for (int64_t i = tid; i < np; i += nthreads) {
          if (__ldcg(Lst + i) != (r ? kBid : kWon)) continue;
          uint32_t key[K];
          const int32_t id = entry<K>(a, base, L, r, i, key);
          const uint32_t h = hash_of<K>(key);
          if (r)
            Lst[i] = claim<K>(a, key, h, r, id);
          else
            put_key<K>(a, key, slot_at(h, 0, a.capm), id);
        }
        grid.sync();
        // ---- C_r + A_{r+1}: settle, probe round r + 1, list P_{r+1}
        const bool more = r + 1 < a.max_probes;
        for (int64_t i0 = tid - threadIdx.x; i0 < np; i0 += nthreads) {
          const int64_t i = i0 + threadIdx.x;  // block-uniform loop
          bool pend = false;
          uint32_t key[K] = {};
          int32_t id = 0;
          uint8_t st = kPending;
          if (i < np) {
            st = (uint8_t)__ldcg(Lst + i);
            if (st != kDone) {
              id = entry<K>(a, base, L, r, i, key);
              const uint32_t h = hash_of<K>(key);
              pend = settle<K>(a, st, key, h, r, r > 0);
              st = pend && more ? probe<K>(a, key, h, r + 1, id)
                                : (uint8_t)kPending;
            }
          }
          append<K>(pend, key, id, st, nxt, a.cw, ncnt);
        }
        grid.sync();
        barriers += 2;
        ++grid_rounds;
        np = __ldcg(ncnt);
        ++r;
        if (np == 0 || r >= a.max_probes || np <= kTail) break;
      }
    }
    if (np > 0 && r < a.max_probes) {
      if (blockIdx.x == 0) tail<K>(a, base, r, np, fresh);
      if (base + a.cw < npend) {  // the next chunk sees the whole table
        grid.sync();
        ++barriers;
      }
    }
    rounds += r;
    failed += np;
  }
  if (lead) {
    a.stats[0] = rounds;
    a.stats[1] = failed;
    a.stats[2] = grid_rounds;
    a.stats[3] = barriers;
  }
}

constexpr size_t tail_smem(int k) {
  return (size_t)kTail * (4 * k + 4 + 1);
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
  const size_t smem = tail_smem(K);
  int& max_blocks = g_max_blocks[K - 2][dev];
  if (max_blocks == 0) {
    int coop = 0, sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
    if (err != cudaSuccess) return err;
    if (!coop) return cudaErrorNotSupported;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(insert_tail_kernel<K>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, insert_tail_kernel<K>, kThreads, smem);
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
                                     dim3(blocks), dim3(kThreads), params,
                                     smem, stream);
}

}  // namespace

// tab: u32[cap + 1][k] slot-major table (8-byte aligned when k == 2);
// q*: u32 survivor keys (q2 null when k == 2), ids: i32 lane ids, both
// >= *npend long; npend: i64 device scalar; claims: i32[cap + 1], all
// 0x7FFFFFFF; is_new: u8, zeroed, longer than the largest id; lists:
// i32[2][k + 2][cw]; cnt: i32[2]; stats: i64[4] <- (probe
// rounds, failed lanes, grid rounds, grid barriers).  grid_cap: the
// most lanes a chunk can hold (min(cw, lanes)).  Returns the launch's
// cudaError_t: a refused cooperative launch is an error.
extern "C" int ptt_insert_tail(void* tab, const void* q0, const void* q1,
                               const void* q2, const void* ids,
                               const void* npend, void* claims, void* is_new,
                               void* lists, void* cnt,
                               void* stats, int64_t cw, uint32_t capm, int k,
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
  a.lists = (int32_t*)lists;
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
