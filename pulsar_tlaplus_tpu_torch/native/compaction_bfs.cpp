// TLC-class native baseline: explicit-state BFS model checker for the
// `compaction` spec (specs/compaction.tla), written the way a
// tuned CPU checker would be — packed POD states, 64-bit fingerprints
// in an open-addressing table (TLC's FPSet regime), level-synchronous
// BFS with optional worker threads sharding the fingerprint space.
//
// Purpose: with no JVM at hand, 8-worker TLC cannot be measured
// directly; this is the stand-in for "a fast native CPU checker of the
// same spec" against which the card engine's states/sec is compared.
// Semantics mirror the port's Python oracle
// (pulsar_tlaplus_tpu_torch/ref/pyeval.py) exactly; the shipped-config
// run is validated against the published 45,198-state / diameter-20
// oracle (compaction.tla:23) in tests/test_torch_native_baseline.py.
//
// State encoding (M <= 64): messages as (key,value) codes (ids are
// positions, compaction.tla:84-86); compacted ledgers as 64-bit
// position bitmaps over the immutable message sequence (entries of a
// compacted ledger are original messages, compaction.tla:107-119);
// phaseOneResult's latestForKey map is derived from (messages,
// readPosition) on demand (compaction.tla:97-98).
//
// Build: g++ -O2 -std=c++17 -pthread compaction_bfs.cpp -o compaction_bfs
// Run:   ./compaction_bfs M K V C crash producer retain budget_s threads

#include <atomic>
#include <chrono>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <mutex>
#include <thread>
#include <vector>

struct Cfg {
  int M, K, V, C, max_crash;
  bool producer, retain, consumer = false;
};

static Cfg cfg;

enum Phase {
  PHASE_ONE = 0,
  P2_WRITE,
  P2_UPDATE_CONTEXT,
  P2_UPDATE_HORIZON,
  P2_PERSIST_CURSOR,
  P2_DELETE_LEDGER
};

struct State {
  uint8_t msg[64];  // code = key * (V+1) + val; zero beyond mlen
  uint64_t led[3];  // position bitmaps (1-based position p -> bit p-1)
  uint8_t led_live; // presence bits (a live ledger may be empty)
  uint8_t mlen, cstate, crash, consume, horizon, context;
  uint8_t has_p1, p1_read, has_cur, cur_h, cur_ctx;

  bool operator==(const State &o) const {
    return std::memcmp(this, &o, sizeof(State)) == 0;
  }
};

static inline int msg_key(const State &s, int pos1) { // 1-based
  return s.msg[pos1 - 1] / (cfg.V + 1);
}
static inline int msg_val(const State &s, int pos1) {
  return s.msg[pos1 - 1] % (cfg.V + 1);
}

// MaxCompactedLedgerId (compaction.tla:103-106): highest live slot, 1-based.
static inline int max_ledger_id(const State &s) {
  int mx = 0;
  for (int i = 0; i < cfg.C; i++)
    if (s.led_live >> i & 1) mx = i + 1;
  return mx;
}

// 64-bit fingerprint over the canonical bytes (splitmix64 mixing).
static inline uint64_t fingerprint(const State &s) {
  const uint64_t *p = reinterpret_cast<const uint64_t *>(&s);
  size_t words = sizeof(State) / 8;
  uint64_t h = 0x9e3779b97f4a7c15ULL;
  for (size_t i = 0; i < words; i++) {
    uint64_t x = p[i] + h + 0xbf58476d1ce4e5b9ULL * (i + 1);
    x = (x ^ (x >> 30)) * 0xbf58476d1ce4e5b9ULL;
    x = (x ^ (x >> 27)) * 0x94d049bb133111ebULL;
    h = (h ^ x ^ (x >> 31)) * 0x2545f4914f6cdd1dULL;
  }
  return h ? h : 1; // 0 is the empty marker
}

// --- invariants (compaction.tla:236-274; defaults of the shipped cfg) ---

static bool type_safe(const State &s) {
  for (int i = 1; i <= s.mlen; i++) {
    int k = msg_key(s, i), v = msg_val(s, i);
    if (k < 0 || k > cfg.K || v < 0 || v > cfg.V) return false;
  }
  for (int j = 0; j < cfg.C; j++) {
    if (!(s.led_live >> j & 1)) continue;
    uint64_t bm = s.led[j];
    while (bm) {
      int pos = __builtin_ctzll(bm) + 1;
      bm &= bm - 1;
      if (pos < 1 || pos > s.mlen) return false;
      int k = msg_key(s, pos), v = msg_val(s, pos);
      if (k < 0 || k > cfg.K || v < 0 || v > cfg.V) return false;
    }
  }
  if (s.has_p1 && !(1 <= s.p1_read && s.p1_read <= s.mlen)) return false;
  if (s.cstate > 5) return false;
  if (s.horizon > cfg.M || s.context > cfg.C) return false;
  if (s.crash > cfg.max_crash) return false;
  if (s.has_cur &&
      !(1 <= s.cur_h && s.cur_h <= cfg.M && 1 <= s.cur_ctx &&
        s.cur_ctx <= cfg.C))
    return false;
  return true;
}

static bool horizon_correct(const State &s) {
  if (s.horizon == 0) return true; // lazy guard (compaction.tla:259-274)
  uint64_t bm = 0;
  if (s.context >= 1 && (s.led_live >> (s.context - 1) & 1))
    bm = s.led[s.context - 1];
  // per-key max position present in the ledger (ids are positions)
  int maxpos[16] = {0};
  uint64_t b = bm;
  while (b) {
    int pos = __builtin_ctzll(b) + 1;
    b &= b - 1;
    int k = msg_key(s, pos);
    if (pos > maxpos[k]) maxpos[k] = pos;
  }
  for (int i = 1; i <= s.horizon; i++) {
    int k = msg_key(s, i);
    if (k == 0 && !cfg.retain) continue;
    if (maxpos[k] < i) return false;
  }
  return true;
}

// --- successor generation (compaction.tla:216-231) ---

template <typename Fn> static void successors(const State &s, Fn emit) {
  int n = s.mlen;
  if (cfg.producer && n < cfg.M) { // Producer (compaction.tla:83-87)
    for (int k = 0; k <= cfg.K; k++)
      for (int v = 0; v <= cfg.V; v++) {
        State t = s;
        t.msg[n] = (uint8_t)(k * (cfg.V + 1) + v);
        t.mlen = (uint8_t)(n + 1);
        emit(t);
      }
  }
  if (s.cstate == PHASE_ONE && !s.has_p1 && n > 0) { // PhaseOne (:93-100)
    State t = s;
    t.has_p1 = 1;
    t.p1_read = (uint8_t)n;
    t.cstate = P2_WRITE;
    emit(t);
  }
  if (s.has_p1 && s.cstate == P2_WRITE) { // PhaseTwoWrite (:121-132)
    int new_id = max_ledger_id(s) + 1;
    if (new_id <= cfg.C) {
      // CompactMessages (:107-119): latest-per-key over the snapshot
      // prefix, null keys kept per RetainNullKey
      int latest[16] = {0};
      for (int i = 1; i <= s.p1_read; i++) {
        int k = msg_key(s, i);
        if (k != 0) latest[k] = i;
      }
      uint64_t bm = 0;
      for (int i = 1; i <= s.p1_read; i++) {
        int k = msg_key(s, i);
        if (k == 0 ? cfg.retain : latest[k] == i) bm |= 1ULL << (i - 1);
      }
      State t = s;
      t.led[new_id - 1] = bm;
      t.led_live |= (uint8_t)(1 << (new_id - 1));
      t.cstate = P2_UPDATE_CONTEXT;
      emit(t);
    }
  }
  if (s.cstate == P2_UPDATE_CONTEXT) { // (:135-139)
    State t = s;
    t.context = (uint8_t)max_ledger_id(s);
    t.cstate = P2_UPDATE_HORIZON;
    emit(t);
  }
  if (s.cstate == P2_UPDATE_HORIZON) { // (:141-145)
    State t = s;
    t.horizon = s.p1_read;
    t.cstate = P2_PERSIST_CURSOR;
    emit(t);
  }
  if (s.cstate == P2_PERSIST_CURSOR) { // (:147-151)
    State t = s;
    t.has_cur = 1;
    t.cur_h = s.horizon;
    t.cur_ctx = s.context;
    t.cstate = P2_DELETE_LEDGER;
    emit(t);
  }
  if (s.cstate == P2_DELETE_LEDGER) { // (:153-165)
    int max_id = max_ledger_id(s);
    State t = s;
    if (max_id >= 2 && (s.led_live >> (max_id - 2) & 1)) {
      t.led[max_id - 2] = 0;
      t.led_live &= (uint8_t)~(1 << (max_id - 2));
    }
    t.cstate = PHASE_ONE;
    t.has_p1 = 0;
    t.p1_read = 0;
    emit(t);
  }
  if (s.crash < cfg.max_crash) { // BrokerCrash (:169-182)
    State t = s;
    t.crash = (uint8_t)(s.crash + 1);
    t.cstate = PHASE_ONE;
    t.has_p1 = 0;
    t.p1_read = 0;
    t.horizon = s.has_cur ? s.cur_h : 0;
    t.context = s.has_cur ? s.cur_ctx : 0;
    emit(t);
  }
  // Consumer / Terminating are stutters (dedup drops them).
}

// --- fingerprint set: open addressing, linear probing, CAS inserts ---
// Lock-free: a probe chain may cross any slot, so per-slot CAS is the
// only sound sharing discipline (striped locks cannot cover a chain).

struct FpSet {
  std::vector<std::atomic<uint64_t>> tab;
  uint64_t mask;
  std::atomic<size_t> count{0};
  size_t high_water; // stop before load factor ~0.85: probe chains
                     // degrade and a full table would probe forever

  explicit FpSet(size_t cap_log2)
      : tab(1ULL << cap_log2), mask((1ULL << cap_log2) - 1),
        high_water(((1ULL << cap_log2) / 20) * 17) {
    for (auto &slot : tab) slot.store(0, std::memory_order_relaxed);
  }
  bool nearly_full() const {
    return count.load(std::memory_order_relaxed) >= high_water;
  }
  // returns true if newly inserted
  bool insert(uint64_t fp) {
    for (size_t i = fp & mask;; i = (i + 1) & mask) {
      uint64_t cur = tab[i].load(std::memory_order_relaxed);
      if (cur == fp) return false;
      if (cur == 0) {
        uint64_t expect = 0;
        if (tab[i].compare_exchange_strong(expect, fp,
                                           std::memory_order_relaxed)) {
          count.fetch_add(1, std::memory_order_relaxed);
          return true;
        }
        if (expect == fp) return false; // raced with same fingerprint
        // raced with a different fp: fall through, keep probing at i
        if (tab[i].load(std::memory_order_relaxed) == fp) return false;
      }
    }
  }
};

int main(int argc, char **argv) {
  if (argc < 9) {
    std::fprintf(
        stderr,
        "usage: %s M K V C crash producer retain budget_s [threads] "
        "[table_log2]\n",
        argv[0]);
    return 2;
  }
  cfg.M = std::atoi(argv[1]);
  cfg.K = std::atoi(argv[2]);
  cfg.V = std::atoi(argv[3]);
  cfg.C = std::atoi(argv[4]);
  cfg.max_crash = std::atoi(argv[5]);
  cfg.producer = std::atoi(argv[6]) != 0;
  cfg.retain = std::atoi(argv[7]) != 0;
  double budget_s = std::atof(argv[8]);
  int nthreads = argc > 9 ? std::atoi(argv[9]) : 1;
  if (cfg.M > 64 || cfg.K > 15 || cfg.C > 3) {
    std::fprintf(stderr, "config out of encoding range\n");
    return 2;
  }

  auto t0 = std::chrono::steady_clock::now();
  auto elapsed = [&] {
    return std::chrono::duration<double>(std::chrono::steady_clock::now() -
                                         t0)
        .count();
  };

  int table_log2 = argc > 10 ? std::atoi(argv[10])
                            : (cfg.producer ? 27 : 22);
  FpSet seen((size_t)table_log2);
  std::atomic<bool> violated{false};
  std::vector<State> frontier, next;
  State z;
  std::memset(&z, 0, sizeof z);

  // Init (compaction.tla:188-202)
  if (cfg.producer) {
    seen.insert(fingerprint(z));
    frontier.push_back(z);
  } else {
    int codes = (cfg.K + 1) * (cfg.V + 1);
    std::vector<int> digit(cfg.M, 0);
    for (;;) {
      State s = z;
      s.mlen = (uint8_t)cfg.M;
      for (int i = 0; i < cfg.M; i++) s.msg[i] = (uint8_t)digit[i];
      if (seen.insert(fingerprint(s))) frontier.push_back(s);
      int d = 0;
      while (d < cfg.M && ++digit[d] == codes) digit[d++] = 0;
      if (d == cfg.M) break;
    }
  }
  for (auto &s : frontier)
    if (!type_safe(s) || !horizon_correct(s)) violated = true;

  size_t levels = 1;
  std::atomic<bool> truncated{false};

  while (!frontier.empty() && !truncated && !violated.load()) {
    next.clear();
    if (nthreads <= 1) {
      for (size_t fi = 0; fi < frontier.size(); fi++) {
        successors(frontier[fi], [&](const State &t) {
          if (seen.insert(fingerprint(t))) {
            if (!type_safe(t) || !horizon_correct(t)) violated = true;
            next.push_back(t);
          }
        });
        if ((fi & 1023) == 0 &&
            (elapsed() > budget_s || seen.nearly_full())) {
          truncated = true;
          break;
        }
      }
    } else {
      std::vector<std::vector<State>> outs(nthreads);
      std::atomic<size_t> cursor{0};
      std::vector<std::thread> ws;
      for (int w = 0; w < nthreads; w++)
        ws.emplace_back([&, w] {
          for (;;) {
            size_t i = cursor.fetch_add(256);
            if (i >= frontier.size() || truncated) break;
            size_t end = std::min(i + 256, frontier.size());
            for (; i < end; i++)
              successors(frontier[i], [&](const State &t) {
                if (seen.insert(fingerprint(t))) {
                  if (!type_safe(t) || !horizon_correct(t)) violated = true;
                  outs[w].push_back(t);
                }
              });
            if (elapsed() > budget_s || seen.nearly_full())
              truncated = true;
          }
        });
      for (auto &th : ws) th.join();
      for (auto &o : outs)
        next.insert(next.end(), o.begin(), o.end());
    }
    if (!next.empty()) {
      levels++;
      // per-level profile on stderr: ground truth for the device
      // engine's level accounting (a run cut by its state cap stops
      // mid-level, so its per-level "+N" lines cannot be read as full
      // level sizes — this is the authoritative source).  The empty-
      // frontier iteration is skipped so each level prints exactly once.
      std::fprintf(stderr,
                   "{\"level\": %zu, \"new\": %zu, \"cum\": %zu, "
                   "\"wall_s\": %.3f, \"complete\": %s}\n",
                   levels, next.size(), seen.count.load(), elapsed(),
                   truncated ? "false" : "true");
    }
    frontier.swap(next);
  }

  double dt = elapsed();
  size_t n = seen.count.load();
  std::printf("{\"distinct_states\": %zu, \"levels\": %zu, \"wall_s\": %.3f, "
              "\"states_per_sec\": %.1f, \"truncated\": %s, "
              "\"violated\": %s, \"threads\": %d}\n",
              n, levels, dt, n / (dt > 0 ? dt : 1e-9),
              truncated.load() ? "true" : "false",
              violated ? "true" : "false",
              nthreads);
  return violated ? 1 : 0;
}
