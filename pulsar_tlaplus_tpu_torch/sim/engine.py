"""Streaming walker-swarm simulation — TLC's ``-simulate`` as a budgeted
workload; the counterpart of ``pulsar_tlaplus_tpu/sim/engine.py``
(``SimulationResult``, ``StreamingSimulator``).

- **Segments.**  The host enqueues ``segment_len`` batched steps of all
  ``n_walkers`` walkers and reads the device once (a *host sync*): one
  small counter vector.  The host-side *epoch* counts segments.
- **Lockstep behaviors.**  Every walker starts a fresh behavior every
  ``depth`` steps (``segment_len`` is clamped to a divisor of ``depth``,
  so restarts land on segment boundaries).  One *round* is ``depth``
  steps after the fresh initial states; a finished round counts
  ``n_walkers`` walks.
- **Randomness** is a counter hash of ``(seed, stream, global step,
  walker)`` (``sim/rng.py``), never carried: the walk stream is
  deterministic given ``seed``, equal on the CPU and the card, and one
  walker's behavior replays alone.  A step picks uniformly among the
  enabled lanes plus the stutter lane, and stays put when nothing is
  enabled (the JAX engine's ``_step_one``), by an integer draw.
- **Counters** held on the device for a segment: stutter steps,
  enabled-lane evaluations, walker-steps with an invariant failure, the
  earliest violation's key ``code * B + walker`` (``code`` = 0 for a
  fresh initial state, ``2 i + 1`` after step ``i``) with its
  invariant, and the duplicate estimator's hits.  Steps, states and
  estimator attempts follow from ``B``, ``segment_len`` and the epoch.
- **Duplicate estimator** (advisory): the first ``dup_sample`` walkers'
  states hash (the JAX engine's fingerprint over its pytree leaves, bit
  for bit) into a small device table; the hit ratio estimates how much
  of the swarm revisits states.
- **Violation replay**: the earliest violating walker's behavior is
  replayed alone from its hash stream and re-verified state by state
  through single-state evaluation (lane enabled, successor equal, the
  invariant holding until the last state) — ``result.verified``.

Checkpoint frames, telemetry, tuned profiles and the daemon's sim jobs
are not ported.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import torch

from pulsar_tlaplus_tpu_torch.ops.dedup import U32, mul32
from pulsar_tlaplus_tpu_torch.ops.packing import smap, tree_leaves
from pulsar_tlaplus_tpu_torch.sim import rng
from pulsar_tlaplus_tpu_torch.utils import device as device_mod

# the segment's counter vector (int64), read once a segment
CTR_STUTTER = 0   # stutter lanes chosen
CTR_ENABLED = 1   # enabled-lane evaluations (lanes + stutter)
CTR_VIOL = 2      # walker-steps with >= 1 invariant failure
CTR_VKEY = 3      # min (code * B + walker); CLEAN when none
CTR_VINV = 4      # invariant index of the min key
CTR_DUP_HITS = 5  # duplicate-estimator hits (tag already present)
CTR_N = 6
CLEAN = 2**62


def _same(a, b) -> bool:
    """Two state trees hold equal tensors."""
    return all(torch.equal(x, y)
               for x, y in zip(tree_leaves(a), tree_leaves(b)))


@dataclass
class SimulationResult:
    """One simulation run (the JAX engine's record)."""

    n_walkers: int
    depth: int
    states_visited: int  # walkers x (steps + behavior starts), not distinct
    violation: Optional[str] = None
    trace: Optional[list] = None
    trace_actions: Optional[List[str]] = None
    steps: int = 0            # random steps taken across the swarm
    walks: int = 0            # completed behaviors (B per finished round)
    segments: int = 0         # segments run
    epoch: int = 0            # next segment index
    wall_s: float = 0.0
    stop_reason: Optional[str] = None
    steps_per_sec: float = 0.0
    walks_per_sec: float = 0.0
    states_per_sec: float = 0.0
    dup_ratio_est: Optional[float] = None  # advisory sampled estimate
    verified: Optional[bool] = None  # replayed behavior re-verified
    violation_walker: Optional[int] = None
    violation_step: Optional[int] = None  # global step of the bad state
    stats: Dict[str, object] = field(default_factory=dict)


class StreamingSimulator:
    """Continuous walker-swarm simulation of a batched model on one
    device (``cuda`` unless ``device`` names another; raises when CUDA
    is wanted and absent).

    Budgets (the run ends at whichever binds first): ``max_steps``
    (random steps across the swarm), ``max_rounds`` (behavior rounds),
    ``time_budget_s`` (wall clock).  With no budget the run is one
    round.
    """

    def __init__(
        self,
        model,
        invariants: Optional[Tuple[str, ...]] = None,
        n_walkers: int = 1024,
        depth: int = 64,
        segment_len: Optional[int] = None,
        seed: int = 0,
        max_steps: Optional[int] = None,
        max_rounds: Optional[int] = None,
        time_budget_s: Optional[float] = None,
        dup_sample: int = 256,
        dup_table_bits: int = 16,
        device=None,
        progress: bool = False,
    ):
        self.model = model
        if invariants is None:
            invariants = tuple(getattr(model, "default_invariants", ()))
        self.invariant_names = tuple(invariants)
        unknown = [n for n in self.invariant_names
                   if n not in model.invariants]
        if unknown:
            raise ValueError(f"unknown invariant(s): {unknown}")
        if depth < 1:
            raise ValueError(f"depth must be >= 1: {depth}")
        if n_walkers < 1:
            raise ValueError(f"n_walkers must be >= 1: {n_walkers}")
        if not 1 <= dup_table_bits <= 31:
            raise ValueError(f"dup_table_bits not in 1..31: {dup_table_bits}")
        self.device = device_mod.resolve(device)
        self.B = int(n_walkers)
        self.T = int(depth)
        want = int(segment_len) if segment_len else min(self.T, 32)
        want = max(1, min(want, self.T))
        while self.T % want:
            want -= 1
        self.L = want
        self.segs_per_round = self.T // self.L
        self.seed = int(seed)
        self.max_steps = max_steps
        self.max_rounds = max_rounds
        self.time_budget_s = time_budget_s
        if max_steps is None and max_rounds is None and time_budget_s is None:
            self.max_rounds = 1  # finite default: one behavior round
        self.S = max(1, min(int(dup_sample), self.B))
        self.dup_table_bits = int(dup_table_bits)
        self.progress = progress
        self.A = int(model.A)
        self._inv_fns = [model.invariants[n] for n in self.invariant_names]
        self._sampler = getattr(model, "sample_initial", None)
        if self._sampler is None and model.n_initial > 2**31 - 1:
            raise ValueError(
                f"n_initial = {model.n_initial} exceeds int32: the model "
                "must provide sample_initial(u) for simulation mode"
            )
        self.last_stats: Dict[str, object] = {}

    def _log(self, msg: str) -> None:
        if self.progress:
            import sys

            print(f"  {msg}", file=sys.stderr, flush=True)

    # ------------------------------------------------------ the steps

    def _init(self, g0: int, walkers: torch.Tensor):
        """Fresh initial states of ``walkers`` for the round starting at
        global step ``g0``."""
        key = rng.stream_key(self.seed, rng.INIT, g0)
        if self._sampler is not None:
            return self._sampler(rng.words(key, walkers,
                                           self.model.sample_width))
        idx = rng.below(rng.words(key, walkers), self.model.n_initial)
        return self.model.gen_initial(idx)

    def _step(self, states, g: int, walkers: torch.Tensor):
        """One random step of ``walkers`` at global step ``g``: (next
        states, lane in 0..A with A the stutter lane, enabled count)."""
        m = self.model
        succ, valid = m.successors(states)
        u = rng.words(rng.stream_key(self.seed, rng.STEP, g), walkers)
        lane, n_en = rng.pick_lane(u, valid, m.stutter_enabled(states))
        return self._take(states, succ, lane), lane, n_en

    def _take(self, states, succ, lane: torch.Tensor):
        """Each walker's successor at its ``lane`` (``[B]`` in 0..A; the
        stutter lane ``A`` keeps the state)."""
        stay = lane >= self.A
        pick = lane.clamp(max=self.A - 1)
        rows = torch.arange(lane.shape[0], device=lane.device)

        def take(cur, s):
            return torch.where(stay.view(-1, *([1] * (cur.dim() - 1))),
                               cur, s[rows, pick])

        return smap(take, states, succ)

    def _inv_ok(self, states) -> torch.Tensor:
        """bool ``[B, n_inv]``, True = satisfied."""
        return torch.stack([f(states) for f in self._inv_fns], dim=1)

    def _viol_update(self, ctrs: torch.Tensor, states, code: int) -> None:
        """Fold a batch's invariant results into the counters at
        violation code ``code``, in place (device ops only)."""
        if not self._inv_fns:
            return
        ok = self._inv_ok(states)
        bad = ~ok.all(dim=1)
        w = torch.where(bad, self._widx, CLEAN).amin()
        # a 1-element index: indexing by a 0-d tensor would read it
        # on the host
        inv = (~ok).to(torch.int32).argmax(dim=1).index_select(
            0, w.clamp(max=self.B - 1).view(1))[0]
        cand = torch.where(w < CLEAN, code * self.B + w, CLEAN)
        better = cand < ctrs[CTR_VKEY]
        ctrs[CTR_VIOL] += bad.sum()
        ctrs[CTR_VINV] = torch.where(better, inv.to(torch.int64),
                                     ctrs[CTR_VINV])
        ctrs[CTR_VKEY] = torch.minimum(cand, ctrs[CTR_VKEY])

    def _fingerprints(self, states_sub) -> torch.Tensor:
        """uint32 fingerprints (int64) of sampled states: the JAX
        engine's mix over the model's pytree leaves, bit for bit."""
        leaves = getattr(self.model, "fingerprint_leaves", list)(states_sub)
        n = leaves[0].shape[0]
        h = torch.zeros((n,), dtype=torch.int64, device=leaves[0].device)
        for leaf in leaves:
            x = leaf.reshape(n, leaf[0].numel()).to(torch.int64) & U32
            k = torch.arange(x.shape[1], dtype=torch.int64, device=x.device)
            mult = ((2 * k + 1) * 0x9E3779B9) & U32
            prod = ((((x * (mult >> 16)) & 0xFFFF) << 16)
                    + x * (mult & 0xFFFF)) & U32
            h = (mul32(h, 0x85EBCA6B) + prod.sum(dim=1)) & U32
        h = h ^ (h >> 16)
        h = mul32(h, 0x7FEB352D)
        return h ^ (h >> 15)

    def _dup_insert(self, table: torch.Tensor, states):
        """Hash the first ``S`` walkers into the estimator table (uint32
        tags in int64, updated in place); returns (table, hits).
        Walkers sharing a slot resolve deterministically: the last one's
        tag is written."""
        h = self._fingerprints(smap(lambda x: x[: self.S], states))
        idx = h >> (32 - self.dup_table_bits)
        tag = h | 1
        hits = (table[idx] == tag).sum()
        pos = torch.arange(self.S, dtype=torch.int64, device=h.device)
        last = torch.full_like(table, -1).scatter_reduce_(
            0, idx, pos, "amax")
        table[idx] = tag[last[idx]]
        return table, hits

    def _segment(self, states, table, epoch: int):
        """Run one segment: (states, table, counters on the device)."""
        dev = self.device
        ctrs = torch.zeros((CTR_N,), dtype=torch.int64, device=dev)
        ctrs[CTR_VKEY] = CLEAN
        g0 = epoch * self.L
        if epoch % self.segs_per_round == 0:
            states = self._init(g0, self._widx)
            self._viol_update(ctrs, states, 0)
            table, hits = self._dup_insert(table, states)
            ctrs[CTR_DUP_HITS] += hits
        for i in range(self.L):
            states, lane, n_en = self._step(states, g0 + i, self._widx)
            ctrs[CTR_STUTTER] += (lane >= self.A).sum()
            ctrs[CTR_ENABLED] += n_en.sum()
            self._viol_update(ctrs, states, 2 * i + 1)
            table, hits = self._dup_insert(table, states)
            ctrs[CTR_DUP_HITS] += hits
        return states, table, ctrs

    # ------------------------------------------------------------ run

    def run(self) -> SimulationResult:
        dev = self.device
        self._widx = torch.arange(self.B, dtype=torch.int64, device=dev)
        table = torch.zeros((1 << self.dup_table_bits,), dtype=torch.int64,
                            device=dev)
        states = None  # the first segment is a restart
        epoch = 0
        cum = dict(steps=0, states=0, violations=0, stutter=0, enabled=0,
                   dup_att=0, dup_hits=0, segments=0)
        self._syncs = 0
        t0 = time.time()
        self._log(f"simulation: {self.B} walkers, depth {self.T}, "
                  f"segment {self.L} step(s) on {dev}")
        stop_reason = None
        viol = None  # (epoch, code, walker, inv_idx)
        deadline = (None if self.time_budget_s is None
                    else time.monotonic() + self.time_budget_s)
        while True:
            if self.max_steps is not None and cum["steps"] >= self.max_steps:
                stop_reason = "step_budget"
                break
            if (self.max_rounds is not None
                    and cum["steps"] >= self.max_rounds * self.T * self.B):
                stop_reason = "round_budget"
                break
            if deadline is not None and time.monotonic() >= deadline:
                stop_reason = "time_budget"
                break
            restart = epoch % self.segs_per_round == 0
            states, table, ctrs = self._segment(states, table, epoch)
            c = ctrs.tolist()  # the one read a segment
            self._syncs += 1
            cum["segments"] += 1
            cum["steps"] += self.B * self.L
            cum["states"] += self.B * self.L + (self.B if restart else 0)
            cum["stutter"] += c[CTR_STUTTER]
            cum["enabled"] += c[CTR_ENABLED]
            cum["violations"] += c[CTR_VIOL]
            cum["dup_att"] += self.S * (self.L + (1 if restart else 0))
            cum["dup_hits"] += c[CTR_DUP_HITS]
            if c[CTR_VIOL] and c[CTR_VKEY] != CLEAN:
                viol = (epoch, c[CTR_VKEY] // self.B, c[CTR_VKEY] % self.B,
                        c[CTR_VINV])
                epoch += 1
                stop_reason = "violation"
                break
            epoch += 1
        res = self._mk_result(cum, epoch, t0, stop_reason)
        if viol is not None:
            self._attach_violation(res, viol)
        return res

    def _mk_result(self, cum, epoch, t0, stop_reason) -> SimulationResult:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        wall = max(time.time() - t0, 1e-9)
        walks = self.B * (cum["steps"] // (self.B * self.T))
        dup = (round(cum["dup_hits"] / cum["dup_att"], 6)
               if cum["dup_att"] else None)
        res = SimulationResult(
            n_walkers=self.B,
            depth=self.T,
            states_visited=cum["states"],
            steps=cum["steps"],
            walks=walks,
            segments=cum["segments"],
            epoch=epoch,
            wall_s=round(wall, 3),
            stop_reason=stop_reason,
            steps_per_sec=round(cum["steps"] / wall, 1),
            walks_per_sec=round(walks / wall, 2),
            states_per_sec=round(cum["states"] / wall, 1),
            dup_ratio_est=dup,
        )
        self.last_stats = dict(
            sim_steps=cum["steps"],
            sim_states=cum["states"],
            sim_walks=walks,
            sim_walkers=self.B,
            sim_violations=cum["violations"],
            sim_stutter_steps=cum["stutter"],
            sim_enabled_lanes=cum["enabled"],
            sim_dup_attempts=cum["dup_att"],
            sim_dup_hits=cum["dup_hits"],
            sim_dup_ratio_est=dup,
            sim_segments=cum["segments"],
            sim_epoch=epoch,
            walks_per_sec=res.walks_per_sec,
            steps_per_sec=res.steps_per_sec,
            host_syncs=self._syncs,
        )
        res.stats = self.last_stats
        return res

    # ------------------------------------------------ violation replay

    def _replay(self, walker: int, r0: int):
        """The behavior of ``walker`` from round start ``r0``: (initial
        state, the ``T`` states after each step, the lanes taken)."""
        w = torch.tensor([walker], dtype=torch.int64, device=self.device)
        s = s0 = self._init(r0, w)
        states, lanes = [], []
        for j in range(self.T):
            s, lane, _n = self._step(s, r0 + j, w)
            states.append(s)
            lanes.append(lane)
        return s0, states, torch.cat(lanes).tolist()

    def _attach_violation(self, res: SimulationResult, viol) -> None:
        epoch_v, code, walker, inv_idx = viol
        m = self.model
        res.violation = (self.invariant_names[inv_idx]
                         if self.invariant_names else None)
        res.violation_walker = walker
        g_state = epoch_v * self.L + code // 2  # the violating state's step
        is_init = code % 2 == 0
        r0 = (g_state // self.T) * self.T  # its behavior's round start
        n_steps = 0 if is_init else g_state - r0 + 1
        res.violation_step = None if is_init else g_state
        s0, states, lanes = self._replay(walker, r0)
        names = m.action_names
        trace = [m.to_pystate(s0)]
        actions: List[str] = []
        for step in range(n_steps):
            lane = lanes[step]
            if lane >= self.A:
                continue  # stutter: state unchanged, not in the trace
            trace.append(m.to_pystate(states[step]))
            actions.append(names[int(m.action_ids[lane])])
        res.trace = trace
        res.trace_actions = actions
        res.verified = self._verify_replay(s0, states, lanes, n_steps,
                                           inv_idx)

    def _verify_replay(self, s0, states, lanes, n_steps: int,
                       inv_idx: int) -> bool:
        """Re-verify the replayed behavior state by state: every chosen
        lane was enabled, every successor equals a single-state
        evaluation's, and the violated invariant holds on every state
        but the last."""
        m = self.model
        seq = [s0] + states[:n_steps]
        cur = s0
        for j in range(n_steps):
            lane, nxt = lanes[j], seq[j + 1]
            if lane >= self.A:
                if not _same(cur, nxt):
                    return False
                continue
            succ, valid = m.successors(cur)
            if not bool(valid[0, lane]):
                return False
            want = smap(lambda x: x[:, lane], succ)
            if not _same(want, nxt):
                return False
            cur = nxt
        if not self._inv_fns:
            return True
        inv = self._inv_fns[inv_idx]
        for j, s in enumerate(seq):
            ok = bool(inv(s)[0])
            if ok == (j == len(seq) - 1):
                return False
        return True

