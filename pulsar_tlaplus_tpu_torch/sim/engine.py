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

- **Walk digest**: a SHA-256 chain over each segment's counter vector
  (already on the host, so it costs no read): ``stats["sim_walk_digest"]``
  after each segment, equal for runs that walked the same.
- **Checkpoints** (``checkpoint_path``, every ``checkpoint_every``
  segments; ``utils/ckpt.py``): a frame holds the walkers' states, the
  estimator table, the epoch (which anchors the counter hash's position:
  the walk's random words depend only on seed, epoch and walker), the
  cumulative counters, the walk digest and the budgets, with a digest of
  the walker states and epoch; ``run(resume=True)`` continues the
  identical walk, or refuses a frame whose digest does not match.  A
  resume with no budget of its own takes the frame's.  SIGTERM/SIGINT
  writes a frame before the next segment and stops ``preempted``; the
  ``segment`` fault site counts epochs.

- **Tuned profiles** (``profile``, default ``"auto"``, as in the JAX
  engine): the ``"sim"`` profile of ``tune/profiles.py`` fills
  ``n_walkers`` and ``segment_len`` when left at None (``cli tune --mode
  simulate`` writes it).  A different width or segment is a different
  deterministic walk stream, so profiles resolve by config signature.

Telemetry is ported (``telemetry``, ``heartbeat_s``).  The daemon's sim
jobs (``service/scheduler.py``) time-slice through ``suspend_hook``,
polled before every segment after the preemption watcher: ``"suspended"``
writes a frame and stops resumably, ``"cancelled"`` stops without one.
"""

from __future__ import annotations

import gc
import hashlib
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from pulsar_tlaplus_tpu_torch.obs import telemetry as obs
from pulsar_tlaplus_tpu_torch.ops.dedup import U32, mul32
from pulsar_tlaplus_tpu_torch.ops.packing import smap, tree_leaves
from pulsar_tlaplus_tpu_torch.sim import rng
from pulsar_tlaplus_tpu_torch.tune import profiles as tune_profiles
from pulsar_tlaplus_tpu_torch.utils import ckpt, faults
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
# the simulation frame format's revision
SIM_CKPT_REV = "torch_r1"


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
    truncated: bool = False   # preempted mid-stream (resumable)
    stats: Dict[str, object] = field(default_factory=dict)


class StreamingSimulator:
    """Continuous walker-swarm simulation of a batched model on one
    device (``cuda`` unless ``device`` names another; raises when CUDA
    is wanted and absent).

    Budgets (the run ends at whichever binds first): ``max_steps``
    (random steps across the swarm), ``max_rounds`` (behavior rounds),
    ``time_budget_s`` (wall clock).  With no budget the run is one
    round (a resume with no budget takes the frame's).
    ``checkpoint_path`` writes a frame every ``checkpoint_every``
    segments.  ``telemetry`` takes the run's JSONL stream (one ``sim``
    record a segment, riding its one read); ``heartbeat_s`` prints a
    progress line that often.  ``n_walkers`` (default 1,024) and
    ``segment_len`` left at None take the ``"sim"`` profile's values
    (``profile``: ``"auto"`` by default, None turns it off).
    """

    def __init__(
        self,
        model,
        invariants: Optional[Tuple[str, ...]] = None,
        n_walkers: Optional[int] = None,
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
        checkpoint_path: Optional[str] = None,
        checkpoint_every: int = 8,
        telemetry=None,
        heartbeat_s: Optional[float] = None,
        profile="auto",
        suspend_hook=None,
    ):
        self.model = model
        if invariants is None:
            invariants = tuple(getattr(model, "default_invariants", ()))
        self.invariant_names = tuple(invariants)
        unknown = [n for n in self.invariant_names
                   if n not in model.invariants]
        if unknown:
            raise ValueError(f"unknown invariant(s): {unknown}")
        self.device = device_mod.resolve(device)
        # the "sim" profile fills what the caller left unset
        prof = tune_profiles.resolve(
            profile, model=model, invariants=self.invariant_names,
            engine="sim",
            backend=tune_profiles.default_backend(self.device))
        pk = tune_profiles.knobs_for(prof, "sim")
        self.profile_sig = prof["sig"] if prof else None
        if n_walkers is None:
            n_walkers = int(pk.get("n_walkers", 1024))
        if segment_len is None:
            segment_len = pk.get("segment_len")
        if depth < 1:
            raise ValueError(f"depth must be >= 1: {depth}")
        if n_walkers < 1:
            raise ValueError(f"n_walkers must be >= 1: {n_walkers}")
        if not 1 <= dup_table_bits <= 31:
            raise ValueError(f"dup_table_bits not in 1..31: {dup_table_bits}")
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
        # whether the caller chose a budget: a resume with none takes
        # the frame's instead of the one-round default
        self._budget_explicit = not (max_steps is None and max_rounds is None
                                     and time_budget_s is None)
        if not self._budget_explicit:
            self.max_rounds = 1  # finite default: one behavior round
        self.checkpoint_path = checkpoint_path
        self.checkpoint_every = max(1, int(checkpoint_every))
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
        # the daemon's per-slice hook and run-header identity
        self.suspend_hook = suspend_hook
        self.tenant: Optional[str] = None
        self.trace_id: Optional[str] = None
        self.warm: Optional[str] = None
        self._telemetry_arg = telemetry
        self.heartbeat_s = heartbeat_s
        self.tel = obs.NULL
        self._run_id: Optional[str] = None
        self._snap: Dict[str, object] = {}

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

    def run(self, resume: bool = False) -> SimulationResult:
        """Run the swarm under its budgets; ``resume=True`` continues the
        walk of the ``checkpoint_path`` frame."""
        with obs.run_scope(self, self._telemetry_arg, self.heartbeat_s):
            return self._run(resume)

    def _emit_header(self, resume: bool, resume_meta: dict) -> None:
        obs.emit_header(
            self.tel, self.device, resume, resume_meta,
            engine="sim",
            mode="simulate",
            visited_impl=None,
            config_sig=self._config_sig(),
            profile_sig=self.profile_sig,
            n_walkers=self.B,
            depth=self.T,
            segment_len=self.L,
            seed=self.seed,
            invariants=list(self.invariant_names),
            tenant=self.tenant,
            trace_id=self.trace_id,
            warm=self.warm,
        )

    def _emit_sim_event(self, cum, epoch: int, wall: float) -> None:
        """One cumulative ``sim`` record (from the segment's read)."""
        walks = self.B * (cum["steps"] // (self.B * self.T))
        self._snap.update(distinct_states=cum["states"],
                          generated=cum["steps"], level=epoch, walks=walks)
        self.tel.emit(
            "sim",
            steps=cum["steps"],
            walkers=self.B,
            violations=cum["violations"],
            states=cum["states"],
            walks=walks,
            stutter_steps=cum["stutter"],
            enabled_lanes=cum["enabled"],
            dup_attempts=cum["dup_att"],
            dup_hits=cum["dup_hits"],
            dup_ratio_est=(round(cum["dup_hits"] / cum["dup_att"], 6)
                           if cum["dup_att"] else None),
            epoch=epoch,
            segments=cum["segments"],
            wall_s=round(wall, 3),
            steps_per_sec=round(cum["steps"] / max(wall, 1e-9), 1),
        )

    def _run(self, resume: bool) -> SimulationResult:
        dev = self.device
        self._widx = torch.arange(self.B, dtype=torch.int64, device=dev)
        self._syncs = 0
        self._frames = 0
        ckpt.cleanup_stale_tmp(self.checkpoint_path)
        if resume:
            if not self.checkpoint_path:
                raise ValueError("resume=True needs a checkpoint_path")
            (states, table, epoch, cum, digest, wall,
             meta) = self._load_frame()
            t0 = time.time() - wall
            self._emit_header(True, meta)
        else:
            self._emit_header(False, {})
            table = torch.zeros((1 << self.dup_table_bits,),
                                dtype=torch.int64, device=dev)
            states = None  # the first segment is a restart
            epoch = 0
            cum = dict(steps=0, states=0, violations=0, stutter=0,
                       enabled=0, dup_att=0, dup_hits=0, segments=0)
            digest = hashlib.sha256(b"ptt-sim").hexdigest()
            t0 = time.time()
        self._log(f"simulation: {self.B} walkers, depth {self.T}, "
                  f"segment {self.L} step(s) on {dev}"
                  + (f" (resumed at epoch {epoch})" if resume else ""))
        stop_reason = None
        viol = None  # (epoch, code, walker, inv_idx)
        deadline = (None if self.time_budget_s is None
                    else time.monotonic() + self.time_budget_s)
        watcher = ckpt.PreemptionWatcher(
            enabled=bool(self.checkpoint_path), log=self._log
        )
        with watcher:
            while True:
                # the segment about to run is all or nothing: stops first
                if watcher.requested:
                    stop_reason = "preempted"
                    break
                if self.suspend_hook is not None:
                    why = self.suspend_hook()
                    if why in ("cancelled", "suspended"):
                        stop_reason = why
                        break
                if (self.max_steps is not None
                        and cum["steps"] >= self.max_steps):
                    stop_reason = "step_budget"
                    break
                if (self.max_rounds is not None
                        and cum["steps"] >= self.max_rounds * self.T
                        * self.B):
                    stop_reason = "round_budget"
                    break
                if deadline is not None and time.monotonic() >= deadline:
                    stop_reason = "time_budget"
                    break
                faults.poll("segment", epoch)
                restart = epoch % self.segs_per_round == 0
                states, table, ctrs = self._segment(states, table, epoch)
                c = ctrs.tolist()  # the one read a segment
                self._syncs += 1
                digest = hashlib.sha256(
                    (digest + repr(c)).encode()).hexdigest()
                cum["segments"] += 1
                cum["steps"] += self.B * self.L
                cum["states"] += self.B * self.L + (self.B if restart else 0)
                cum["stutter"] += c[CTR_STUTTER]
                cum["enabled"] += c[CTR_ENABLED]
                cum["violations"] += c[CTR_VIOL]
                cum["dup_att"] += self.S * (self.L + (1 if restart else 0))
                cum["dup_hits"] += c[CTR_DUP_HITS]
                self._emit_sim_event(cum, epoch + 1, time.time() - t0)
                if c[CTR_VIOL] and c[CTR_VKEY] != CLEAN:
                    viol = (epoch, c[CTR_VKEY] // self.B,
                            c[CTR_VKEY] % self.B, c[CTR_VINV])
                    epoch += 1
                    stop_reason = "violation"
                    break
                epoch += 1
                if (self.checkpoint_path
                        and cum["segments"] % self.checkpoint_every == 0):
                    self._save_frame(states, table, epoch, cum, digest,
                                     time.time() - t0)
        if stop_reason in ("preempted", "suspended") and states is not None:
            self._save_frame(states, table, epoch, cum, digest,
                             time.time() - t0)
            self._log(f"simulation {stop_reason} at epoch {epoch} "
                      f"({cum['steps']} steps banked)")
        res = self._mk_result(cum, epoch, t0, stop_reason)
        res.truncated = stop_reason in ("preempted", "suspended",
                                        "cancelled")
        self.last_stats["sim_walk_digest"] = digest
        if self.checkpoint_path:
            self.last_stats["ckpt_frames"] = self._frames
        if viol is not None:
            self._attach_violation(res, viol)
        self.tel.emit(
            "result",
            distinct_states=None,
            diameter=None,
            wall_s=res.wall_s,
            truncated=res.truncated,
            stop_reason=res.stop_reason,
            violation=res.violation,
            states_visited=res.states_visited,
            steps=res.steps,
            walks=res.walks,
            stats=dict(self.last_stats),
        )
        return res

    def _free_buffers(self) -> None:
        """Drop the device tensors the simulator keeps between runs and
        PyTorch's cache of the freed blocks (the daemon calls this after
        every slice: a suspended job's state is its frame on disk)."""
        self._widx = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # ----------------------------------------------------- checkpoints

    def _config_sig(self) -> str:
        return ckpt.config_sig(
            kind="sim",
            rev=SIM_CKPT_REV,
            model=ckpt.model_sig(self.model),
            invariants=self.invariant_names,
            n_walkers=self.B,
            depth=self.T,
            segment_len=self.L,
            seed=self.seed,
        )

    def _states_digest(self, leaves, epoch: int) -> str:
        """Anchors the walk's position (seed, epoch, shape) and the
        walkers' states: a resumed run continues the identical walk or
        refuses."""
        h = hashlib.sha256()
        h.update(repr((self.seed, int(epoch), self.B, self.T,
                       self.L)).encode())
        for leaf in leaves:
            h.update(np.ascontiguousarray(leaf).tobytes())
        return h.hexdigest()

    def _save_frame(self, states, table, epoch, cum, digest, wall_s):
        t = time.perf_counter()
        leaves = [x.to("cpu", copy=True).numpy() for x in tree_leaves(states)]
        arrays = {f"w{i}": leaf for i, leaf in enumerate(leaves)}
        arrays["dup_table"] = table.to("cpu", copy=True).numpy()
        arrays["epoch"] = np.int64(epoch)
        arrays["cum"] = np.asarray(
            [cum["steps"], cum["states"], cum["violations"], cum["stutter"],
             cum["enabled"], cum["dup_att"], cum["dup_hits"],
             cum["segments"]], np.int64)
        arrays["budgets"] = np.asarray(
            [-1 if self.max_steps is None else self.max_steps,
             -1 if self.max_rounds is None else self.max_rounds], np.int64)
        arrays["keys_digest"] = np.frombuffer(
            self._states_digest(leaves, epoch).encode(), dtype=np.uint8)
        arrays["walk_digest"] = np.frombuffer(digest.encode(),
                                              dtype=np.uint8)
        self._frames += 1
        nbytes, _w, retries = ckpt.save_frame(
            self.checkpoint_path, self._config_sig(), arrays, wall_s=wall_s,
            meta={"frame_seq": self._frames, "epoch": int(epoch),
                  "run_id": self._run_id},
        )
        write_s = round(time.perf_counter() - t, 4)
        self.last_stats.update(ckpt_bytes=nbytes, ckpt_write_s=write_s)
        self.tel.emit(
            "ckpt_frame",
            frame_seq=self._frames,
            bytes=nbytes,
            write_s=write_s,
            retries=retries,
            distinct_states=None,
            epoch=int(epoch),
            steps=int(cum["steps"]),
        )

    def _load_frame(self):
        d = ckpt.load_frame(self.checkpoint_path, self._config_sig(),
                            what="simulation configuration")
        epoch = int(d["epoch"])
        n = sum(1 for k in d.files if k[0] == "w" and k[1:].isdigit())
        leaves = [np.asarray(d[f"w{i}"]) for i in range(n)]
        if d["keys_digest"].tobytes().decode() != self._states_digest(
                leaves, epoch):
            raise ValueError(
                "simulation checkpoint keys-digest mismatch — the frame "
                "does not anchor this walk stream"
            )
        it = iter(leaves)
        template = self._init(0, self._widx)
        states = smap(lambda x: torch.from_numpy(next(it)).to(self.device),
                      template)
        table = torch.from_numpy(np.asarray(d["dup_table"])).to(self.device)
        c = [int(x) for x in np.asarray(d["cum"], np.int64)]
        cum = dict(zip(("steps", "states", "violations", "stutter",
                        "enabled", "dup_att", "dup_hits", "segments"), c))
        # a resume with no budget of its own goes on under the frame's
        if not self._budget_explicit:
            b = [int(x) for x in np.asarray(d["budgets"], np.int64)]
            if b[0] >= 0:
                self.max_steps, self.max_rounds = b[0], None
            if b[1] >= 0:
                self.max_rounds = b[1]
        return (states, table, epoch, cum,
                d["walk_digest"].tobytes().decode(), float(d["wall_s"]),
                ckpt.frame_meta(d))

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
        self.tel.emit(
            "sim_violation",
            invariant=res.violation,
            walker=walker,
            step=res.violation_step,
            trace_len=len(trace),
            verified=res.verified,
        )

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

