"""The host-staged sharded BFS engine — the counterpart of
``pulsar_tlaplus_tpu/engine/sharded.py``'s ``ShardedChecker``.

One controller drives ``N`` shards over a :class:`~pulsar_tlaplus_tpu_torch.
parallel.mesh.Mesh` (several may share a device).  Each shard owns the
keys ``k1 % N`` (``k1`` the first column of ``dedup.make_keys``, taken
unsigned) and keeps a visited set of them on its device; the frontier,
its gids and the state log stay on the host.  A round, for every shard
on its device:

- **expand**: ``frontier_chunk`` rows of the shard's frontier (padded,
  the padding masked) give ``[F * A]`` candidate lanes with their parent
  gids and action ids;
- **route**: whole lanes (row, parent, action) travel to their owner:
  :func:`bucket` sorts them stably by destination into dense ``[N, L]``
  blocks (``L`` the lane count, so nothing can overflow), and one
  :meth:`Mesh.all_to_all` delivers them, source order kept.  On a
  ``(dcn, ici)`` mesh they go in two hops: to the owner slice, then to
  the owner chip within it;
- **dedup**: the owner settles its received lanes with
  ``engine/core.py`` (``dedup="sort"``, the default: key order;
  ``"hash"``: lane order, K1 + H1 on the card) and checks the
  invariants on the new states.

New states stay on their owner and form its next frontier.  The host
copies them into the log shard by shard, so gids follow (round, shard,
order within the shard): the log equals the JAX engine's shard for
shard.  ``max_states``, ``time_budget_s``, frames (``checkpoint_path``,
``run(resume=True)``), ``metrics_path`` and the ``level`` fault site
behave as in :class:`~.bfs.Checker`.
"""

from __future__ import annotations

import sys
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from pulsar_tlaplus_tpu_torch.engine import core
from pulsar_tlaplus_tpu_torch.engine.bfs import CheckerResult
from pulsar_tlaplus_tpu_torch.engine.statelog import MemoryLog
from pulsar_tlaplus_tpu_torch.kernels import build as kernels
from pulsar_tlaplus_tpu_torch.obs import telemetry as obs
from pulsar_tlaplus_tpu_torch.ops import dedup, fpset, hashtable
from pulsar_tlaplus_tpu_torch.ops.dedup import SENTINEL, u32
from pulsar_tlaplus_tpu_torch.parallel import mesh as mesh_mod
from pulsar_tlaplus_tpu_torch.utils import ckpt, faults, metrics

# the frame format's engine revision
ENGINE_SIG = "sharded_host_torch_r1"


def bucket(dest: torch.Tensor, valid: torch.Tensor, arrays, n_dest: int):
    """Sort lanes stably by destination and scatter them into dense
    ``[n_dest * L]`` blocks (invalid lanes dropped; the JAX
    ``_bucket``).  Returns ``(valid', arrays')``."""
    L = dest.shape[0]
    dev = dest.device
    d = torch.where(valid, dest.to(torch.int64), n_dest)
    sd, perm = torch.sort(d, stable=True)
    sv = valid[perm]
    counts = torch.bincount(sd, minlength=n_dest + 1)
    starts = torch.cumsum(counts, 0) - counts
    pos = torch.arange(L, device=dev) - starts[sd]
    flat = torch.where(sv, sd * L + pos, n_dest * L)  # n_dest*L: trash
    outs = []
    for a in arrays:
        z = torch.zeros((n_dest * L + 1, *a.shape[1:]), dtype=a.dtype,
                        device=dev)
        z[flat] = a[perm]
        outs.append(z[: n_dest * L])
    v = torch.zeros((n_dest * L + 1,), dtype=torch.bool, device=dev)
    v[flat] = sv
    return v[: n_dest * L], outs


class ShardedChecker:
    """BFS checker sharded over a mesh of ``n_devices`` shards (or the
    given ``mesh``; default one a card present, ``device="cpu"`` for
    the CPU); ``dedup_mode`` is ``"sort"`` or ``"hash"``."""

    def __init__(
        self,
        model,
        n_devices: Optional[int] = None,
        invariants: Optional[Tuple[str, ...]] = None,
        check_deadlock: bool = True,
        frontier_chunk: int = 1024,
        visited_cap: int = 1 << 13,
        max_states: int = 1_000_000_000,
        mesh=None,
        dedup_mode: str = "sort",
        time_budget_s: Optional[float] = None,
        metrics_path: Optional[str] = None,
        checkpoint_path: Optional[str] = None,
        checkpoint_every: int = 5,
        progress: bool = False,
        device=None,
        telemetry=None,
        heartbeat_s: Optional[float] = None,
    ):
        if dedup_mode not in ("sort", "hash"):
            raise ValueError(
                f"dedup_mode must be 'sort' or 'hash', got {dedup_mode!r}")
        if dedup_mode == "hash" and visited_cap & (visited_cap - 1):
            raise ValueError("hash dedup needs a power-of-two visited_cap")
        self.dedup_mode = dedup_mode
        self.model = model
        self.layout = model.layout
        self.mesh = (mesh if mesh is not None
                     else mesh_mod.make_mesh(n_devices, device))
        self.device = self.mesh.devices[0]
        self.n_shards = self.mesh.N
        if invariants is None:
            invariants = model.default_invariants
        unknown = [n for n in invariants if n not in model.invariants]
        if unknown:
            raise ValueError(f"unknown invariant(s): {unknown}")
        self.invariant_names = tuple(invariants)
        self.check_deadlock = check_deadlock
        self.F = frontier_chunk
        if max_states >= 2**31:
            # gids travel with the lanes as int32
            raise ValueError("sharded checker supports max_states < 2**31")
        self.max_states = max_states
        self.time_budget_s = time_budget_s
        self.metrics_path = metrics_path
        self.checkpoint_path = checkpoint_path
        self.checkpoint_every = checkpoint_every
        self.progress = progress
        self._cap0 = visited_cap
        self._ckpt_frames = 0
        # telemetry (``obs/telemetry.py``): a stream a run, and the
        # heartbeat from the level snapshot
        self._telemetry_arg = telemetry
        self.heartbeat_s = heartbeat_s
        self.tel = obs.NULL
        self._run_id: Optional[str] = None
        self._snap: Dict[str, object] = {}
        self._resume_meta: Dict[str, object] = {}

    # ----------------------------------------------------------- device

    def _empty_vk(self, cap: int):
        out = []
        for dev in self.mesh.devices:
            if self.dedup_mode == "hash":
                out.append(hashtable.empty_table(cap, dev))
            else:
                out.append(tuple(
                    torch.full((cap,), SENTINEL, dtype=torch.int32,
                               device=dev) for _ in range(3)))
        return out

    def _grow_visited(self, need_per_shard: int) -> None:
        cap = self._cap
        target = (2 * need_per_shard if self.dedup_mode == "hash"
                  else need_per_shard)
        while cap < target:
            cap *= 4
        if cap == self._cap:
            return
        for d, dev in enumerate(self.mesh.devices):
            if self.dedup_mode == "hash":
                self._vk[d] = hashtable.rehash_into(
                    self._vk[d], hashtable.empty_table(cap, dev))
                self._claims[d] = fpset.new_claims(cap, dev)
            else:
                pad = torch.full((cap - self._cap,), SENTINEL,
                                 dtype=torch.int32, device=dev)
                self._vk[d] = tuple(torch.cat([c, pad])
                                    for c in self._vk[d])
        self._cap = cap

    def _route(self, lanes):
        """Every shard's ``(packed, valid, parent, action)`` lanes to
        their owners; returns each owner's received lanes (source order
        kept, padding invalid)."""
        nd = self.n_shards
        mesh = self.mesh

        def owner(packed):
            k1 = dedup.make_keys(packed, self.layout.total_bits)[0]
            return u32(k1) % nd

        def exchange(parts, n_dest, axis):
            # parts[s] = (valid, [arrays]) bucketed into n_dest blocks
            outs = []
            for k in range(1 + len(parts[0][1])):
                send = []
                for v, arrs in parts:
                    a = v if k == 0 else arrs[k - 1]
                    send.append(a.reshape(n_dest, -1, *a.shape[1:]))
                recv = mesh.all_to_all(send, axis)
                outs.append([r.reshape(-1, *r.shape[2:]) for r in recv])
            return [(outs[0][d], [o[d] for o in outs[1:]])
                    for d in range(nd)]

        if len(mesh.axes) == 1:
            parts = [bucket(owner(p), v, (p, par, act), nd)
                     for p, v, par, act in lanes]
            got = exchange(parts, nd, mesh_mod.AXIS)
            return [(a[0], v, a[1], a[2]) for v, a in got]
        D, I = mesh.D, mesh.I
        parts = []
        for p, v, par, act in lanes:
            own = owner(p)
            parts.append(bucket(own // I, v, (p, par, act, own), D))
        got = exchange(parts, D, mesh_mod.DCN_AXIS)
        parts = [bucket(a[3] % I, v, a[:3], I) for v, a in got]
        got = exchange(parts, I, mesh_mod.ICI_AXIS)
        return [(a[0], v, a[1], a[2]) for v, a in got]

    def _dedup(self, d: int, rp, rv, rpar, ract):
        """Shard ``d``'s dedup of its received lanes: ``(packed, parent,
        action, n_new, viol)``, the new states first."""
        m, inv = self.model, self.invariant_names
        if self.dedup_mode == "hash":
            p, par, act, n_new, self._vk[d], viol, failed = \
                core.dedup_core_hash(m, inv, rp, rv, rpar, ract,
                                     self._vk[d], self._claims[d])
            self._failed.append(failed)
        else:
            p, par, act, n_new, *vk, viol = core.dedup_core(
                m, inv, rp, rv, rpar, ract, *self._vk[d],
                int(self._n_visited[d]))
            self._vk[d] = tuple(vk)
        return p, par, act, n_new, viol

    def _step(self, lanes):
        """Route and dedup one round; returns every shard's output."""
        self._failed = []
        outs = [self._dedup(d, *r)
                for d, r in enumerate(self._route(lanes))]
        if self._failed:
            n_failed = sum(int(f) for f in self._failed)
            if n_failed:
                raise RuntimeError(
                    "sharded hash-table probe overflow — raise "
                    f"visited_cap ({n_failed} unresolved lanes)")
        return outs

    def _insert_lanes(self, start: int):
        """Initial states ``[start + d*F, start + (d+1)*F)`` on shard
        ``d`` (padded, the indices past the count invalid)."""
        m, F = self.model, self.F
        n_init = m.n_initial
        lanes = []
        for d, dev in enumerate(self.mesh.devices):
            idx = start + d * F + torch.arange(F, device=dev)
            packed = self.layout.pack(m.gen_initial(idx % max(n_init, 1)))
            none = torch.full((F,), -1, dtype=torch.int32, device=dev)
            lanes.append((packed, idx < n_init, none, none))
        return lanes

    def _expand_lanes(self, chunk: np.ndarray, ns, gid_chunk):
        """Shard ``d`` expands its ``[F, W]`` chunk (``ns[d]`` live
        rows); returns its lanes and its first deadlocked row (``F`` if
        none)."""
        m, F, A = self.model, self.F, self.model.A
        lanes, deads = [], []
        for d, dev in enumerate(self.mesh.devices):
            rows = torch.from_numpy(chunk[d].view(np.int32)).to(dev)
            live = torch.arange(F, device=dev) < int(ns[d])
            states = self.layout.unpack(rows)
            succ, valid = m.successors(states)
            valid = valid & live[:, None]
            packed = self.layout.pack(succ).reshape(F * A, self.layout.W)
            gids = torch.from_numpy(gid_chunk[d].astype(np.int32)).to(dev)
            action = torch.from_numpy(
                np.asarray(m.action_ids, np.int32)).to(dev).repeat(F)
            lanes.append((packed, valid.reshape(-1),
                          gids.repeat_interleave(A), action))
            if self.check_deadlock:
                dead = live & ~valid.any(dim=1) & ~m.stutter_enabled(states)
                deads.append(torch.where(dead, torch.arange(F, device=dev),
                                         F).amin())
            else:
                deads.append(None)
        return lanes, [F if x is None else int(x) for x in deads]

    # ------------------------------------------------------------- host

    def _log(self, msg: str) -> None:
        if self.progress:
            print(f"  {msg}", file=sys.stderr, flush=True)

    def _harvest(self, outs) -> Optional[Tuple[str, int]]:
        """Copy every shard's new states into the log and its next
        frontier, shard by shard; returns the first violation."""
        violation = None
        for d, (packed, parent, action, n_new, viol) in enumerate(outs):
            nn = int(n_new)
            self._n_visited[d] += nn
            if nn == 0:
                continue
            np_packed = packed[:nn].cpu().numpy().view(np.uint32)
            self._log_store.append(np_packed,
                                   parent[:nn].cpu().numpy().astype(np.int64),
                                   action[:nn].cpu().numpy())
            self._next[d].append(np_packed)
            self._next_gids[d].append(
                np.arange(self._n_total, self._n_total + nn, dtype=np.int64))
            for name, v in zip(self.invariant_names, viol.tolist()):
                if v < nn and violation is None:
                    violation = (name, self._n_total + v)
            self._n_total += nn
        return violation

    def _take_next(self):
        fr, gd = [], []
        W = self.layout.W
        for d in range(self.n_shards):
            fr.append(np.concatenate(self._next[d]) if self._next[d]
                      else np.zeros((0, W), np.uint32))
            gd.append(np.concatenate(self._next_gids[d])
                      if self._next_gids[d] else np.zeros((0,), np.int64))
            self._next[d], self._next_gids[d] = [], []
        return fr, gd

    def _result(self, t0, level_sizes, violation=None, deadlock_gid=None,
                truncated=False) -> CheckerResult:
        for dev in self.mesh.distinct_devices():
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
        self.last_log = self._log_store  # the run's state log, gid order
        wall = time.time() - t0
        n = self._n_total
        res = CheckerResult(
            distinct_states=n, diameter=len(level_sizes),
            deadlock=deadlock_gid is not None, wall_s=wall,
            states_per_sec=n / max(wall, 1e-9), level_sizes=level_sizes,
            truncated=truncated,
        )
        gid = None
        if violation is not None:
            res.violation, gid = violation
        elif deadlock_gid is not None:
            res.violation, gid = "Deadlock", deadlock_gid
        if gid is not None:
            res.violation_gid = gid
            res.trace, res.trace_actions = core.build_log_trace(
                self.model, gid, self._log_store)
        self.tel.emit(
            "result",
            distinct_states=n,
            diameter=len(level_sizes),
            wall_s=round(wall, 3),
            states_per_sec=round(n / max(wall, 1e-9), 1),
            truncated=truncated,
            stop_reason=res.stop_reason,
            violation=res.violation,
            deadlock=res.deadlock,
            level_sizes=[int(x) for x in level_sizes],
            stats={
                "ckpt_frames": self._ckpt_frames,
                "ckpt_bytes": self._ckpt_bytes,
                "ckpt_write_s": round(self._ckpt_write_s, 3),
                "ckpt_retries": self._ckpt_retries,
                "n_shards": self.n_shards,
            },
        )
        return res

    def _over_budget(self, budget_t0: float) -> bool:
        return self._n_total > self.max_states or (
            self.time_budget_s is not None
            and time.time() - budget_t0 > self.time_budget_s)

    def _config_sig(self) -> str:
        return ckpt.config_sig(
            model=ckpt.model_sig(self.model),
            invariants=self.invariant_names,
            check_deadlock=self.check_deadlock,
            state_bits=self.layout.total_bits,
            dedup=self.dedup_mode,
            n_shards=self.n_shards,
            axes=tuple(self.mesh.axes),
            engine=ENGINE_SIG,
        )

    def _save_checkpoint(self, level_sizes, frontier, fgids, t0) -> None:
        """A level-boundary frame: every shard's visited columns, its
        frontier and gids, and the log."""
        log = self._log_store
        total = sum(len(f) for f in frontier)
        arrays = {
            f"vk{i}": np.stack([
                self._vk[d][i].cpu().numpy().view(np.uint32)
                for d in range(self.n_shards)])
            for i in range(3)
        }
        arrays.update(
            n_visited=self._n_visited.copy(),
            level_sizes=np.asarray(level_sizes, np.int64),
            fr=(np.concatenate(frontier) if total
                else np.zeros((0, self.layout.W), np.uint32)),
            fr_lens=np.asarray([len(f) for f in frontier], np.int64),
            fgids=(np.concatenate(fgids) if total
                   else np.zeros((0,), np.int64)),
            packed=log.packed_matrix(), parent=log.parents(),
            action=log.actions(),
        )
        t = time.perf_counter()
        nbytes, write_s, retries = ckpt.save_frame(
            self.checkpoint_path, self._config_sig(), arrays,
            wall_s=time.time() - t0,
            meta={"frame_seq": self._ckpt_frames + 1,
                  "level": len(level_sizes), "engine": "sharded_host",
                  "run_id": self._run_id},
        )
        self._ckpt_frames += 1
        self._ckpt_bytes += nbytes
        self._ckpt_write_s += time.perf_counter() - t
        self._ckpt_retries += retries
        self.tel.emit(
            "ckpt_frame",
            frame_seq=self._ckpt_frames,
            bytes=nbytes,
            write_s=round(write_s, 3),
            stall_s=round(time.perf_counter() - t, 3),
            retries=retries,
            level=len(level_sizes),
            distinct_states=int(self._n_visited.sum()),
        )

    def _restore(self):
        d = ckpt.load_frame(self.checkpoint_path, self._config_sig())
        self._resume_meta = ckpt.frame_meta(d)
        cap = d["vk0"].shape[1] - (1 if self.dedup_mode == "hash" else 0)
        self._cap = cap
        self._vk = self._empty_vk(cap)
        for s, dev in enumerate(self.mesh.devices):
            for i in range(3):
                self._vk[s][i].copy_(torch.from_numpy(
                    np.asarray(d[f"vk{i}"][s], np.uint32).view(np.int32)
                    .copy()).to(dev))
        self._n_visited = np.asarray(d["n_visited"], np.int64).copy()
        if len(d["packed"]):
            self._log_store.append(d["packed"], d["parent"], d["action"])
        self._n_total = len(self._log_store)
        level_sizes = [int(x) for x in d["level_sizes"]]
        offs = np.concatenate([[0], np.cumsum(d["fr_lens"])])
        fr, fg = np.asarray(d["fr"], np.uint32), d["fgids"]
        n = self.n_shards
        frontier = [fr[offs[i]: offs[i + 1]] for i in range(n)]
        fgids = [fg[offs[i]: offs[i + 1]] for i in range(n)]
        return level_sizes, frontier, fgids, float(d["wall_s"])

    # -------------------------------------------------------------- run

    def run(self, resume: bool = False) -> CheckerResult:
        """Check the model; ``resume=True`` continues the
        ``checkpoint_path`` frame."""
        self._resume_meta = {}
        self._ckpt_frames = self._ckpt_bytes = self._ckpt_retries = 0
        self._ckpt_write_s = 0.0
        with obs.run_scope(self, self._telemetry_arg, self.heartbeat_s,
                           self.max_states):
            return self._run(resume)

    def _emit_header(self, resume: bool) -> None:
        obs.emit_header(
            self.tel, self.device, resume, self._resume_meta,
            engine="sharded_host",
            n_devices=self.n_shards,
            visited_impl=self.dedup_mode,
            config_sig=self._config_sig(),
            mode="check",
            max_states=self.max_states,
            invariants=list(self.invariant_names),
        )

    def _run(self, resume: bool) -> CheckerResult:
        m, nd, F = self.model, self.n_shards, self.F
        for dev in self.mesh.distinct_devices():
            if dev.type == "cuda":
                kernels.selftest(dev)  # K0 on each card
        t0 = budget_t0 = time.time()
        ckpt.cleanup_stale_tmp(self.checkpoint_path)
        self._log_store = MemoryLog(self.layout.W)
        self._n_total = 0
        self._n_visited = np.zeros((nd,), np.int64)
        self._next: List[list] = [[] for _ in range(nd)]
        self._next_gids: List[list] = [[] for _ in range(nd)]
        self._claims = [None] * nd
        if resume:
            if not self.checkpoint_path:
                raise ValueError("resume requires checkpoint_path")
            level_sizes, frontier, fgids, wall = self._restore()
            t0 = time.time() - wall
            if self.dedup_mode == "hash":
                self._claims = [fpset.new_claims(self._cap, dev)
                                for dev in self.mesh.devices]
            metrics.rewind(self.metrics_path, len(level_sizes))
            self._emit_header(resume=True)
        else:
            self._emit_header(resume=False)
            self._cap = self._cap0
            self._vk = self._empty_vk(self._cap)
            if self.dedup_mode == "hash":
                self._claims = [fpset.new_claims(self._cap, dev)
                                for dev in self.mesh.devices]
            level_sizes = []
            n_init = m.n_initial
            for start in range(0, n_init, nd * F):
                self._grow_visited(int(self._n_visited.max()) + nd * F + 1)
                violation = self._harvest(
                    self._step(self._insert_lanes(start)))
                if violation is not None:
                    level_sizes.append(self._n_total)
                    return self._result(t0, level_sizes, violation)
            level_sizes.append(self._n_total)
            frontier, fgids = self._take_next()
        W = self.layout.W
        while any(len(f) for f in frontier):
            faults.poll("level", len(level_sizes) + 1)
            rounds = max((len(f) + F - 1) // F for f in frontier)
            level_base = self._n_total
            for r in range(rounds):
                chunk = np.zeros((nd, F, W), np.uint32)
                ns = np.zeros((nd,), np.int64)
                gid_chunk = np.zeros((nd, F), np.int64)
                for d in range(nd):
                    part = frontier[d][r * F: (r + 1) * F]
                    ns[d] = len(part)
                    chunk[d, : len(part)] = part
                    gid_chunk[d, : len(part)] = fgids[d][r * F: (r + 1) * F]
                self._grow_visited(
                    int(self._n_visited.max()) + nd * F * m.A + 1)
                lanes, dead = self._expand_lanes(chunk, ns, gid_chunk)
                violation = self._harvest(self._step(lanes))
                if violation is not None:
                    level_sizes.append(self._n_total - level_base)
                    return self._result(t0, level_sizes, violation)
                for d in range(nd):
                    if dead[d] < ns[d]:
                        level_sizes.append(self._n_total - level_base)
                        return self._result(
                            t0, level_sizes,
                            deadlock_gid=int(gid_chunk[d][dead[d]]))
                if self._over_budget(budget_t0) and not self.checkpoint_path:
                    # no frame to write: stop at once
                    level_sizes.append(self._n_total - level_base)
                    return self._result(t0, level_sizes, truncated=True)
            if self._n_total == level_base:
                break
            level_sizes.append(self._n_total - level_base)
            wall = time.time() - t0
            self._log(f"level {len(level_sizes)}: +{level_sizes[-1]} (total "
                      f"{self._n_total}, "
                      f"{self._n_total / max(wall, 1e-9):.0f} st/s)")
            nfr = int(sum(len(f) for f in frontier))
            self._snap.update(level=len(level_sizes), frontier=nfr,
                              distinct_states=self._n_total)
            self.tel.emit(
                "level",
                level=len(level_sizes),
                new_states=int(level_sizes[-1]),
                distinct_states=self._n_total,
                frontier=nfr,
                wall_s=round(wall, 3),
                states_per_sec=round(self._n_total / max(wall, 1e-9), 1),
            )
            metrics.append(self.metrics_path, {
                "level": len(level_sizes),
                "new_states": level_sizes[-1],
                "distinct_states": self._n_total,
                "frontier": nfr,
                "wall_s": round(wall, 3),
                "states_per_sec": round(self._n_total / max(wall, 1e-9), 1),
                "visited_cap_per_shard": self._cap,
                "n_shards": nd,
            })
            frontier, fgids = self._take_next()
            over = self._over_budget(budget_t0)
            if self.checkpoint_path and (
                    over or len(level_sizes) % self.checkpoint_every == 0):
                self._save_checkpoint(level_sizes, frontier, fgids, t0)
            if over:
                return self._result(t0, level_sizes, truncated=True)
        return self._result(t0, level_sizes)
