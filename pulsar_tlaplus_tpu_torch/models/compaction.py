"""The ``compaction`` spec as batched tensor code — the counterpart of
``pulsar_tlaplus_tpu/models/compaction.py``.

The JAX model is written for one state and ``vmap``-ped; here every
function takes a batch (:class:`~..ops.packing.SState` with a leading
``[B]``) and writes the batch dimension out.  Successor generation
returns a static lane axis ``A``: the Producer's ``|KeySet|*|ValueSet|``
branches (compaction.tla:85), then the six compactor phases and
BrokerCrash, one lane each; the stuttering disjuncts (Consumer,
Terminating) only feed the deadlock check (``stutter_enabled``).

Counterexample replay and the state conversions run on the copied
oracle (``ref/pyeval.py``): lanes are deterministic functions, so a
(init index, lane list) chain replays on the host.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Tuple

import numpy as np
import torch

from pulsar_tlaplus_tpu_torch.ops.packing import Layout, SState, smap
from pulsar_tlaplus_tpu_torch.ref import pyeval
from pulsar_tlaplus_tpu_torch.ref.pyeval import Constants


class CompactionModel:
    """Batched ``compaction`` spec for a fixed ``Constants`` binding."""

    def __init__(self, c: Constants):
        c.validate()
        self.c = c
        self.layout = Layout(c)
        self.M = c.message_sent_limit
        self.C = c.compaction_times_limit
        self.K = c.num_keys
        # Producer branch fanout: |KeySet| * |ValueSet| (compaction.tla:85)
        self.kv = (c.num_keys + 1) * (c.num_values + 1)
        self.n_producer_lanes = self.kv if c.model_producer else 0
        # lane -> pyeval action id (pyeval.ACTION_NAMES order)
        self.action_ids = np.array(
            [0] * self.n_producer_lanes + [1, 2, 3, 4, 5, 6, 7],
            dtype=np.int32,
        )
        self.A = len(self.action_ids)
        self.action_names = pyeval.ACTION_NAMES
        self.default_invariants = pyeval.DEFAULT_INVARIANTS

    # ------------------------------------------------------------ helpers

    def _pos(self, device) -> torch.Tensor:
        return torch.arange(1, self.M + 1, dtype=torch.int32, device=device)

    def _kvals(self, device) -> torch.Tensor:
        return torch.arange(1, self.K + 1, dtype=torch.int32, device=device)

    def _max_led_id(self, led_present: torch.Tensor) -> torch.Tensor:
        """MaxCompactedLedgerId (compaction.tla:103-106): ``[B, C] ->
        [B]``, 0 when every slot is Nil."""
        if self.C == 0:
            return torch.zeros(led_present.shape[:-1], dtype=torch.int32,
                               device=led_present.device)
        ids = torch.arange(1, self.C + 1, dtype=torch.int32,
                           device=led_present.device)
        return (ids * led_present).amax(dim=-1)

    def _latest_per_key(self, keys, sel) -> torch.Tensor:
        """latestForKey as ``[B, K]``: the largest 1-based position with
        that key among the selected positions, else 0.  O(M*K)."""
        pos = self._pos(keys.device)
        hit = (keys[:, None, :] == self._kvals(keys.device)[None, :, None]) & (
            sel[:, None, :]
        )
        return torch.where(hit, pos, 0).amax(dim=2)

    def _lookup_per_key(self, table, keys) -> torch.Tensor:
        """``out[b, i] = table[b, keys[b, i] - 1]`` (0 for key 0 or out
        of range) as a one-hot contraction."""
        onehot = keys[:, None, :] == self._kvals(keys.device)[None, :, None]
        return torch.where(onehot, table[:, :, None], 0).sum(dim=1)

    def _compact_keep(self, keys, readpos) -> torch.Tensor:
        """CompactMessages as a position mask (compaction.tla:107-119):
        a null key is kept iff RetainNullKey, another key iff it is the
        last occurrence of that key within ``1..readpos``."""
        pos = self._pos(keys.device)
        in_range = pos[None, :] <= readpos[:, None]
        latest = self._latest_per_key(keys, in_range)
        is_latest = (
            in_range & (keys != 0)
            & (self._lookup_per_key(latest, keys) == pos)
        )
        null_keep = in_range & (keys == 0) & self.c.retain_null_key
        return is_latest | null_keep

    @staticmethod
    def _fill(s: SState, v: int) -> torch.Tensor:
        return torch.full_like(s.length, v)

    # ---------------------------------------- initial states (188-202)

    @property
    def n_initial(self) -> int:
        if self.c.model_producer:
            return 1
        return self.kv ** self.M

    def gen_initial(self, idx: torch.Tensor) -> SState:
        """Initial states ``#idx`` (int64 ``[B]``): a mixed-radix decode
        of the Init fanout, position ``i``'s (key, value) being digit
        ``i`` of ``idx`` in base ``|KeySet|*|ValueSet|``; with
        ModelProducer one state with empty ``messages``."""
        dev, b = idx.device, idx.shape[0]
        z = torch.zeros((b,), dtype=torch.int32, device=dev)
        if self.c.model_producer:
            length = z
            keys = torch.zeros((b, self.M), dtype=torch.int32, device=dev)
            vals = keys.clone()
        else:
            x = idx.to(torch.int64)
            digits = []
            for _ in range(self.M):
                digits.append(x % self.kv)
                x = x // self.kv
            d = (
                torch.stack(digits, dim=1).to(torch.int32)
                if self.M
                else torch.zeros((b, 0), dtype=torch.int32, device=dev)
            )
            keys = d // (self.c.num_values + 1)
            vals = d % (self.c.num_values + 1)
            length = torch.full((b,), self.M, dtype=torch.int32, device=dev)
        return SState(
            length=length,
            keys=keys,
            vals=vals,
            led_present=torch.zeros((b, self.C), dtype=torch.int32,
                                    device=dev),
            led_bits=torch.zeros((b, self.C, self.M), dtype=torch.bool,
                                 device=dev),
            cursor_present=z,
            cursor_h=z,
            cursor_c=z,
            cstate=torch.full((b,), pyeval.PHASE_ONE, dtype=torch.int32,
                              device=dev),
            p1_present=z,
            p1_readpos=z,
            horizon=z,
            context=z,
            crash=z,
            consume=z,
        )

    @property
    def sample_width(self) -> int:
        """Random words :meth:`sample_initial` takes per state."""
        return self.M

    def sample_initial(self, u: torch.Tensor) -> SState:
        """Uniform random initial states (the simulator's protocol):
        ``u`` is int64 ``[B, M]`` of uint32 words, and position ``i``'s
        (key, value) digit is ``(u[:, i] * |KeySet|*|ValueSet|) >> 32``,
        uniform over the Init fanout without ``n_initial``, which
        overflows at large MessageSentLimit.  With ModelProducer the one
        initial state."""
        b = u.shape[0]
        base = self.gen_initial(torch.zeros((b,), dtype=torch.int64,
                                            device=u.device))
        if self.c.model_producer:
            return base
        d = ((u * self.kv) >> 32).to(torch.int32)
        return base._replace(
            keys=d // (self.c.num_values + 1),
            vals=d % (self.c.num_values + 1),
        )

    def fingerprint_leaves(self, s: SState) -> List[torch.Tensor]:
        """The state's fields as the JAX model's pytree leaves, in order
        (the simulator's duplicate estimator hashes them): the ledger
        bits as the JAX model's ``led_mask`` words, uint32 ``[*B, C,
        ceil(M / 32)]`` held in int64."""
        mw = max(1, -(-self.M // 32))
        bits = s.led_bits.to(torch.int64)
        pad = mw * 32 - self.M
        if pad:
            bits = torch.nn.functional.pad(bits, (0, pad))
        shift = torch.arange(32, dtype=torch.int64, device=bits.device)
        words = (bits.reshape(*bits.shape[:-1], mw, 32) << shift).sum(-1)
        return [words if f == "led_bits" else v
                for f, v in s._asdict().items()]

    # --------------------------------------- actions (216-231), batched

    def _phase_one(self, s: SState):
        """CompactorPhaseOne (compaction.tla:93-100); latestForKey is
        derivable from (messages, readPosition), so only the position
        is recorded."""
        valid = (
            (s.cstate == pyeval.PHASE_ONE) & (s.p1_present == 0)
            & (s.length > 0)
        )
        return valid, s._replace(
            p1_present=self._fill(s, 1),
            p1_readpos=s.length,
            cstate=self._fill(s, pyeval.PHASE_TWO_WRITE),
        )

    def _phase_two_write(self, s: SState):
        """CompactorPhaseTwoWrite (compaction.tla:121-132)."""
        new_id = self._max_led_id(s.led_present) + 1
        valid = (
            (s.p1_present == 1) & (s.cstate == pyeval.PHASE_TWO_WRITE)
            & (new_id <= self.C)
        )
        keep = self._compact_keep(s.keys, s.p1_readpos)
        slot = torch.clamp(new_id - 1, 0, max(self.C - 1, 0))
        onehot = (
            torch.arange(self.C, dtype=torch.int32, device=slot.device)
            == slot[:, None]
        )
        return valid, s._replace(
            led_present=torch.where(onehot, 1, s.led_present),
            led_bits=torch.where(onehot[:, :, None], keep[:, None, :],
                                 s.led_bits),
            cstate=self._fill(s, pyeval.PHASE_TWO_UPDATE_CONTEXT),
        )

    def _update_context(self, s: SState):
        """CompactorPhaseTwoUpdateContext (compaction.tla:135-139)."""
        return s.cstate == pyeval.PHASE_TWO_UPDATE_CONTEXT, s._replace(
            context=self._max_led_id(s.led_present),
            cstate=self._fill(s, pyeval.PHASE_TWO_UPDATE_HORIZON),
        )

    def _update_horizon(self, s: SState):
        """CompactorPhaseTwoUpdateHorizon (compaction.tla:141-145)."""
        return s.cstate == pyeval.PHASE_TWO_UPDATE_HORIZON, s._replace(
            horizon=s.p1_readpos,
            cstate=self._fill(s, pyeval.PHASE_TWO_PERSIST_CURSOR),
        )

    def _persist_cursor(self, s: SState):
        """CompactorPhaseTwoPersistCusror [sic] (compaction.tla:147-151)."""
        return s.cstate == pyeval.PHASE_TWO_PERSIST_CURSOR, s._replace(
            cursor_present=self._fill(s, 1),
            cursor_h=s.horizon,
            cursor_c=s.context,
            cstate=self._fill(s, pyeval.PHASE_TWO_DELETE_LEDGER),
        )

    def _delete_ledger(self, s: SState):
        """CompactorPhaseTwoDeleteLedger (compaction.tla:153-165): drops
        the second-to-last compacted ledger, back to PhaseOne."""
        max_id = self._max_led_id(s.led_present)
        old_slot = torch.clamp(max_id - 2, 0, max(self.C - 1, 0))
        onehot = (
            torch.arange(self.C, dtype=torch.int32, device=max_id.device)
            == old_slot[:, None]
        ) & (max_id >= 2)[:, None]
        return s.cstate == pyeval.PHASE_TWO_DELETE_LEDGER, s._replace(
            led_present=torch.where(onehot, 0, s.led_present),
            led_bits=s.led_bits & ~onehot[:, :, None],
            cstate=self._fill(s, pyeval.PHASE_ONE),
            p1_present=self._fill(s, 0),
            p1_readpos=self._fill(s, 0),
        )

    def _broker_crash(self, s: SState):
        """BrokerCrash (compaction.tla:169-182): recovery from the
        durable cursor (0/0 without one)."""
        has_cursor = s.cursor_present == 1
        return s.crash < self.c.max_crash_times, s._replace(
            crash=s.crash + 1,
            cstate=self._fill(s, pyeval.PHASE_ONE),
            p1_present=self._fill(s, 0),
            p1_readpos=self._fill(s, 0),
            horizon=torch.where(has_cursor, s.cursor_h, 0),
            context=torch.where(has_cursor, s.cursor_c, 0),
        )

    def _producer_lanes(self, s: SState):
        """Producer (compaction.tla:83-87), all ``kv`` (inputKey,
        inputValue) lanes at once: ``[B, kv]``."""
        b, kv = s.length.shape[0], self.kv
        dev = s.length.device
        lane = torch.arange(kv, dtype=torch.int32, device=dev)
        key = lane // (self.c.num_values + 1)
        val = lane % (self.c.num_values + 1)
        at_new = (self._pos(dev) == (s.length + 1)[:, None])[:, None, :]
        lanes = smap(lambda x: x[:, None].expand(b, kv, *x.shape[1:]), s)
        valid = (s.length < self.M)[:, None].expand(b, kv)
        return valid, lanes._replace(
            length=lanes.length + 1,
            keys=torch.where(at_new, key[None, :, None], lanes.keys),
            vals=torch.where(at_new, val[None, :, None], lanes.vals),
        )

    def successors(self, s: SState) -> Tuple[SState, torch.Tensor]:
        """All non-stuttering Next lanes: ``(SState [B, A], valid
        bool[B, A])`` in the JAX model's lane order."""
        lanes: List[Tuple[torch.Tensor, SState]] = [
            self._phase_one(s),
            self._phase_two_write(s),
            self._update_context(s),
            self._update_horizon(s),
            self._persist_cursor(s),
            self._delete_ledger(s),
            self._broker_crash(s),
        ]
        valid = torch.stack([v for v, _ in lanes], dim=1)
        succ = smap(lambda *xs: torch.stack(xs, dim=1), *[t for _, t in lanes])
        if self.c.model_producer:
            pvalid, psucc = self._producer_lanes(s)
            valid = torch.cat([pvalid, valid], dim=1)
            succ = smap(lambda a, b: torch.cat([a, b], dim=1), psucc, succ)
        return succ, valid

    def stutter_enabled(self, s: SState) -> torch.Tensor:
        """Enabledness of the stuttering disjuncts (Consumer,
        compaction.tla:185-186; Terminating, 205-214), for deadlock."""
        return self.termination_goal(s) | self.c.model_consumer

    def termination_goal(self, s: SState) -> torch.Tensor:
        """The Termination property's body (compaction.tla:303-307)."""
        done = (
            (s.length == self.M)
            & (s.cstate == pyeval.PHASE_TWO_WRITE)
            & (self._max_led_id(s.led_present) == self.C)
        )
        if self.c.model_consumer:
            done = done & (s.consume == self.c.consume_times_limit)
        return done

    # ----------------------------- invariants (236-294); True = holds

    def type_safe(self, s: SState) -> torch.Tensor:
        """TypeSafe (compaction.tla:236-248)."""
        c = self.c
        live = self._pos(s.length.device)[None, :] <= s.length[:, None]
        msgs_ok = (
            ~live
            | ((s.keys >= 0) & (s.keys <= c.num_keys)
               & (s.vals >= 0) & (s.vals <= c.num_values))
        ).all(dim=1)
        # ledger entries are (id=position, key, value) drawn from
        # messages: well-typed iff every kept position is live
        in_prefix = (~s.led_bits | live[:, None, :]).all(dim=2)
        absent_clean = (s.led_present == 1) | ~s.led_bits.any(dim=2)
        led_ok = (in_prefix & absent_clean).all(dim=1)
        p1_ok = (s.p1_present == 0) | (
            (s.p1_readpos >= 1) & (s.p1_readpos <= s.length)
        )
        cursor_ok = (s.cursor_present == 0) | (
            (s.cursor_h >= 1) & (s.cursor_h <= self.M)
            & (s.cursor_c >= 1) & (s.cursor_c <= self.C)
        )
        ranges_ok = (
            (s.cstate >= 0) & (s.cstate <= 5)
            & (s.horizon >= 0) & (s.horizon <= self.M)
            & (s.context >= 0) & (s.context <= self.C)
            & (s.crash >= 0) & (s.crash <= c.max_crash_times)
        )
        return msgs_ok & led_ok & p1_ok & cursor_ok & ranges_ok

    def compacted_ledger_leak(self, s: SState) -> torch.Tensor:
        """CompactedLedgerLeak (compaction.tla:251-253): <= 2 live
        ledgers."""
        return s.led_present.sum(dim=1) <= 2

    def _context_ledger_bits(self, s: SState) -> torch.Tensor:
        """``bool[B, M]`` kept positions of
        compactedLedgers[compactedTopicContext]; all false when the
        context is 0 or the slot is Nil."""
        b = s.length.shape[0]
        if self.C == 0:
            return torch.zeros((b, self.M), dtype=torch.bool,
                               device=s.length.device)
        slot = torch.clamp(s.context - 1, 0, self.C - 1).to(torch.int64)
        rows = torch.arange(b, device=slot.device)
        present = (s.context >= 1) & (s.led_present[rows, slot] == 1)
        return s.led_bits[rows, slot] & present[:, None]

    def compaction_horizon_correctness(self, s: SState) -> torch.Tensor:
        """CompactionHorizonCorrectness (compaction.tla:259-274): every
        position ``i <= horizon`` that survives the null-key filter has
        a kept ledger position with the same key at ``j >= i``, i.e. the
        latest kept position of its key is ``>= i``."""
        pos = self._pos(s.length.device)
        led = self._context_ledger_bits(s)
        needed = (pos[None, :] <= s.horizon[:, None]) & (
            (s.keys != 0) | self.c.retain_null_key
        )
        latest_led = self._latest_per_key(s.keys, led)
        latest_null = torch.where(led & (s.keys == 0), pos, 0).amax(dim=1)
        lat_i = torch.where(
            s.keys == 0, latest_null[:, None],
            self._lookup_per_key(latest_led, s.keys),
        )
        return (~needed | (lat_i >= pos)).all(dim=1)

    def duplicate_null_key_message(self, s: SState) -> torch.Tensor:
        """DuplicateNullKeyMessage (compaction.tla:280-294): violated
        iff a kept null-key position of the context ledger lies beyond
        the horizon."""
        if not self.c.retain_null_key:
            return torch.ones_like(s.length, dtype=torch.bool)
        pos = self._pos(s.length.device)
        led = self._context_ledger_bits(s)
        dup = (led & (s.keys == 0) & (pos[None, :] > s.horizon[:, None])).any(
            dim=1
        )
        return ~((s.context != 0) & dup)

    @property
    def invariants(self) -> Dict[str, Callable[[SState], torch.Tensor]]:
        return {
            "TypeSafe": self.type_safe,
            "CompactedLedgerLeak": self.compacted_ledger_leak,
            "CompactionHorizonCorrectness":
                self.compaction_horizon_correctness,
            "DuplicateNullKeyMessage": self.duplicate_null_key_message,
        }

    @property
    def liveness_goals(self) -> Dict[str, Callable[[SState], torch.Tensor]]:
        """Named ``<>goal`` predicates (``engine/liveness.py``)."""
        return {"Termination": self.termination_goal}

    # ------------------------------------------------------ trace replay

    def replay_trace(self, init_idx: int, lanes) -> Tuple[list, list]:
        """(pyeval.State list, action names) along a lane chain from
        initial state ``#init_idx``."""
        s0 = self.gen_initial(torch.tensor([init_idx], dtype=torch.int64))
        ps = self.to_pystate(s0)
        states, actions = [ps], []
        for lane in lanes:
            ps = self._apply_lane_py(ps, int(lane))
            states.append(ps)
            actions.append(pyeval.ACTION_NAMES[int(self.action_ids[lane])])
        return states, actions

    def _apply_lane_py(self, ps: pyeval.State, lane: int) -> pyeval.State:
        c = self.c
        if lane < self.n_producer_lanes:
            key = lane // (c.num_values + 1)
            val = lane % (c.num_values + 1)
            n = len(ps.messages)
            return ps._replace(messages=ps.messages + ((n + 1, key, val),))
        aid = int(self.action_ids[lane])
        for a, t in pyeval.successors(c, ps):
            if a == aid:
                return t
        raise RuntimeError(f"lane {lane} not enabled during replay")

    # ------------------------- conversions to/from the oracle's states

    def to_pystate(self, s: SState, b: int = 0) -> pyeval.State:
        """Row ``b`` of a batch -> pyeval.State."""
        f = {k: v[b].tolist() for k, v in s._asdict().items()}
        length = f["length"]
        messages = tuple(
            (i + 1, f["keys"][i], f["vals"][i]) for i in range(length)
        )
        ledgers = tuple(
            None
            if not f["led_present"][cc]
            else tuple(
                messages[j] for j in range(length) if f["led_bits"][cc][j]
            )
            for cc in range(self.C)
        )
        cursor = (
            (f["cursor_h"], f["cursor_c"]) if f["cursor_present"] else None
        )
        p1 = None
        if f["p1_present"]:
            rp = f["p1_readpos"]
            latest: dict = {}
            for j in range(1, rp + 1):
                k = f["keys"][j - 1]
                if k != 0:
                    latest[k] = j
            p1 = (rp, tuple(sorted(latest.items())))
        return pyeval.State(
            messages=messages,
            ledgers=ledgers,
            cursor=cursor,
            cstate=f["cstate"],
            p1=p1,
            horizon=f["horizon"],
            context=f["context"],
            crash=f["crash"],
            consume=f["consume"],
        )

    def _py_fields(self, ps: pyeval.State) -> dict:
        """pyeval.State -> the SState fields as Python values."""
        keys = [0] * self.M
        vals = [0] * self.M
        for i, (mid, k, v) in enumerate(ps.messages):
            if mid != i + 1:
                raise ValueError("message ids must be positional")
            keys[i], vals[i] = k, v
        led_present = [0] * self.C
        led_bits = [[False] * self.M for _ in range(self.C)]
        for cc, led in enumerate(ps.ledgers):
            if led is None:
                continue
            led_present[cc] = 1
            for mid, k, v in led:
                if ps.messages[mid - 1] != (mid, k, v):
                    raise ValueError("ledger entry must match the prefix")
                led_bits[cc][mid - 1] = True
        p1_present, p1_readpos = (1, ps.p1[0]) if ps.p1 else (0, 0)
        cur = (1, *ps.cursor) if ps.cursor else (0, 0, 0)
        return dict(
            length=len(ps.messages), keys=keys, vals=vals,
            led_present=led_present, led_bits=led_bits,
            cursor_present=cur[0], cursor_h=cur[1], cursor_c=cur[2],
            cstate=ps.cstate, p1_present=p1_present, p1_readpos=p1_readpos,
            horizon=ps.horizon, context=ps.context, crash=ps.crash,
            consume=ps.consume,
        )

    def _stack_pystates(self, states, device="cpu") -> SState:
        """pyeval.States -> one batch, stacked on the host."""
        rows = [self._py_fields(ps) for ps in states]
        n = len(rows)

        def col(name):
            a = np.asarray([r[name] for r in rows])
            if name == "led_bits":
                return torch.from_numpy(
                    a.astype(bool).reshape(n, self.C, self.M)).to(device)
            if name in ("keys", "vals"):
                a = a.reshape(n, self.M)
            elif name == "led_present":
                a = a.reshape(n, self.C)
            return torch.from_numpy(a.astype(np.int32)).to(device)

        return SState(*[col(f) for f in SState._fields])

    def from_pystate(self, ps: pyeval.State, device="cpu") -> SState:
        """pyeval.State -> a batch of one."""
        return self._stack_pystates([ps], device)

    # ------------------------------------------------- host-seeded starts

    SEED_PACK_CHUNK = 1 << 12

    def host_seed(self, max_level_states: int = 30_000,
                  max_total: int = 32_000):
        """A host-enumerated BFS prefix for ``DeviceChecker.run(seed=
        ...)``: the oracle expands the narrow early levels on the host.
        Returns ``(packed rows uint32 [n, W], parent gids int32, action
        lanes int32, level sizes)`` covering every BFS level that fits
        the caps (level-complete, so an engine takes over at the last
        included level's frontier); a root's parent is ``-1 - init
        index`` in ``gen_initial``'s order."""
        c = self.c
        states: list = []
        gid_of: dict = {}
        parents: list = []
        lanes: list = []
        lsizes: list = []
        for s in pyeval.initial_states(c):
            if s in gid_of:
                continue
            gid_of[s] = len(states)
            states.append(s)
            # gen_initial's mixed-radix index, not the enumeration
            # position (the oracle's first position is the most
            # significant digit, gen_initial's the least)
            parents.append(-1 - self._init_index_of(s))
            lanes.append(0)
            if len(states) > max_total:
                raise ValueError("initial-state set exceeds the seed caps")
        lsizes.append(len(states))
        frontier = list(states)
        while True:
            new = []
            over = False
            for s in frontier:
                sg = gid_of[s]
                any_succ = False
                for aid, t in pyeval.successors(c, s):
                    any_succ = True
                    if t in gid_of:
                        continue
                    gid_of[t] = len(states)
                    states.append(t)
                    parents.append(sg)
                    lanes.append(self._lane_of(aid, t))
                    new.append(t)
                if not any_succ:
                    raise ValueError(
                        "deadlock state inside the seed prefix — check "
                        "without a seed")
                if len(new) > max_level_states or len(states) > max_total:
                    # this level is dropped (seeds are level-complete):
                    # stop enumerating it now
                    over = True
                    break
            if not new:
                break
            if over:
                for t in new:
                    del gid_of[t]
                del states[-len(new):]
                del parents[-len(new):]
                del lanes[-len(new):]
                break
            lsizes.append(len(new))
            frontier = new
        return (self._pack_pystates(states), np.asarray(parents, np.int32),
                np.asarray(lanes, np.int32), lsizes)

    def _pack_pystates(self, states) -> np.ndarray:
        """pyeval.States -> packed rows (uint32 ``[n, W]``), stacked and
        packed on the host in chunks of :data:`SEED_PACK_CHUNK`."""
        n = len(states)
        out = np.zeros((n, self.layout.W), np.uint32)
        step = self.SEED_PACK_CHUNK
        for c0 in range(0, n, step):
            batch = self._stack_pystates(states[c0: c0 + step])
            out[c0: c0 + step] = self.layout.pack(batch).numpy().view(
                np.uint32)
        return out

    def _init_index_of(self, s: pyeval.State) -> int:
        """gen_initial index of an initial state (position i is the i-th
        least-significant base-|KeySet|*|ValueSet| digit)."""
        if self.c.model_producer:
            return 0
        idx = 0
        for i, (_mid, k, v) in enumerate(s.messages):
            idx += (k * (self.c.num_values + 1) + v) * (self.kv ** i)
        return idx

    def _lane_of(self, aid: int, child: pyeval.State) -> int:
        """Action id (and the produced child) -> successor lane."""
        if aid == 0:  # Producer: the lane encodes the (key, value)
            _mid, key, val = child.messages[-1]
            return key * (self.c.num_values + 1) + val
        return self.n_producer_lanes + (aid - 1)
