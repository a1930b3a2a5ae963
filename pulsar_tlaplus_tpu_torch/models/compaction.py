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

    def from_pystate(self, ps: pyeval.State, device="cpu") -> SState:
        """pyeval.State -> a batch of one."""
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

        def t(x, dtype=torch.int32):
            return torch.tensor([x], dtype=dtype, device=device)

        return SState(
            length=t(len(ps.messages)),
            keys=t(keys),
            vals=t(vals),
            led_present=t(led_present),
            led_bits=t(led_bits, torch.bool).reshape(1, self.C, self.M),
            cursor_present=t(cur[0]),
            cursor_h=t(cur[1]),
            cursor_c=t(cur[2]),
            cstate=t(ps.cstate),
            p1_present=t(p1_present),
            p1_readpos=t(p1_readpos),
            horizon=t(ps.horizon),
            context=t(ps.context),
            crash=t(ps.crash),
            consume=t(ps.consume),
        )
