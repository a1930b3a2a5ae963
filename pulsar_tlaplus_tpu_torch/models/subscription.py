"""The ``subscription`` spec as batched tensor code — the counterpart of
``pulsar_tlaplus_tpu/models/subscription.py`` (``specs/subscription.tla``:
Pulsar cursor ack/redelivery).

The JAX model is written for one state and ``vmap``-ped; here every
function takes a batch (:class:`SubState` with a leading ``[B]``).  The
per-message sets (delivered, pending, acked, everProcessed, duplicated)
are 0/1 vectors over message ids.  Successors build each field's
``[B, A, ...]`` plane at once: every lane starts as its source state and
each action writes its own slice of lanes, a per-message action at the
diagonal of an ``[M, M]`` identity.  Lanes: ``Publish | Deliver(m)*M |
Process(m)*M | SendAck(m)*M | AdvanceMarkDelete | ConsumerCrash``.
Every lane is computed as the JAX model computes it, valid or not, so
the packed planes are equal lane for lane; the one state-dependent index
(AdvanceMarkDelete's ``markDelete + 1``) is clamped where the JAX model
clamps it.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, NamedTuple, Tuple

import numpy as np
import torch

from pulsar_tlaplus_tpu_torch.ops.packing import (
    StructLayout,
    bitlen,
    lane_planes,
)


class SubState(NamedTuple):
    """A batch of subscription states (specs/subscription.tla
    VARIABLES); sets over message ids are 0/1 vectors indexed by id-1."""

    produced: torch.Tensor  # i32[*B]: 0..M
    delivered: torch.Tensor  # i32[*B, M]: in flight, not yet processed
    pending: torch.Tensor  # i32[*B, M]: processed, ack not on broker yet
    acked: torch.Tensor  # i32[*B, M]: individually acked past markDelete
    mark: torch.Tensor  # i32[*B]: markDelete position, 0..M
    ever: torch.Tensor  # i32[*B, M]: processed at least once
    dup: torch.Tensor  # i32[*B, M]: processed more than once
    crash: torch.Tensor  # i32[*B]: crashTimes


@dataclass(frozen=True)
class SubscriptionConstants:
    """CONSTANTS of subscription.tla."""

    message_limit: int = 3
    max_crash_times: int = 2

    def validate(self) -> None:
        if self.message_limit < 1:
            raise ValueError("MessageLimit >= 1 (subscription.tla ASSUME)")
        if self.max_crash_times < 0:
            raise ValueError("MaxCrashTimes \\in Nat (subscription.tla ASSUME)")


ACTION_NAMES = (
    "Publish",
    "Deliver",
    "Process",
    "SendAck",
    "AdvanceMarkDelete",
    "ConsumerCrash",
)

DEFAULT_INVARIANTS = ("TypeOK", "NoLostMessage", "AckedWasProcessed")


class SubscriptionModel:
    """Batched ``subscription`` spec for a fixed constants binding."""

    def __init__(self, c: SubscriptionConstants):
        c.validate()
        self.c = c
        self.M = m = c.message_limit
        mb = bitlen(m)
        self.layout = StructLayout(
            SubState,
            {
                "produced": ((), mb),
                "delivered": ((m,), 1),
                "pending": ((m,), 1),
                "acked": ((m,), 1),
                "mark": ((), mb),
                "ever": ((m,), 1),
                "dup": ((m,), 1),
                "crash": ((), bitlen(c.max_crash_times)),
            },
        )
        self.action_ids = np.array(
            [0] + [1] * m + [2] * m + [3] * m + [4, 5], dtype=np.int32
        )
        self.A = len(self.action_ids)
        self.action_names = ACTION_NAMES
        self.default_invariants = DEFAULT_INVARIANTS

    def _ids(self, device) -> torch.Tensor:
        return torch.arange(1, self.M + 1, dtype=torch.int32, device=device)

    # ------------------------------------------------- initial states

    @property
    def n_initial(self) -> int:
        return 1

    def gen_initial(self, idx: torch.Tensor) -> SubState:
        """The one Init state, once per index of ``idx``."""
        b, dev = idx.shape[0], idx.device

        def z(*shape):
            return torch.zeros((b, *shape), dtype=torch.int32, device=dev)

        m = self.M
        return SubState(z(), z(m), z(m), z(m), z(), z(m), z(m), z())

    # ---------------------------------------------------------- actions

    def successors(self, s: SubState) -> Tuple[SubState, torch.Tensor]:
        """All non-stuttering Next lanes: ``(SubState [B, A], valid
        bool[B, A])`` in the JAX model's lane order."""
        m, a = self.M, self.A
        dev = s.produced.device
        eye = torch.eye(m, dtype=torch.bool, device=dev)
        ids = self._ids(dev)
        deliver = slice(1, 1 + m)
        process = slice(1 + m, 1 + 2 * m)
        send_ack = slice(1 + 2 * m, 1 + 3 * m)
        advance, crash = 1 + 3 * m, 2 + 3 * m

        def put(plane, lanes, mask, v):
            plane[:, lanes] = torch.where(mask, v, plane[:, lanes])

        produced = lane_planes(s.produced, a)
        produced[:, 0] += 1
        delivered = lane_planes(s.delivered, a)
        put(delivered, deliver, eye, 1)
        put(delivered, process, eye, 0)
        delivered[:, crash] = 0
        pending = lane_planes(s.pending, a)
        put(pending, process, eye, 1)
        put(pending, send_ack, eye, 0)
        pending[:, crash] = 0
        acked = lane_planes(s.acked, a)
        put(acked, send_ack, eye, 1)
        # AdvanceMarkDelete: the 0-based index of id markDelete + 1
        nxt = torch.clamp(s.mark, 0, m - 1)
        at_nxt = (ids - 1)[None, :] == nxt[:, None]
        acked[:, advance] = torch.where(at_nxt, 0, s.acked)
        mark = lane_planes(s.mark, a)
        mark[:, advance] += 1
        ever = lane_planes(s.ever, a)
        put(ever, process, eye, 1)
        dup = lane_planes(s.dup, a)
        # duplicated gains m iff m was processed before (IF in Process)
        put(dup, process, eye, torch.maximum(s.dup, s.ever)[:, None, :])
        crashes = lane_planes(s.crash, a)
        crashes[:, crash] += 1
        valid = torch.cat([
            (s.produced < m)[:, None],
            (ids[None, :] <= s.produced[:, None])
            & (ids[None, :] > s.mark[:, None])
            & (s.delivered == 0) & (s.pending == 0) & (s.acked == 0),
            s.delivered == 1,
            s.pending == 1,
            ((s.mark < m)
             & ((s.acked == 1) & at_nxt).any(dim=1))[:, None],
            (s.crash < self.c.max_crash_times)[:, None],
        ], dim=1)
        succ = SubState(produced, delivered, pending, acked, mark, ever, dup,
                        crashes)
        return succ, valid

    def drained(self, s: SubState) -> torch.Tensor:
        """Drained == produced = MessageLimit /\\ markDelete =
        MessageLimit."""
        return (s.produced == self.M) & (s.mark == self.M)

    def stutter_enabled(self, s: SubState) -> torch.Tensor:
        """The terminating self-loop (drained end state)."""
        return self.drained(s)

    # ------------------------------------------ invariants; True = holds

    def type_ok(self, s: SubState) -> torch.Tensor:
        ids = self._ids(s.produced.device)
        bits_ok = torch.ones_like(s.produced, dtype=torch.bool)
        for v in (s.delivered, s.pending, s.acked, s.ever, s.dup):
            bits_ok = bits_ok & ((v == 0) | (v == 1)).all(dim=1)
        tracked = (s.delivered | s.pending | s.acked) == 1
        in_window = (ids[None, :] > s.mark[:, None]) & (
            ids[None, :] <= s.produced[:, None]
        )
        return (
            bits_ok
            & (s.produced >= 0) & (s.produced <= self.M)
            & (s.mark >= 0) & (s.mark <= s.produced)
            & (s.crash >= 0) & (s.crash <= self.c.max_crash_times)
            & (s.dup <= s.ever).all(dim=1)
            & (s.delivered + s.pending + s.acked <= 1).all(dim=1)
            & (~tracked | in_window).all(dim=1)
        )

    def no_lost_message(self, s: SubState) -> torch.Tensor:
        """Every id <= markDelete was processed at least once."""
        ids = self._ids(s.produced.device)
        return (~(ids[None, :] <= s.mark[:, None]) | (s.ever == 1)).all(dim=1)

    def acked_was_processed(self, s: SubState) -> torch.Tensor:
        return (((s.acked | s.pending) == 0) | (s.ever == 1)).all(dim=1)

    def exactly_once_processing(self, s: SubState) -> torch.Tensor:
        """VIOLATED whenever MaxCrashTimes >= 1 (at-least-once)."""
        return (s.dup == 0).all(dim=1)

    @property
    def invariants(self) -> Dict[str, Callable[[SubState], torch.Tensor]]:
        return {
            "TypeOK": self.type_ok,
            "NoLostMessage": self.no_lost_message,
            "AckedWasProcessed": self.acked_was_processed,
            "ExactlyOnceProcessing": self.exactly_once_processing,
        }

    @property
    def liveness_goals(self) -> Dict[str, Callable[[SubState], torch.Tensor]]:
        """Termination == <>Drained (subscription.tla)."""
        return {"Termination": self.drained}

    # ------------------------------------------------------ conversions

    def to_pystate(self, s: SubState, b: int = 0) -> dict:
        """Row ``b`` of a batch -> rendered {var: value}
        (``utils.render``'s dict protocol)."""
        f = {k: v[b].tolist() for k, v in s._asdict().items()}

        def fmt(bits):
            return "{" + ", ".join(
                str(i + 1) for i, x in enumerate(bits) if x
            ) + "}"

        return {
            "produced": f["produced"],
            "delivered": fmt(f["delivered"]),
            "pending": fmt(f["pending"]),
            "acked": fmt(f["acked"]),
            "markDelete": f["mark"],
            "everProcessed": fmt(f["ever"]),
            "duplicated": fmt(f["dup"]),
            "crashTimes": f["crash"],
        }

    def from_jax_state(self, fields, device="cpu") -> SubState:
        """The JAX model's state (its NamedTuple fields as numpy arrays,
        batched or not) -> a batch of this model's states."""
        return self.layout.from_numpy(fields, device)
