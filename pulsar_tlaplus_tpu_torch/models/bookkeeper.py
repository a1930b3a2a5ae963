"""The ``bookkeeper`` spec as batched tensor code — the counterpart of
``pulsar_tlaplus_tpu/models/bookkeeper.py`` (``specs/bookkeeper.tla``:
BookKeeper ledger write-quorum replication).

Per-(bookie, entry) storage and ack bits over a batch (:class:`BkState`
with a leading ``[B]``).  The round-robin write sets are one ``[L, E]``
mask, built once per device from index arithmetic.  Lanes:
``AddEntry | WriteLand(b, e)*E*L | AckArrive(b, e)*E*L | AdvanceLAC |
BookieCrash(b)*E``, the (b, e) lanes bookie-major.  WriteLand's lane
``b*L + e`` is the flat index of ``stored[b, e]``, so its writes are the
diagonal of an ``[E*L, E*L]`` identity; AckArrive's writes
``ackedBy[e, b]``, a permuted identity.  Every lane is computed as the
JAX model computes it, valid or not; the state-dependent row of entry
``lac + 1`` is clamped where the JAX model clamps it.
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


class BkState(NamedTuple):
    """A batch of bookkeeper states (specs/bookkeeper.tla VARIABLES)."""

    added: torch.Tensor  # i32[*B]: 0..L
    stored: torch.Tensor  # i32[*B, E, L]: entry e+1 persisted on bookie b+1
    acked_by: torch.Tensor  # i32[*B, L, E]: bookie b+1's ack for e+1 arrived
    lac: torch.Tensor  # i32[*B]: LastAddConfirmed, 0..L
    crashed: torch.Tensor  # i32[*B, E]


@dataclass(frozen=True)
class BookkeeperConstants:
    """CONSTANTS of bookkeeper.tla."""

    num_bookies: int = 3
    write_quorum: int = 2
    ack_quorum: int = 2
    entry_limit: int = 2
    max_bookie_crashes: int = 1

    def validate(self) -> None:
        if self.num_bookies < 1:
            raise ValueError("NumBookies >= 1 (bookkeeper.tla ASSUME)")
        if not 1 <= self.write_quorum <= self.num_bookies:
            raise ValueError("WriteQuorum \\in 1..NumBookies")
        if not 1 <= self.ack_quorum <= self.write_quorum:
            raise ValueError("AckQuorum \\in 1..WriteQuorum")
        if self.entry_limit < 1:
            raise ValueError("EntryLimit >= 1")
        if not 0 <= self.max_bookie_crashes <= self.num_bookies:
            raise ValueError("MaxBookieCrashes \\in 0..NumBookies")


ACTION_NAMES = (
    "AddEntry",
    "WriteLand",
    "AckArrive",
    "AdvanceLAC",
    "BookieCrash",
)

DEFAULT_INVARIANTS = (
    "TypeOK",
    "LacIsConfirmed",
    "AckImpliesStoredOrCrashed",
    "ConfirmedEntryReadable",
)


class BookkeeperModel:
    """Batched ``bookkeeper`` spec for a fixed constants binding."""

    def __init__(self, c: BookkeeperConstants):
        c.validate()
        self.c = c
        self.E, self.L = e, l = c.num_bookies, c.entry_limit
        self.layout = StructLayout(
            BkState,
            {
                "added": ((), bitlen(l)),
                "stored": ((e, l), 1),
                "acked_by": ((l, e), 1),
                "lac": ((), bitlen(l)),
                "crashed": ((e,), 1),
            },
        )
        self.action_ids = np.array(
            [0] + [1] * (e * l) + [2] * (e * l) + [3] + [4] * e,
            dtype=np.int32,
        )
        self.A = len(self.action_ids)
        self.action_names = ACTION_NAMES
        self.default_invariants = DEFAULT_INVARIANTS
        self._consts = {}

    def _on(self, device):
        """The binding's constant tensors on ``device``, built there by
        index arithmetic (no host upload) once per device:
        ``ws`` — WriteSet(e) == {((e-1+i) % E) + 1 : i \\in 0..Qw-1} as
        an i32 ``[L, E]`` mask; the entry and bookie of WriteLand/AckArrive
        lane ``i = b*L + e``; ``ack_at[i]`` — the flat index of
        ``ackedBy[e, b]``; ``ents`` — entry ids 1..L."""
        key = str(device)
        if key not in self._consts:
            e, l = self.E, self.L
            ent = torch.arange(l, device=device)
            bk = torch.arange(e, device=device)
            ws = ((bk[None, :] - ent[:, None]) % e
                  < self.c.write_quorum).to(torch.int32)
            i = torch.arange(e * l, device=device)
            lane_b, lane_e = i // l, i % l
            self._consts[key] = dict(
                ws=ws, lane_b=lane_b, lane_e=lane_e,
                ack_at=lane_e * e + lane_b,
                ents=torch.arange(1, l + 1, dtype=torch.int32,
                                  device=device),
            )
        return self._consts[key]

    # ------------------------------------------------- initial states

    @property
    def n_initial(self) -> int:
        return 1

    def gen_initial(self, idx: torch.Tensor) -> BkState:
        """The one Init state, once per index of ``idx``."""
        b, dev = idx.shape[0], idx.device

        def z(*shape):
            return torch.zeros((b, *shape), dtype=torch.int32, device=dev)

        return BkState(z(), z(self.E, self.L), z(self.L, self.E), z(),
                       z(self.E))

    # ---------------------------------------------------------- actions

    def _lac_row(self, s: BkState) -> torch.Tensor:
        """The 0-based row of entry lac+1, clamped as the JAX model does."""
        return torch.clamp(s.lac, 0, self.L - 1).to(torch.int64)

    def successors(self, s: BkState) -> Tuple[BkState, torch.Tensor]:
        """All non-stuttering Next lanes: ``(BkState [B, A], valid
        bool[B, A])`` in the JAX model's lane order."""
        e, l, a = self.E, self.L, self.A
        el = e * l
        dev = s.added.device
        k = self._on(dev)
        nb = s.added.shape[0]
        write = slice(1, 1 + el)
        ack = slice(1 + el, 1 + 2 * el)
        advance = 1 + 2 * el
        crash = slice(2 + 2 * el, 2 + 2 * el + e)
        stored = s.stored.reshape(nb, el)
        acked = s.acked_by.reshape(nb, el)
        flat = torch.arange(el, device=dev)

        added = lane_planes(s.added, a)
        added[:, 0] += 1
        st = lane_planes(stored, a)
        st[:, write] = torch.where(flat[None, :] == flat[:, None], 1,
                                   st[:, write])
        # BookieCrash(b) wipes bookie b's row
        st[:, crash] = torch.where(
            (flat // l)[None, :] == torch.arange(e, device=dev)[:, None], 0,
            st[:, crash],
        )
        ab = lane_planes(acked, a)
        ab[:, ack] = torch.where(flat[None, :] == k["ack_at"][:, None], 1,
                                 ab[:, ack])
        lac = lane_planes(s.lac, a)
        lac[:, advance] += 1
        crashed = lane_planes(s.crashed, a)
        crashed[:, crash] = torch.where(
            torch.eye(e, dtype=torch.bool, device=dev), 1, crashed[:, crash]
        )
        rows = torch.arange(nb, device=dev)
        n_acks = s.acked_by[rows, self._lac_row(s)].sum(dim=1)
        valid = torch.cat([
            (s.added < l)[:, None],
            (k["lane_e"][None, :] + 1 <= s.added[:, None])
            & (k["ws"].T.reshape(el) == 1)[None, :]
            & (s.crashed[:, k["lane_b"]] == 0)
            & (stored == 0),
            (stored == 1) & (acked[:, k["ack_at"]] == 0),
            ((s.lac < s.added) & (n_acks >= self.c.ack_quorum))[:, None],
            (s.crashed.sum(dim=1) < self.c.max_bookie_crashes)[:, None]
            & (s.crashed == 0),
        ], dim=1)
        succ = BkState(added, st.reshape(nb, a, e, l),
                       ab.reshape(nb, a, l, e), lac, crashed)
        return succ, valid

    def _wedged(self, s: BkState) -> torch.Tensor:
        """Wedged: entry lac+1 can never reach an ack quorum."""
        row = self._lac_row(s)
        rows = torch.arange(s.lac.shape[0], device=s.lac.device)
        acked = s.acked_by[rows, row]  # [B, E]
        live_ws = self._on(s.lac.device)["ws"][row] * (1 - s.crashed)
        reachable = torch.maximum(acked, live_ws).sum(dim=1)
        return (s.lac < s.added) & (reachable < self.c.ack_quorum)

    def done(self, s: BkState) -> torch.Tensor:
        """Done == added = EntryLimit /\\ (lac = EntryLimit \\/ Wedged)."""
        return (s.added == self.L) & ((s.lac == self.L) | self._wedged(s))

    def stutter_enabled(self, s: BkState) -> torch.Tensor:
        return self.done(s)

    # ------------------------------------------ invariants; True = holds

    def type_ok(self, s: BkState) -> torch.Tensor:
        k = self._on(s.added.device)
        ents, ws = k["ents"], k["ws"]
        bits_ok = torch.ones_like(s.added, dtype=torch.bool)
        for v in (s.stored, s.acked_by, s.crashed):
            bits_ok = bits_ok & ((v == 0) | (v == 1)).flatten(1).all(dim=1)
        added = s.added[:, None, None]
        stored_ok = ((s.stored == 0) | (
            (ents[None, None, :] <= added) & (ws.T == 1)[None]
        )).flatten(1).all(dim=1)
        acked_ok = ((s.acked_by == 0) | (
            (ents[None, :, None] <= added) & (ws == 1)[None]
        )).flatten(1).all(dim=1)
        crashed_clean = ((s.crashed[:, :, None] == 0) | (s.stored == 0)
                         ).flatten(1).all(dim=1)
        return (
            bits_ok
            & (s.added >= 0) & (s.added <= self.L)
            & (s.lac >= 0) & (s.lac <= s.added)
            & (s.crashed.sum(dim=1) <= self.c.max_bookie_crashes)
            & stored_ok & acked_ok & crashed_clean
        )

    def lac_is_confirmed(self, s: BkState) -> torch.Tensor:
        ents = self._on(s.added.device)["ents"]
        n_acks = s.acked_by.sum(dim=2)  # [B, L]
        return ((ents[None, :] > s.lac[:, None])
                | (n_acks >= self.c.ack_quorum)).all(dim=1)

    def ack_implies_stored_or_crashed(self, s: BkState) -> torch.Tensor:
        ok = ((s.acked_by.transpose(1, 2) == 0) | (s.stored == 1)
              | (s.crashed[:, :, None] == 1))
        return ok.flatten(1).all(dim=1)

    def confirmed_entry_readable(self, s: BkState) -> torch.Tensor:
        """VIOLATED when MaxBookieCrashes >= AckQuorum (durability)."""
        ents = self._on(s.added.device)["ents"]
        somewhere = (s.stored == 1).any(dim=1)  # [B, L]
        return ((ents[None, :] > s.lac[:, None]) | somewhere).all(dim=1)

    @property
    def invariants(self) -> Dict[str, Callable[[BkState], torch.Tensor]]:
        return {
            "TypeOK": self.type_ok,
            "LacIsConfirmed": self.lac_is_confirmed,
            "AckImpliesStoredOrCrashed": self.ack_implies_stored_or_crashed,
            "ConfirmedEntryReadable": self.confirmed_entry_readable,
        }

    @property
    def liveness_goals(self) -> Dict[str, Callable[[BkState], torch.Tensor]]:
        """Termination == <>Done (bookkeeper.tla)."""
        return {"Termination": self.done}

    # ------------------------------------------------------ conversions

    def to_pystate(self, s: BkState, b: int = 0) -> dict:
        """Row ``b`` of a batch -> rendered {var: value}
        (``utils.render``'s dict protocol)."""
        f = {k: v[b].tolist() for k, v in s._asdict().items()}

        def fset(bits):
            return "{" + ", ".join(
                str(i + 1) for i, x in enumerate(bits) if x
            ) + "}"

        def ftup(rows):
            return "<<" + ", ".join(fset(r) for r in rows) + ">>"

        return {
            "added": f["added"],
            "stored": ftup(f["stored"]),
            "ackedBy": ftup(f["acked_by"]),
            "lac": f["lac"],
            "crashed": fset(f["crashed"]),
        }

    def from_jax_state(self, fields, device="cpu") -> BkState:
        """The JAX model's state (its NamedTuple fields as numpy arrays,
        batched or not) -> a batch of this model's states."""
        return self.layout.from_numpy(fields, device)
