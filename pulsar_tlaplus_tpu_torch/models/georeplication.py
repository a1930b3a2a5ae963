"""The ``georeplication`` spec as batched tensor code — the counterpart of
``pulsar_tlaplus_tpu/models/georeplication.py``
(``specs/georeplication.tla``: Pulsar geo-replication over a full
cluster mesh).

Per-(src, dst) replicator cursors, durable ack positions and delivery
watermarks as ``[N, N]`` integer matrices, and per-pair duplicated-seqno
bits ``[N, N, P]``, over a batch (:class:`GeoState` with a leading
``[B]``).  Lanes: ``Publish(c)*N | Replicate(s, d)*N(N-1) |
PersistCursor(s, d)*N(N-1) | ReplicatorCrash(s, d)*N(N-1)``, the pairs
``s != d`` source-major.  A pair lane reads and writes its matrix cells
through their flat indices (built once per device from index
arithmetic) and one-hot masks over the flattened fields.  Every lane is
computed as the JAX model computes it, valid or not; Replicate's
state-dependent seqno index is clamped where the JAX model clamps it.
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


class GeoState(NamedTuple):
    """A batch of georeplication states (specs/georeplication.tla)."""

    published: torch.Tensor  # i32[*B, N]: messages originated at c+1
    recv_hwm: torch.Tensor  # i32[*B, N, N]: [dst, src] delivery watermark
    rep_cursor: torch.Tensor  # i32[*B, N, N]: [src, dst] read position
    rep_acked: torch.Tensor  # i32[*B, N, N]: [src, dst] durable position
    duplicated: torch.Tensor  # i32[*B, N, N, P]: [dst, src, seq-1] 0/1
    crash: torch.Tensor  # i32[*B]: crashTimes


@dataclass(frozen=True)
class GeoConstants:
    """CONSTANTS of georeplication.tla."""

    num_clusters: int = 3
    publish_limit: int = 1
    max_replicator_crashes: int = 1

    def validate(self) -> None:
        if self.num_clusters < 2:
            raise ValueError("NumClusters >= 2 (georeplication.tla ASSUME)")
        if self.publish_limit < 1:
            raise ValueError("PublishLimit >= 1")
        if self.max_replicator_crashes < 0:
            raise ValueError("MaxReplicatorCrashes \\in Nat")


ACTION_NAMES = (
    "Publish",
    "Replicate",
    "PersistCursor",
    "ReplicatorCrash",
)

DEFAULT_INVARIANTS = ("TypeOK", "CursorWithinWatermark", "NoPhantomMessages")


class GeoreplicationModel:
    """Batched ``georeplication`` spec for a fixed constants binding."""

    def __init__(self, c: GeoConstants):
        c.validate()
        self.c = c
        self.N, self.P = n, p = c.num_clusters, c.publish_limit
        pb = bitlen(p)
        self.layout = StructLayout(
            GeoState,
            {
                "published": ((n,), pb),
                "recv_hwm": ((n, n), pb),
                "rep_cursor": ((n, n), pb),
                "rep_acked": ((n, n), pb),
                "duplicated": ((n, n, p), 1),
                "crash": ((), bitlen(c.max_replicator_crashes)),
            },
        )
        self.pairs = [(s, d) for s in range(n) for d in range(n) if s != d]
        np_ = len(self.pairs)
        self.action_ids = np.array(
            [0] * n + [1] * np_ + [2] * np_ + [3] * np_, dtype=np.int32
        )
        self.A = len(self.action_ids)
        self.action_names = ACTION_NAMES
        self.default_invariants = DEFAULT_INVARIANTS
        self._consts = {}

    def _on(self, device):
        """The pair lanes' index tensors on ``device``, built there by
        index arithmetic (no host upload) once per device: ``src`` and
        ``dst`` of pair ``j`` (source-major, ``dst != src``), ``sd`` the
        flat index of cell ``[src, dst]``, ``ds`` of ``[dst, src]``,
        ``at_sd``/``at_ds`` their one-hot rows over the ``N*N`` cells,
        and the ``[N, N]`` identity ``eye``."""
        key = str(device)
        if key not in self._consts:
            n = self.N
            j = torch.arange(n * (n - 1), device=device)
            src, r = j // (n - 1), j % (n - 1)
            dst = r + (r >= src).long()
            sd, ds = src * n + dst, dst * n + src
            cells = torch.arange(n * n, device=device)
            self._consts[key] = dict(
                src=src, sd=sd, ds=ds,
                at_sd=cells[None, :] == sd[:, None],
                at_ds=cells[None, :] == ds[:, None],
                eye=torch.eye(n, dtype=torch.bool, device=device),
            )
        return self._consts[key]

    # ------------------------------------------------- initial states

    @property
    def n_initial(self) -> int:
        return 1

    def gen_initial(self, idx: torch.Tensor) -> GeoState:
        """The one Init state, once per index of ``idx``."""
        b, dev = idx.shape[0], idx.device
        n, p = self.N, self.P

        def z(*shape):
            return torch.zeros((b, *shape), dtype=torch.int32, device=dev)

        return GeoState(z(n), z(n, n), z(n, n), z(n, n), z(n, n, p), z())

    # ---------------------------------------------------------- actions

    def successors(self, s: GeoState) -> Tuple[GeoState, torch.Tensor]:
        """All non-stuttering Next lanes: ``(GeoState [B, A], valid
        bool[B, A])`` in the JAX model's lane order."""
        n, p, a = self.N, self.P, self.A
        npairs = len(self.pairs)
        dev = s.crash.device
        k = self._on(dev)
        nb = s.crash.shape[0]
        pub = slice(0, n)
        rep = slice(n, n + npairs)
        persist = slice(n + npairs, n + 2 * npairs)
        crash = slice(n + 2 * npairs, n + 3 * npairs)
        hwm_f = s.recv_hwm.reshape(nb, n * n)
        cur_f = s.rep_cursor.reshape(nb, n * n)
        ack_f = s.rep_acked.reshape(nb, n * n)
        dup_f = s.duplicated.reshape(nb, n * n * p)
        at_sd = k["at_sd"][None]

        published = lane_planes(s.published, a)
        published[:, pub] = torch.where(
            k["eye"], s.published[:, None, :] + 1, published[:, pub]
        )
        # Replicate(src, dst): seqno cur + 1 lands at dst
        cur = cur_f[:, k["sd"]]  # [B, pairs]
        nxt = cur + 1
        hwm = hwm_f[:, k["ds"]]
        seq = torch.clamp(cur, 0, p - 1)  # 0-based index of seqno nxt
        dup_at = k["ds"][None, :] * p + seq.long()
        dup_bit = torch.where(nxt <= hwm, 1, dup_f.gather(1, dup_at))
        ack = ack_f[:, k["sd"]]
        cursor = lane_planes(cur_f, a)
        cursor[:, rep] = torch.where(at_sd, nxt[:, :, None], cursor[:, rep])
        cursor[:, crash] = torch.where(at_sd, ack[:, :, None],
                                       cursor[:, crash])
        recv = lane_planes(hwm_f, a)
        recv[:, rep] = torch.where(
            k["at_ds"][None], torch.maximum(hwm, nxt)[:, :, None],
            recv[:, rep],
        )
        dup = lane_planes(dup_f, a)
        at_dup = (torch.arange(n * n * p, device=dev)[None, None, :]
                  == dup_at[:, :, None])
        dup[:, rep] = torch.where(at_dup, dup_bit[:, :, None], dup[:, rep])
        acked = lane_planes(ack_f, a)
        acked[:, persist] = torch.where(at_sd, cur[:, :, None],
                                        acked[:, persist])
        crashes = lane_planes(s.crash, a)
        crashes[:, crash] += 1
        behind = ack < cur
        valid = torch.cat([
            s.published < p,
            cur < s.published[:, k["src"]],
            behind,
            (s.crash < self.c.max_replicator_crashes)[:, None] & behind,
        ], dim=1)
        succ = GeoState(
            published, recv.reshape(nb, a, n, n),
            cursor.reshape(nb, a, n, n), acked.reshape(nb, a, n, n),
            dup.reshape(nb, a, n, n, p), crashes,
        )
        return succ, valid

    def done(self, s: GeoState) -> torch.Tensor:
        """Done: all published and every replicator fully caught up."""
        off = ~self._on(s.crash.device)["eye"]
        p = self.P
        return (
            (s.published == p).all(dim=1)
            & (torch.where(off, s.rep_cursor, p) == p).flatten(1).all(dim=1)
            & (torch.where(off, s.rep_acked, p) == p).flatten(1).all(dim=1)
        )

    def stutter_enabled(self, s: GeoState) -> torch.Tensor:
        return self.done(s)

    # ------------------------------------------ invariants; True = holds

    def type_ok(self, s: GeoState) -> torch.Tensor:
        eye = self._on(s.crash.device)["eye"]
        off = ~eye

        def all_(x):
            return x.flatten(1).all(dim=1)

        diag_zero = (
            all_(torch.where(eye, s.recv_hwm, 0) == 0)
            & all_(torch.where(eye, s.rep_cursor, 0) == 0)
            & all_(torch.where(eye, s.rep_acked, 0) == 0)
            & all_(torch.where(eye[:, :, None], s.duplicated, 0) == 0)
        )
        seqs = torch.arange(1, self.P + 1, dtype=torch.int32,
                            device=s.crash.device)
        dup_in_hwm = all_(
            (s.duplicated == 0)
            | (seqs[None, None, None, :] <= s.recv_hwm[..., None])
        )
        # rep_cursor/rep_acked are [src, dst]: bound by the source's
        # published count; recv_hwm is [dst, src]
        pub_src = s.published[:, :, None]
        cells_ok = all_(~off | (
            (s.rep_cursor >= 0) & (s.rep_cursor <= pub_src)
            & (s.rep_acked >= 0) & (s.rep_acked <= s.rep_cursor)
            & (s.recv_hwm >= 0) & (s.recv_hwm <= s.published[:, None, :])
        ))
        return (
            ((s.published >= 0) & (s.published <= self.P)).all(dim=1)
            & diag_zero
            & cells_ok
            & all_((s.duplicated == 0) | (s.duplicated == 1))
            & dup_in_hwm
            & (s.crash >= 0)
            & (s.crash <= self.c.max_replicator_crashes)
        )

    def cursor_within_watermark(self, s: GeoState) -> torch.Tensor:
        """repCursor[src][dst] <= recvHwm[dst][src] for all src # dst."""
        off = ~self._on(s.crash.device)["eye"]
        ok = ~off | (s.rep_cursor <= s.recv_hwm.transpose(1, 2))
        return ok.flatten(1).all(dim=1)

    def no_phantom_messages(self, s: GeoState) -> torch.Tensor:
        """recvHwm[dst][src] <= published[src]."""
        off = ~self._on(s.crash.device)["eye"]
        ok = ~off | (s.recv_hwm <= s.published[:, None, :])
        return ok.flatten(1).all(dim=1)

    def no_duplicate_delivery(self, s: GeoState) -> torch.Tensor:
        """VIOLATED whenever MaxReplicatorCrashes >= 1 (at-least-once)."""
        return (s.duplicated == 0).flatten(1).all(dim=1)

    @property
    def invariants(self) -> Dict[str, Callable[[GeoState], torch.Tensor]]:
        return {
            "TypeOK": self.type_ok,
            "CursorWithinWatermark": self.cursor_within_watermark,
            "NoPhantomMessages": self.no_phantom_messages,
            "NoDuplicateDelivery": self.no_duplicate_delivery,
        }

    @property
    def liveness_goals(self) -> Dict[str, Callable[[GeoState], torch.Tensor]]:
        """Termination == <>Done (georeplication.tla)."""
        return {"Termination": self.done}

    # ------------------------------------------------------ conversions

    def to_pystate(self, s: GeoState, b: int = 0) -> dict:
        """Row ``b`` of a batch -> rendered {var: value}
        (``utils.render``'s dict protocol)."""
        f = {k: v[b].tolist() for k, v in s._asdict().items()}

        def tup(items):
            return "<<" + ", ".join(items) + ">>"

        def fint(row):
            return tup(str(x) for x in row)

        def fset(bits):
            return "{" + ", ".join(
                str(i + 1) for i, x in enumerate(bits) if x
            ) + "}"

        return {
            "published": fint(f["published"]),
            "recvHwm": tup(fint(r) for r in f["recv_hwm"]),
            "repCursor": tup(fint(r) for r in f["rep_cursor"]),
            "repAcked": tup(fint(r) for r in f["rep_acked"]),
            "duplicated": tup(tup(fset(x) for x in r)
                              for r in f["duplicated"]),
            "crashTimes": f["crash"],
        }

    def from_jax_state(self, fields, device="cpu") -> GeoState:
        """The JAX model's state (its NamedTuple fields as numpy arrays,
        batched or not) -> a batch of this model's states."""
        return self.layout.from_numpy(fields, device)
