"""Device meshes for the sharded checker — the counterpart of
``pulsar_tlaplus_tpu/parallel/mesh.py`` (``make_mesh``, ``make_mesh2d``).

A mesh is a list of ``torch.device``, one per shard, in the ``(dcn,
ici)`` order of the JAX grid: shard ``s`` sits at slice ``s // I``, chip
``s % I``.  One controller drives every shard, as the JAX engine's one
program over a ``Mesh`` does: each shard's tensors live on
``devices[s]``, and the host issues each shard's launches on its device
in turn.  :meth:`Mesh.all_to_all` is the exchange between shards (the
JAX ``lax.all_to_all`` with one block per peer): on one device it is
slicing and a copy, between cards a peer copy.

**A device may repeat**, which the JAX mesh does not allow (its
``make_mesh`` raises when ``n`` exceeds the devices present; its tests
force 8 virtual CPU devices instead).  Here N shards can live on the
CPU, on one card, or one to a card: by default shard ``s`` goes to card
``s % torch.cuda.device_count()``, so N shards share the cards present.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch

from pulsar_tlaplus_tpu_torch.utils import device as device_mod

AXIS = "shard"
DCN_AXIS = "dcn"  # across slices
ICI_AXIS = "ici"  # within a slice


class Mesh:
    """``D x I`` shards on ``devices`` (length ``D * I``, in (dcn, ici)
    order).  ``axes`` is ``("shard",)`` for one slice, ``("dcn",
    "ici")`` for several."""

    def __init__(self, devices: Sequence[torch.device], n_slices: int = 1):
        self.devices: List[torch.device] = [torch.device(d)
                                             for d in devices]
        n = len(self.devices)
        if n < 1 or n % n_slices:
            raise ValueError("n_devices must be divisible by n_slices")
        self.N, self.D, self.I = n, n_slices, n // n_slices
        self.axes = (DCN_AXIS, ICI_AXIS) if n_slices > 1 else (AXIS,)

    def groups(self, axis: str = AXIS) -> List[List[int]]:
        """The shard groups that exchange along ``axis``, each in block
        order: every shard for ``"shard"``, a slice's chips for
        ``"ici"``, the chips of one index across slices for ``"dcn"``."""
        D, I = self.D, self.I
        if axis == AXIS:
            return [list(range(self.N))]
        if axis == ICI_AXIS:
            return [[d * I + i for i in range(I)] for d in range(D)]
        if axis == DCN_AXIS:
            return [[d * I + i for d in range(D)] for i in range(I)]
        raise ValueError(f"unknown mesh axis {axis!r}")

    def all_to_all(self, send: Sequence[torch.Tensor],
                   axis: str = AXIS) -> List[torch.Tensor]:
        """``send[s]`` is shard ``s``'s tensor with one leading block per
        peer of its group; returns ``recv`` with ``recv[d]`` on
        ``devices[d]``: block ``k`` of it is block ``pos(d)`` of the
        ``k``-th shard of the group (``lax.all_to_all(split_axis=0,
        concat_axis=0, tiled=False)``: block ``d`` of producer ``s``
        lands as block ``s`` of receiver ``d``)."""
        recv: List[Optional[torch.Tensor]] = [None] * self.N
        for grp in self.groups(axis):
            for pos, d in enumerate(grp):
                dev = self.devices[d]
                recv[d] = torch.stack([
                    send[s][pos].to(dev, non_blocking=True) for s in grp
                ])
        return recv  # type: ignore[return-value]

    def distinct_devices(self) -> List[torch.device]:
        out: List[torch.device] = []
        for d in self.devices:
            if d not in out:
                out.append(d)
        return out


def _devices(n: int, devices=None) -> List[torch.device]:
    """``n`` devices: ``devices`` cycled (a device or a list of them),
    or, by default, the cards present (``cuda:s % count``; raises when
    there is none)."""
    if devices is None or isinstance(devices, (str, torch.device)):
        base = device_mod.resolve(devices)
        if base.type == "cpu":
            return [base] * n
        if devices is None:
            count = torch.cuda.device_count()
            return [torch.device("cuda", s % count) for s in range(n)]
        return [base] * n
    devs = [device_mod.resolve(d) for d in devices]
    if not devs:
        raise ValueError("empty device list")
    return [devs[s % len(devs)] for s in range(n)]


def make_mesh(n_devices: Optional[int] = None, devices=None) -> Mesh:
    """A 1-D mesh of ``n_devices`` shards (default: one a card present)
    on ``devices`` (see module doc: a device may repeat)."""
    if n_devices is None:
        if devices is None:
            n_devices = max(torch.cuda.device_count(), 1)
        elif isinstance(devices, (str, torch.device)):
            n_devices = 1
        else:
            n_devices = len(devices)
    return Mesh(_devices(n_devices, devices))


def make_mesh2d(n_slices: int, per_slice: int, devices=None) -> Mesh:
    """A ``(dcn, ici)`` grid of ``n_slices x per_slice`` shards (one
    slice: the 1-D mesh); the sharded checker routes keys over it owner
    slice first, then owner chip."""
    return Mesh(_devices(n_slices * per_slice, devices), n_slices)
