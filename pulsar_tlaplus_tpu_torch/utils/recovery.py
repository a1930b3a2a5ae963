"""Device-memory exhaustion recovery — the counterpart of
``pulsar_tlaplus_tpu/utils/recovery.py``.

::

               device memory exhausted
      RUNNING ─────────────────────────► frame on disk, armed?
         ▲                                   │yes           │no
         │  rebuild from the frame at        ▼              ▼
         │  DEGRADED capacity:          RECOVERING     truncate honestly
         │  - growth headroom frozen         │          (stop_reason="hbm")
         └───────────────────────────────────┘

- :func:`is_resource_exhausted` decides whether an exception is an
  allocator failure: a ``torch.OutOfMemoryError`` (the CUDA caching
  allocator's "CUDA out of memory"), recognised by its type, or the
  ``PTT_FAULT=oom@...`` drill, whose text carries ``RESOURCE_EXHAUSTED``.
- :class:`HbmExhausted` is raised by a level loop when exhaustion hits
  while a valid frame exists.  The rebuild happens outside the
  ``except`` block that catches it: the traceback pins the loop's
  tensors, and restoring under it would run out of memory again.  The
  engine also empties PyTorch's cache of freed blocks before the
  restore allocates.
- :class:`RecoveryState` keeps the armed / recovered / degraded state.
  "Armed" means the frame on disk is valid and no recovery has consumed
  it since; a second exhaustion without a fresh frame in between
  truncates instead of looping.  Degrading freezes the growth headroom
  at one window.
"""

from __future__ import annotations

import os
from typing import List, Optional

import torch


def is_resource_exhausted(e: BaseException) -> bool:
    """True for an allocator failure (``torch.OutOfMemoryError``) and
    for the ``PTT_FAULT`` oom drill."""
    return (isinstance(e, torch.OutOfMemoryError)
            or "RESOURCE_EXHAUSTED" in str(e))


class HbmExhausted(Exception):
    """Control flow: device memory ran out while a valid frame exists.
    ``nv`` and ``level_sizes`` are what the interrupted attempt had
    verified (reported if the rebuild itself fails)."""

    def __init__(self, nv: int, level_sizes: List[int], msg: str):
        super().__init__(msg)
        self.nv = nv
        self.level_sizes = level_sizes
        self.msg = msg


class RecoveryState:
    """Armed / recovered / degraded bookkeeping of one checker."""

    def __init__(self, checkpoint_path: Optional[str]):
        self.checkpoint_path = checkpoint_path
        self.reset()

    def reset(self) -> None:
        """A fresh run inherits no degraded capacity or counts."""
        self.hbm_recovered = 0
        self.armed = False
        self.headroom_frozen = False

    def arm(self) -> None:
        """A resumable frame reached disk (or a resume started from
        one)."""
        self.armed = True

    def can_recover(self) -> bool:
        return (self.armed and self.checkpoint_path is not None
                and os.path.exists(self.checkpoint_path))

    def degrade(self) -> None:
        """Consume the armed frame and degrade capacity: count the
        recovery, freeze the headroom."""
        self.hbm_recovered += 1
        self.armed = False
        self.headroom_frozen = True
