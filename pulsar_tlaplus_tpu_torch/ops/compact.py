"""Order-preserving stream compaction — the counterpart of
``pulsar_tlaplus_tpu/ops/compact.py`` (``validate_impl``,
``compact_by_flag``, ``compact_rows``).

Two exact implementations, as in the JAX package (``compact_impl``):

- ``"logshift"`` (the default): an exclusive prefix sum of the keep flags
  gives every kept element its destination; one scatter writes the
  original index there and the columns follow by gather.  Dropped
  elements all scatter to one trash slot past the end, so the only
  duplicate indices of the scatter land where nothing is read.  (The
  JAX package's doubling shifts and binary-search gather are two
  materializations of this prefix sum; one scatter is both here.)
- ``"sort"``: a stable sort of the drop flags, the JAX package's
  single-key sort kept for differential runs.

Only the kept prefix is defined; the tail is don't-care.  No host sync.
"""

from __future__ import annotations

from typing import Tuple

import torch

IMPLS = ("logshift", "sort")


def validate_impl(impl: str) -> str:
    """The one ``compact_impl`` membership check."""
    if impl not in IMPLS:
        raise ValueError(
            f"compact_impl must be {'|'.join(IMPLS)}: {impl}"
        )
    return impl


def compact_by_flag(drop: torch.Tensor, cols,
                    impl: str = "logshift") -> Tuple[tuple, torch.Tensor]:
    """Move the entries of ``cols`` (each indexed by the leading axis)
    whose ``drop`` flag is 0 to the front, in original order.  Returns
    ``(compacted cols, idx)`` with ``idx[j]`` the original row of
    position ``j`` (valid in the kept prefix)."""
    keep = drop == 0
    n = keep.shape[0]
    if validate_impl(impl) == "sort":
        idx = torch.sort((~keep).to(torch.int8), stable=True).indices
        return tuple(c[idx] for c in cols), idx
    dest = torch.where(keep, torch.cumsum(keep, 0) - 1, n)
    idx = torch.zeros((n + 1,), dtype=torch.int64, device=keep.device)
    idx.scatter_(0, dest, torch.arange(n, device=keep.device))
    idx = idx[:n]
    return tuple(c[idx] for c in cols), idx


def compact_rows(
    rows: torch.Tensor, flag_keep: torch.Tensor, impl: str = "logshift"
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Compact a row-major ``[N, W]`` packed-row matrix to the front
    where ``flag_keep`` (bool) is set — the append's compaction step.
    Returns ``(compacted [N, W], idx)``."""
    (crows,), idx = compact_by_flag(~flag_keep, (rows,), impl)
    return crows, idx
