"""Deterministic fault injection — the port's copy of the ``PTT_FAULT``
parser of ``pulsar_tlaplus_tpu/utils/faults.py``.

Survivability tests need interruptions whose point is exact and
repeatable: "the process died at level 5", "device memory ran out at
level 7".  ``PTT_FAULT`` names synthetic faults fired at host-side sites
the engines advance:

    PTT_FAULT=oom@level:7           synthetic device-memory exhaustion
    PTT_FAULT=oom@flush:3           same, at the flush site
    PTT_FAULT=fpset_fail@flush:3    visited-table probe overflow (fail-stop)
    PTT_FAULT=kill@level:5          hard process death (os._exit 137)
    PTT_FAULT=sigterm@level:4       SIGTERM to self (preemption drill)
    PTT_FAULT=ckpt_fail@frame:1     transient OSError on frame 1's write
    PTT_FAULT=enospc@spill:1        spill write 1 fails with ENOSPC
    PTT_FAULT=kill@sweep:3          the liveness sweep's chunk 3
    PTT_FAULT=kill@segment:2        the simulator's segment epoch 2
    PTT_FAULT=drop@conn:3           the daemon withholds connection 3's reply
    PTT_FAULT=torn@line:5           the daemon writes half of protocol
                                    line 5, then closes
    PTT_FAULT=enospc@persist:2      queue.json snapshot 2 fails with ENOSPC
    PTT_FAULT=corrupt@warm:1        warm-artifact verification 1 computes
                                    a corrupted digest (cold fallback)
    PTT_FAULT=torn@warmwrite:2      warm-artifact write 2 publishes half
                                    a manifest (kill@warmwrite: dies
                                    between frame and manifest)
    PTT_FAULT=partition@backend:3   the dispatcher's backend poll 3's
                                    backend turns unreachable (alive,
                                    partitioned) for a drain-length window
    PTT_FAULT=slow@conn:2           the dispatcher's outbound poll 2 stalls
                                    past its timeout (a hung backend)
    PTT_FAULT=flap@backend:5        backend poll 5's backend starts a
                                    die/return cycle (drain, one clean
                                    poll, drain again: the readmission
                                    hysteresis drill)
    PTT_FAULT=oom@level:7,kill@level:9   comma-separated specs compose

Syntax ``kind@site:count``.  The sites the port's engines advance:
``level`` (the BFS level about to be expanded; level 1 is the initial
states), ``flush`` (the flush sequence number), ``frame`` (the checkpoint
frame sequence number), ``spill`` (the tiered store's spill-write
sequence), ``sweep`` (the liveness sweep's chunk) and ``segment`` (the
simulator's segment epoch).  The daemon (``service/``) and the warm store
(``warm/store.py``) advance ``conn`` (accepted connections), ``line``
(protocol lines sent), ``persist`` (queue.json snapshots; the
dispatcher's fleet_jobs.json snapshots too), ``warm`` (artifact
verifications) and ``warmwrite`` (artifact writes).  The fleet's
registry (``fleet/registry.py``) advances ``backend`` (every individual
backend health poll) and ``conn`` (its outbound polls, for ``slow``), and
realizes ``partition``, ``slow`` and ``flap`` there.  The same string
parses to the same schedule as in the JAX package.  Each spec fires at
most once per process, so a run that recovers from an injected fault and
re-runs the same level is not injected again.

``kill`` and ``sigterm`` are performed inside :func:`poll`; every other
kind is returned for the caller to realize (``oom`` as
:func:`oom_error`, which the engines' device-memory handler takes for a
real allocator failure).  Everything is inert unless ``PTT_FAULT`` is
set: one environment read a poll.
"""

from __future__ import annotations

import os
from typing import Callable, List, Optional, Set, Tuple

# telemetry observer: called as (kind, site, count) for every spec that
# fires, BEFORE the fault is realized — a ``kill`` leaves no other
# trace, so the breadcrumb must reach the (line-buffered) stream first.
# Engines install it for the duration of a run.
_observer: Optional[Callable[[str, str, int], None]] = None


def set_observer(fn: Optional[Callable[[str, str, int], None]]) -> None:
    global _observer
    _observer = fn


class FaultError(RuntimeError):
    """An injected fault.  ``oom`` faults carry ``RESOURCE_EXHAUSTED`` in
    their text, which ``utils/recovery.is_resource_exhausted`` takes for
    an allocator failure."""


KINDS = (
    "oom", "fpset_fail", "kill", "sigterm", "ckpt_fail",
    "drop", "torn", "enospc", "corrupt", "partition", "slow", "flap",
)

# parse cache keyed on the raw value, and the fired spec indexes (per
# process; a changed PTT_FAULT re-arms everything)
_cache_raw: str = ""
_cache_specs: List[Tuple[str, str, int]] = []
_fired: Set[int] = set()


def reset() -> None:
    """Re-arm every spec (tests that reuse one process)."""
    global _cache_raw
    _cache_raw = ""
    _fired.clear()


def specs() -> List[Tuple[str, str, int]]:
    """The parsed schedule ``[(kind, site, count), ...]`` of the current
    ``PTT_FAULT`` value; raises ValueError on a malformed spec."""
    global _cache_raw, _cache_specs
    raw = os.environ.get("PTT_FAULT", "")
    if raw == _cache_raw:
        return _cache_specs
    out: List[Tuple[str, str, int]] = []
    for part in raw.split(","):
        part = part.strip()
        if not part:
            continue
        try:
            kind, rest = part.split("@", 1)
            site, count = rest.split(":", 1)
            kind, site, n = kind.strip(), site.strip(), int(count)
        except ValueError:
            raise ValueError(
                f"bad PTT_FAULT spec {part!r} (want kind@site:count, "
                f"e.g. oom@level:7)"
            ) from None
        if kind not in KINDS:
            raise ValueError(
                f"unknown PTT_FAULT kind {kind!r} (known: {KINDS})"
            )
        out.append((kind, site, n))
    _cache_raw = raw
    _cache_specs = out
    _fired.clear()
    return out


def active() -> bool:
    """Whether any fault is armed (one environment read)."""
    return bool(os.environ.get("PTT_FAULT"))


def poll(site: str, count: int) -> Tuple[str, ...]:
    """Fire every armed spec matching ``(site, count)``: ``kill`` exits
    the process with status 137, ``sigterm`` sends SIGTERM to this
    process (the preemption watcher then sees what a preemption sends);
    the other kinds are returned for the engine to realize."""
    if not os.environ.get("PTT_FAULT"):
        return ()
    hits = []
    for i, (kind, s, n) in enumerate(specs()):
        if i in _fired or s != site or n != count:
            continue
        _fired.add(i)
        if _observer is not None:
            try:
                _observer(kind, site, count)
            except Exception:  # noqa: BLE001 — observers never mask faults
                pass
        if kind == "kill":
            import sys

            print(f"PTT_FAULT: kill@{site}:{count} — hard exit",
                  file=sys.stderr, flush=True)
            os._exit(137)
        if kind == "sigterm":
            import signal

            os.kill(os.getpid(), signal.SIGTERM)
            continue
        hits.append(kind)
    return tuple(hits)


def oom_error(site: str, count: int) -> FaultError:
    """The injected device-memory exhaustion."""
    return FaultError(
        f"RESOURCE_EXHAUSTED: injected fault oom@{site}:{count} "
        "(PTT_FAULT)"
    )


def enospc_error(site: str, count: int) -> OSError:
    """The injected disk-full: a real ``OSError`` with ``errno.ENOSPC``,
    so it takes the same handler as a full disk."""
    import errno

    return OSError(errno.ENOSPC,
                   f"injected fault enospc@{site}:{count} (PTT_FAULT)")
