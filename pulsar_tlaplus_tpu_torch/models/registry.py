"""Model registry: TLA+ module name -> model factory — the counterpart of
``pulsar_tlaplus_tpu/models/registry.py`` (its ``COMPILED`` map).

Each factory takes the parsed TLC config (``utils.cfg.TLCConfig``) and
returns ``(model, constants)``; ``constants`` renders traces.
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple


def _compaction(tlc_cfg) -> Tuple[object, object]:
    from pulsar_tlaplus_tpu_torch.models.compaction import CompactionModel
    from pulsar_tlaplus_tpu_torch.utils import cfg as cfgmod

    constants = cfgmod.to_constants(tlc_cfg)
    return CompactionModel(constants), constants


def _require(tlc_cfg, *names):
    missing = [n for n in names if n not in tlc_cfg.constants]
    if missing:
        raise ValueError(f"cfg binds no CONSTANT {', '.join(missing)}")
    return [int(tlc_cfg.constants[n]) for n in names]


def _subscription(tlc_cfg) -> Tuple[object, object]:
    from pulsar_tlaplus_tpu_torch.models.subscription import (
        SubscriptionConstants,
        SubscriptionModel,
    )

    ml, mc = _require(tlc_cfg, "MessageLimit", "MaxCrashTimes")
    c = SubscriptionConstants(message_limit=ml, max_crash_times=mc)
    return SubscriptionModel(c), c


def _bookkeeper(tlc_cfg) -> Tuple[object, object]:
    from pulsar_tlaplus_tpu_torch.models.bookkeeper import (
        BookkeeperConstants,
        BookkeeperModel,
    )

    e, qw, qa, l, mc = _require(
        tlc_cfg, "NumBookies", "WriteQuorum", "AckQuorum", "EntryLimit",
        "MaxBookieCrashes",
    )
    c = BookkeeperConstants(
        num_bookies=e, write_quorum=qw, ack_quorum=qa, entry_limit=l,
        max_bookie_crashes=mc,
    )
    return BookkeeperModel(c), c


def _georeplication(tlc_cfg) -> Tuple[object, object]:
    from pulsar_tlaplus_tpu_torch.models.georeplication import (
        GeoConstants,
        GeoreplicationModel,
    )

    n, p, mc = _require(
        tlc_cfg, "NumClusters", "PublishLimit", "MaxReplicatorCrashes"
    )
    c = GeoConstants(num_clusters=n, publish_limit=p,
                     max_replicator_crashes=mc)
    return GeoreplicationModel(c), c


COMPILED: Dict[str, Callable] = {
    "compaction": _compaction,
    "subscription": _subscription,
    "bookkeeper": _bookkeeper,
    "georeplication": _georeplication,
}


# ------------------------------------------------ incremental checking
#
# Declared MONOTONE constant axes, the same four as the JAX registry's:
# widening the cfg CONSTANT along one of these axes (a) leaves every
# previously reachable state reachable with its packed encoding intact,
# as long as the packed layout is bit-identical (the warm planner checks
# that separately: a bitlen() step on the counter field changes the
# layout), and (b) enables NEW transitions only from states whose named
# counter field is SATURATED at the old bound.  Each axis gates exactly
# one action through `counter < LIMIT` whose successor does not read the
# limit, and appears in invariants only as an upper bound.


class MonotoneAxis:
    """One declared-monotone constant: the cfg CONSTANT name, the
    packed-state field holding its progress counter, and how saturation
    is read off the field (``counter`` = the scalar field value,
    ``popcount`` = the sum of a 0/1 vector field)."""

    def __init__(self, constant: str, field: str, kind: str = "counter"):
        if kind not in ("counter", "popcount"):
            raise ValueError(f"unknown axis kind {kind!r}")
        self.constant = constant
        self.field = field
        self.kind = kind

    def __repr__(self):
        return (f"MonotoneAxis({self.constant!r}, {self.field!r}, "
                f"{self.kind!r})")


MONOTONE_AXES: Dict[str, Tuple[MonotoneAxis, ...]] = {
    # compaction: MaxCrashTimes gates BrokerCrash alone
    "compaction": (MonotoneAxis("MaxCrashTimes", "crash"),),
    # subscription: MaxCrashTimes gates the consumer-crash action
    "subscription": (MonotoneAxis("MaxCrashTimes", "crash"),),
    # bookkeeper: MaxBookieCrashes gates BookieCrash via the crashed
    # population (`sum(crashed) < max`); the field is the per-bookie 0/1
    # vector, so the layout never depends on the bound
    "bookkeeper": (
        MonotoneAxis("MaxBookieCrashes", "crashed", kind="popcount"),
    ),
    # georeplication: MaxReplicatorCrashes gates ReplicatorCrash
    "georeplication": (MonotoneAxis("MaxReplicatorCrashes", "crash"),),
}


def module_digest(spec: str) -> str:
    """SHA-256 identity of a registry spec's semantics in this package:
    the port's model source, the port's reference evaluator for
    compaction (the model mirrors it), and ``specs/<spec>.tla``.  Any
    edit to one of them changes the digest, which forces the warm
    planner's cold fallback.  The digest hashes the port's files, so it
    never equals the JAX package's: no warm artifact crosses between
    the two packages."""
    import hashlib
    import importlib
    import os

    if spec not in COMPILED:
        raise ValueError(f"unknown registry spec {spec!r}")
    mods = [importlib.import_module(
        f"pulsar_tlaplus_tpu_torch.models.{spec}")]
    if spec == "compaction":
        mods.append(importlib.import_module(
            "pulsar_tlaplus_tpu_torch.ref.pyeval"))
    h = hashlib.sha256()
    for m in mods:
        with open(m.__file__, "rb") as f:
            h.update(f.read())
    tla = os.path.normpath(os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "..", "..", "specs",
        f"{spec}.tla"))
    if os.path.exists(tla):
        with open(tla, "rb") as f:
            h.update(f.read())
    return h.hexdigest()
