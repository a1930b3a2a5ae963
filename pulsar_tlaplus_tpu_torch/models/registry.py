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
