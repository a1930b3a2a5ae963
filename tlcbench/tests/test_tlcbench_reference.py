"""The plain references against the pinned verdicts, and their rows and
lanes against the port's on the CPU."""

import numpy as np
import pytest

from tlcbench.reference import compaction as RC
from tlcbench.reference import georeplication as RG

SHIPPED = dict(MessageSentLimit=3, CompactionTimesLimit=3,
               ModelConsumer=False, ConsumeTimesLimit=2, KeySpace=[1, 2],
               ValueSpace=[1, 2], RetainNullKey=True, MaxCrashTimes=1,
               ModelProducer=False)
COMP_INV = ("TypeSafe", "CompactionHorizonCorrectness")
GEO_INV = ("TypeOK", "CursorWithinWatermark", "NoPhantomMessages")


@pytest.mark.parametrize("constants,distinct,diameter", [
    (SHIPPED, 45198, 20),
    (dict(SHIPPED, ModelProducer=True, RetainNullKey=False), 253361, 23),
])
def test_compaction_pins(constants, distinct, diameter):
    r = RC.bfs(RC.consts(constants), COMP_INV)
    assert (sum(r["level_sizes"]), len(r["level_sizes"])) == (distinct,
                                                              diameter)
    assert r["violation"] is None and not r["deadlock"]


def test_georeplication_pins():
    c = RG.consts(dict(NumClusters=3, PublishLimit=1,
                       MaxReplicatorCrashes=1))
    r = RG.bfs(c, GEO_INV)
    assert (sum(r["level_sizes"]), len(r["level_sizes"])) == (6400, 18)
    assert r["violation"] is None and not r["deadlock"]


@pytest.mark.parametrize("inv,depth", [("CompactedLedgerLeak", 12),
                                       ("DuplicateNullKeyMessage", 4)])
def test_compaction_seeded_bugs(inv, depth):
    r = RC.bfs(RC.consts(SHIPPED), (inv,))
    assert r["violation"] == inv and len(r["level_sizes"]) == depth


def test_georeplication_seeded_bug():
    c = RG.consts(dict(NumClusters=3, PublishLimit=1,
                       MaxReplicatorCrashes=1))
    r = RG.bfs(c, ("NoDuplicateDelivery",))
    assert r["violation"] == "NoDuplicateDelivery"


def test_scaled_rows_widths():
    c = RC.consts(dict(SHIPPED, MessageSentLimit=64, KeySpace=list(
        range(1, 9)), MaxCrashTimes=3, ModelProducer=True))
    assert sum(n * w for _f, n, w in RC.fields(c)) == 618
    assert RC.row_words(c) == 20
    g = RG.consts(dict(NumClusters=3, PublishLimit=2,
                       MaxReplicatorCrashes=2))
    assert sum(n * w for _f, n, w in RG.fields(g)) == 80
    assert RG.row_words(g) == 3


def test_decode_refuses_non_canonical_rows():
    c = RC.consts(SHIPPED)
    s = RC.initial_states(c)[5]
    w = RC.encode(c, s)
    assert RC.decode(c, w) == s
    # a ledger bit set where its slot is Nil
    at = sum(n * b for name, n, b in RC.fields(c)
             if name in ("length", "keys", "vals", "led_present0"))
    bad = list(w)
    bad[at // 32] |= 1 << (at % 32)
    with pytest.raises(ValueError):
        RC.decode(c, bad)


def _port_rows(model):
    from pulsar_tlaplus_tpu_torch.engine.device_bfs import DeviceChecker

    ck = DeviceChecker(model, device="cpu", profile=None)
    r = ck.run()
    rows = ck.merged_rows().reshape(r.distinct_states, -1)
    return r, rows, *ck.merged_logs()


def test_reference_reads_the_port_rows_and_lanes():
    """The reference's encoding, initial order and lane order are the
    port's, state for state (every 17th state of two bindings)."""
    from pulsar_tlaplus_tpu_torch.models.compaction import CompactionModel
    from pulsar_tlaplus_tpu_torch.models.georeplication import (
        GeoConstants, GeoreplicationModel)
    from pulsar_tlaplus_tpu_torch.ref.pyeval import Constants

    cases = [(RC, RC.consts(SHIPPED), CompactionModel(Constants())),
             (RG, RG.consts(dict(NumClusters=3, PublishLimit=1,
                                 MaxReplicatorCrashes=1)),
              GeoreplicationModel(GeoConstants(3, 1, 1)))]
    for ref, c, model in cases:
        r, rows, par, lan = _port_rows(model)
        inits = ref.initial_states(c)
        for g in range(0, r.distinct_states, 17):
            words = [int(x) for x in rows[g]]
            st = ref.decode(c, words)
            if par[g] < 0:
                assert inits[-1 - par[g]] == st
                continue
            succ = ref.lanes(c, ref.decode(c, rows[par[g]]))
            assert ref.encode(c, succ[lan[g]]) == words
            assert st not in succ[: lan[g]]
        assert np.array_equal(np.array(r.level_sizes),
                              np.array(ref.bfs(c)["level_sizes"]))
