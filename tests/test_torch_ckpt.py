"""The port's frame layer (``utils/ckpt.py``), fault parser
(``utils/faults.py``), recovery bookkeeping (``utils/recovery.py``) and
the durable half of the tiered store (``store/tiers.py``) against the
JAX package's, on the CPU: the table codec round trip and its arrays
equal to the JAX codec's, the format gate, signatures (a JAX-written
frame is refused), concurrent writers, stale temps, the bounded retry,
the ``PTT_FAULT`` schedule, the spill manifest, restore, digest checks,
ENOSPC degradation.  Tolerance: exact equality."""

import errno
import os
import signal
import threading

import numpy as np
import pytest
import torch

from pulsar_tlaplus_tpu.store import tiers as jtiers
from pulsar_tlaplus_tpu.utils import ckpt as jckpt
from pulsar_tlaplus_tpu.utils import faults as jfaults
from pulsar_tlaplus_tpu_torch.ops import fpset
from pulsar_tlaplus_tpu_torch.store import tiers
from pulsar_tlaplus_tpu_torch.utils import ckpt, faults, recovery

# one intra-op thread a process: the suite runs a process a core, and
# torch's default of a thread a core in each process oversubscribes it
torch.set_num_threads(1)

S = 0xFFFFFFFF


def _random_table(cap, k, fill, seed):
    """A slot-major port table with a ``fill`` share of random occupied
    slots, and the same table as JAX-style uint32 columns."""
    rng = np.random.RandomState(seed)
    cols = [np.full((cap + 1,), S, np.uint32) for _ in range(k)]
    occ = rng.rand(cap) < fill
    for c in cols:
        c[:cap][occ] = rng.randint(0, S, size=int(occ.sum()),
                                   dtype=np.uint64).astype(np.uint32)
    tcols = fpset.slot_major(
        [torch.from_numpy(c.view(np.int32).copy()) for c in cols])
    return tcols, cols


@pytest.mark.parametrize("k", [2, 3])
def test_table_codec_round_trip_and_jax_arrays(k):
    """``pack_table`` of a slot-major table stores the arrays the JAX
    codec stores for the same table; ``restore_table`` writes every key
    back into its own slot, from the port's arrays or the JAX codec's;
    the JAX ``unpack_fpset`` reads the port's arrays."""
    tcols, cols = _random_table(1 << 10, k, 0.3, seed=k)
    mine = ckpt.pack_table(tcols)
    ref = jckpt.pack_fpset(cols)
    assert sorted(mine) == sorted(ref)
    for name in ref:
        assert np.array_equal(np.asarray(mine[name]),
                              np.asarray(ref[name])), name
    back = fpset.empty_cols(1 << 10, k, "cpu")
    assert ckpt.restore_table(mine, back) == int(mine["fp_cnt"][0])
    for b, c in zip(back, cols):
        assert np.array_equal(b.numpy().view(np.uint32), c)
    fpset.slot_major_base(back)  # still one slot-major buffer
    for a, b in zip(jckpt.unpack_fpset(mine, k), cols):
        assert np.array_equal(a, b)
    # the JAX codec's arrays restore into the port's slot-major table
    again = fpset.empty_cols(1 << 10, k, "cpu")
    ckpt.restore_table(ref, again)
    for a, b in zip(again, back):
        assert torch.equal(a, b)


def test_restore_table_refuses_other_capacity():
    tcols, _ = _random_table(1 << 8, 2, 0.2, seed=1)
    packed = ckpt.pack_table(tcols)
    with pytest.raises(ValueError, match="does not fit"):
        ckpt.restore_table(packed, fpset.empty_cols(1 << 9, 2, "cpu"))


def test_format_gate_and_signatures(tmp_path):
    path = str(tmp_path / "f.npz")
    ckpt.save_frame(path, "sig1", {"x": np.arange(3)})
    assert list(ckpt.load_frame(path, "sig1")["x"]) == [0, 1, 2]
    with pytest.raises(ValueError, match="different configuration"):
        ckpt.load_frame(path, "sig2")
    # the JAX reader takes the port's frame layout (same fields) ...
    assert list(jckpt.load_frame(path, "sig1")["x"]) == [0, 1, 2]
    # ... and a frame of a newer format is refused by both
    np.savez_compressed(path, __format__=np.int64(ckpt.FORMAT_VERSION + 1),
                        sig=np.frombuffer(b"sig1", dtype=np.uint8))
    for mod in (ckpt, jckpt):
        with pytest.raises(ValueError, match="newer than this build"):
            mod.load_frame(path, "sig1")
    with pytest.raises(FileNotFoundError):
        ckpt.load_frame(str(tmp_path / "missing.npz"), "sig1")
    bad = str(tmp_path / "bad.npz")
    with open(bad, "wb") as f:
        f.write(b"not a frame")
    with pytest.raises(ValueError, match="unrecognized checkpoint"):
        ckpt.load_frame(bad, "sig1")
    assert ckpt.FORMAT_VERSION == jckpt.FORMAT_VERSION
    assert ckpt.config_sig(a=1, b=(2,)) == jckpt.config_sig(b=(2,), a=1)


def test_concurrent_writers_never_torn(tmp_path):
    """Two writers hammering one path: every read sees a whole frame of
    one writer, and no temp is left behind."""
    path = str(tmp_path / "shared.npz")
    errors = []

    def hammer(val):
        try:
            for seq in range(15):
                ckpt.save_frame(path, "sig",
                                {"payload": np.full(4096, val, np.int64)},
                                meta={"run_id": str(val), "frame_seq": seq})
        except Exception as e:  # noqa: BLE001 — surfaced below
            errors.append(e)

    ts = [threading.Thread(target=hammer, args=(v,)) for v in (1, 2)]
    for t in ts:
        t.start()
    for _ in range(20):
        if os.path.exists(path):
            d = ckpt.load_frame(path, "sig")
            p = d["payload"]
            assert (p == p[0]).all() and p[0] in (1, 2)
            assert jckpt.frame_meta(d)["run_id"] == str(p[0])
    for t in ts:
        t.join()
    assert not errors
    assert [n for n in os.listdir(tmp_path) if ".tmp." in n] == []


def test_cleanup_stale_tmp_is_scoped(tmp_path):
    p = str(tmp_path / "c.npz")
    other = str(tmp_path / "other.npz")
    for name in (p + ".tmp.1.2.npz", other + ".tmp.3.4.npz"):
        with open(name, "wb") as f:
            f.write(b"dead half-frame")
    assert ckpt.cleanup_stale_tmp(p)
    assert not os.path.exists(p + ".tmp.1.2.npz")
    assert os.path.exists(other + ".tmp.3.4.npz")  # a sibling's: kept
    assert not ckpt.cleanup_stale_tmp(p)
    assert not ckpt.cleanup_stale_tmp(None)


def test_transient_oserror_is_retried(tmp_path, monkeypatch):
    calls = {"n": 0}
    real = np.savez

    def flaky(*a, **k):
        calls["n"] += 1
        if calls["n"] == 1:
            raise OSError(28, "No space left on device")
        return real(*a, **k)

    monkeypatch.setattr(ckpt.np, "savez", flaky)
    monkeypatch.setattr(ckpt, "WRITE_BACKOFF_S", 0.001)
    p = str(tmp_path / "f.npz")
    nbytes, _w, retries = ckpt.save_frame(p, "sig", {"x": np.arange(4)})
    assert retries == 1 and nbytes > 0
    assert list(ckpt.load_frame(p, "sig")["x"]) == [0, 1, 2, 3]

    def dead(*a, **k):
        raise OSError(5, "Input/output error")

    monkeypatch.setattr(ckpt.np, "savez", dead)
    q = str(tmp_path / "g.npz")
    with pytest.raises(OSError, match="Input/output"):
        ckpt.save_frame(q, "sig", {"x": np.arange(2)})
    assert not os.path.exists(q)
    assert [n for n in os.listdir(tmp_path) if ".tmp." in n] == []


def test_ckpt_fail_drill_retries(tmp_path, monkeypatch):
    monkeypatch.setattr(ckpt, "WRITE_BACKOFF_S", 0.001)
    monkeypatch.setenv("PTT_FAULT", "ckpt_fail@frame:2")
    faults.reset()
    p = str(tmp_path / "f.npz")
    assert ckpt.save_frame(p, "s", {"x": np.arange(1)},
                           meta={"frame_seq": 1})[2] == 0
    assert ckpt.save_frame(p, "s", {"x": np.arange(1)},
                           meta={"frame_seq": 2})[2] == 1
    faults.reset()


SCHEDULES = [
    "oom@level:7, fpset_fail@flush:3",
    "kill@level:5,sigterm@level:4,ckpt_fail@frame:1",
    "enospc@spill:1,oom@flush:2,kill@sweep:3,sigterm@segment:2",
    "drop@conn:3,torn@line:5,partition@backend:2,corrupt@warm:1",
]


@pytest.mark.parametrize("spec", SCHEDULES)
def test_fault_schedule_equals_jax(spec, monkeypatch):
    """The same ``PTT_FAULT`` string parses to the same schedule, and
    the returned kinds fire once, at the same sites."""
    monkeypatch.setenv("PTT_FAULT", spec)
    faults.reset()
    jfaults.reset()
    assert faults.specs() == jfaults._specs()
    for kind, site, n in faults.specs():
        if kind in ("kill", "sigterm"):
            continue  # realized inside poll
        assert faults.poll(site, n - 1) == jfaults.poll(site, n - 1)
        got = faults.poll(site, n)
        assert got == jfaults.poll(site, n) and kind in got
        assert faults.poll(site, n) == () == jfaults.poll(site, n)
    faults.reset()
    jfaults.reset()


@pytest.mark.parametrize("spec,msg", [("bogus@level:1", "unknown PTT_FAULT"),
                                      ("oom@level", "bad PTT_FAULT spec")])
def test_fault_spec_errors_equal_jax(spec, msg, monkeypatch):
    monkeypatch.setenv("PTT_FAULT", spec)
    for mod in (faults, jfaults):
        mod.reset()
        with pytest.raises(ValueError, match=msg):
            mod.poll("level", 1)
        mod.reset()


def test_fault_errors_match_jax_handlers():
    e = faults.oom_error("level", 3)
    assert recovery.is_resource_exhausted(e)
    assert str(e) == str(jfaults.oom_error("level", 3))
    assert recovery.is_resource_exhausted(torch.OutOfMemoryError("CUDA"))
    assert not recovery.is_resource_exhausted(RuntimeError("probe overflow"))
    o = faults.enospc_error("spill", 1)
    assert o.errno == errno.ENOSPC == jfaults.enospc_error("spill", 1).errno


def test_recovery_state_arms_and_degrades(tmp_path):
    p = str(tmp_path / "f.npz")
    rec = recovery.RecoveryState(p)
    assert not rec.can_recover()
    rec.arm()
    assert not rec.can_recover()  # no file yet
    open(p, "wb").close()
    assert rec.can_recover()
    rec.degrade()
    assert rec.hbm_recovered == 1 and rec.headroom_frozen
    assert not rec.can_recover()  # the frame was consumed
    rec.reset()
    assert (rec.hbm_recovered, rec.armed, rec.headroom_frozen) == (
        0, False, False)


def test_preemption_watcher_sets_flag_and_restores():
    with ckpt.PreemptionWatcher(enabled=True, log=lambda m: None) as w:
        assert not w.requested
        os.kill(os.getpid(), signal.SIGTERM)
        assert w.requested
    assert signal.getsignal(signal.SIGTERM) != w._handle


# ---- the durable spill tier ----------------------------------------------


def _fill(store, rng, k=2):
    keys = [np.sort(rng.randint(0, S, size=500, dtype=np.uint64)
                    .astype(np.uint32)) for _ in range(k)]
    order = np.lexsort(keys[::-1])
    store.evict_keys([c[order] for c in keys])
    store.spill_rows(0, 10, np.arange(20, dtype=np.uint32))
    store.spill_logs(0, 10, np.arange(10, dtype=np.int32),
                     np.arange(10, dtype=np.int32) % 3)
    return [c[order] for c in keys]


def test_durable_manifest_restore_round_trip(tmp_path):
    """A durable store writes its runs and segments; the manifest
    restores them into a fresh store (same lookups, rows, logs), its
    fields match the JAX store's, and a torn file is refused."""
    rng = np.random.RandomState(3)
    d = str(tmp_path / "spill")
    st = tiers.TieredStore(2, spill_dir=d, durable=True)
    keys = _fill(st, rng)
    man = st.manifest()
    st.close()
    jst = jtiers.TieredStore(2, spill_dir=str(tmp_path / "j"), durable=True)
    _fill(jst, np.random.RandomState(3))
    jman = jst.manifest()
    jst.close()
    assert sorted(man) == sorted(jman)
    for part in ("key_runs", "rows", "logs"):
        assert [sorted(e) for e in man[part]] == [sorted(e)
                                                  for e in jman[part]]
        # the same blobs: the codecs are byte-equal
        assert [e.get("digest", e.get("digests")) for e in man[part]] == [
            e.get("digest", e.get("digests")) for e in jman[part]]
    back = tiers.TieredStore(2, spill_dir=d, durable=True)
    back.restore(man)
    assert back.lookup_keys([k[:50] for k in keys]).all()
    assert np.array_equal(back.fetch_rows(0, 10, 2),
                          np.arange(20, dtype=np.uint32))
    par, lan = back.fetch_logs(0, 10)
    assert np.array_equal(lan, np.arange(10) % 3)
    back.close()
    victim = os.path.join(d, man["rows"][0]["file"])
    with open(victim, "r+b") as f:
        f.write(b"\x00\x01")
    with pytest.raises(ValueError, match="digest mismatch"):
        tiers.TieredStore(2, spill_dir=d, durable=True).restore(man)


def test_wipe_and_stale_spill_temps(tmp_path):
    d = str(tmp_path / "spill")
    st = tiers.TieredStore(2, spill_dir=d, durable=True)
    _fill(st, np.random.RandomState(1))
    st.flush()
    assert any(n.endswith(".ptsk") for n in os.listdir(d))
    with open(os.path.join(d, "x.ptsr.tmp.1.2"), "wb") as f:
        f.write(b"torn")
    assert tiers.cleanup_stale_spill(d) == 1
    st.wipe()
    assert not [n for n in os.listdir(d) if n.endswith((".ptsk", ".ptsr"))]
    assert not st.has_cold_keys
    st.close()
    assert tiers.cleanup_stale_spill(None) == 0


def test_enospc_degrades_and_manifest_refuses(tmp_path, monkeypatch):
    """``enospc@spill:1``: the RAM tiers stay queryable, the store
    latches ``degraded`` and refuses a manifest — as the JAX store."""
    monkeypatch.setenv("PTT_FAULT", "enospc@spill:1")
    faults.reset()
    rng = np.random.RandomState(5)
    st = tiers.TieredStore(2, spill_dir=str(tmp_path / "s"), durable=True)
    keys = _fill(st, rng)
    st.flush()
    assert st.degraded
    assert st.lookup_keys([k[:10] for k in keys]).all()
    with pytest.raises(ValueError, match="degraded"):
        st.manifest()
    st.close()
    faults.reset()


def test_model_sig_is_the_jax_contract():
    """A frame's model identity: a hand model's Constants, or a compiled
    spec's module, constant bindings and lane labels — the JAX string."""
    import dataclasses
    import types

    from pulsar_tlaplus_tpu.models.compaction import CompactionModel as JM
    from pulsar_tlaplus_tpu.ref import pyeval as pe
    from pulsar_tlaplus_tpu.tune.profiles import model_sig as jsig
    from pulsar_tlaplus_tpu_torch.models.compaction import CompactionModel
    from pulsar_tlaplus_tpu_torch.ref import pyeval as tpe

    c = pe.SHIPPED_CFG
    mine = CompactionModel(tpe.Constants(**dataclasses.asdict(c)))
    assert ckpt.model_sig(mine) == jsig(JM(c))
    spec = types.SimpleNamespace(
        module=types.SimpleNamespace(name="compaction"),
        constants={"MessageSentLimit": 3, "KeySpace": frozenset({1, 2})})
    compiled = types.SimpleNamespace(spec=spec, lane_labels=["A", "B"])
    assert ckpt.model_sig(compiled) == jsig(compiled)
