"""Tuned-profile store — versioned JSON keyed by config signature; the
counterpart of ``pulsar_tlaplus_tpu/tune/profiles.py``.

A profile is the persisted winner of one ``cli tune`` search: the knob
assignment for one ``(engine, spec + constants, invariant set, backend,
tiered regime)`` configuration, written to ``PTT_TUNE_DIR`` (default
``~/.ptt_profiles``) as ``<sig>.json``.  The engines resolve profiles at
construction (``profile="auto"`` looks the key up; explicit knobs
always win), and ``run_header.profile_sig`` attributes every run to the
profile that shaped it.

The key folds in :data:`PORT_TAG`, so no profile crosses between the
JAX package and the port in either direction, even on the CPU and in a
shared ``PTT_TUNE_DIR``: the two packages' knobs mean different
windows (the port's default ``sub_batch`` is 65,536, the JAX engine's
8,192) and different kernels.  The backend is ``"cpu"`` or ``"cuda"``,
from the engine's torch device.

Robustness contract (as the JAX package's): a corrupt, stale-versioned,
wrong-engine or sig-mismatched profile file is warned about and
ignored — the engine falls back to its defaults and never crashes — and
a profile written for one key is never applied to another (the embedded
``sig`` must match the lookup key, so renaming a file cannot move knobs
across configs).  A knob the port does not take (the JAX package's
``probe_impl``, ``expand_impl``, ``sieve_impl``) is an unknown knob
under the same warn-and-ignore contract.

Profile file schema (``scripts/torch_check_telemetry_schema.py
--profile``)::

    {
      "profile_v": 1,
      "sig": "<sha1 hex, 16 chars>",
      "engine": "device_bfs" | "liveness" | "sim",
      "backend": "cpu" | "cuda",
      "spec": "bookkeeper",          # label only
      "created_unix": 1754300000.0,
      "knobs": {"fuse_group": 4, "fpset_stages": [[4, 16], [16, 64]], ...},
      "tuner": {...}                 # search provenance (free-form)
    }
"""

from __future__ import annotations

import hashlib
import json
import os
import sys
import time
from typing import Dict, List, Optional, Tuple, Union

from pulsar_tlaplus_tpu_torch.tune import space as tune_space

PROFILE_VERSION = 1
TUNE_DIR_ENV = "PTT_TUNE_DIR"
# folded into every key: the port's profiles and the JAX package's
# never resolve for each other
PORT_TAG = "pulsar_tlaplus_tpu_torch"

# knob values must be JSON scalars (or the stages list of pairs)
_SCALAR = (int, float, bool, str, type(None))
# range contracts: the engines raise on these at construction, and a
# bad profile must degrade to defaults instead
_POSITIVE_INT_KNOBS = (
    "sub_batch", "flush_factor", "group", "fuse_group",
    "fpset_dense_rounds", "sweep_group", "miss_batch",
    "n_walkers", "segment_len",
)
_COMPACT_IMPLS = ("logshift", "sort")


def profiles_dir() -> str:
    return os.environ.get(TUNE_DIR_ENV, os.path.expanduser("~/.ptt_profiles"))


def _warn(msg: str) -> None:
    print(f"note: tuned profile ignored: {msg}", file=sys.stderr)


# ------------------------------------------------------------ signature


def model_sig(model) -> str:
    """Model identity: a hand model's Constants (``.c``); a compiled
    spec's module name, constant bindings and lane labels."""
    c = getattr(model, "c", None)
    if c is not None:
        return repr(c)
    spec = getattr(model, "spec", None)
    if spec is not None:
        return repr((
            getattr(spec.module, "name", "?"),
            sorted((k, repr(v)) for k, v in spec.constants.items()),
            tuple(getattr(model, "lane_labels", ())),
        ))
    return type(model).__name__


def default_backend(device=None) -> str:
    """``"cpu"`` or ``"cuda"`` of a torch device (None: the device an
    entry point would take, ``cuda`` when a card is present)."""
    if device is None:
        import torch

        return "cuda" if torch.cuda.is_available() else "cpu"
    return "cpu" if str(device).startswith("cpu") else "cuda"


def profile_key(
    *,
    model,
    invariants: Tuple[str, ...],
    engine: str = "device_bfs",
    backend: Optional[str] = None,
    tiered: bool = False,
) -> str:
    """The config-signature key: the port tag, the engine, the model
    (spec + constant bindings), the invariant set, the backend, and the
    tiered regime when active (a budgeted run's knobs never resolve for
    an all-resident run, or the reverse).  ``max_states`` is left out:
    it scales the run, not the schedule."""
    if backend is None:
        backend = default_backend()
    blob = repr(
        (PORT_TAG, engine, model_sig(model), tuple(invariants), backend)
        + (("tiered",) if tiered else ())
    )
    return hashlib.sha1(blob.encode()).hexdigest()[:16]


# --------------------------------------------------------------- files


def path_for(sig: str) -> str:
    return os.path.join(profiles_dir(), f"{sig}.json")


def save(profile: dict) -> str:
    """Atomically write a profile (built by :func:`build`) to its keyed
    location; returns the path."""
    errs = validate(profile)
    if errs:
        raise ValueError(
            "refusing to save an invalid profile: " + "; ".join(errs))
    d = profiles_dir()
    os.makedirs(d, exist_ok=True)
    path = path_for(profile["sig"])
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(profile, f, indent=2, sort_keys=True)
        f.write("\n")
    os.replace(tmp, path)
    return path


def build(*, sig: str, engine: str, backend: str, knobs: Dict,
          spec: str = "?", tuner: Optional[dict] = None) -> dict:
    return {
        "profile_v": PROFILE_VERSION,
        "sig": sig,
        "engine": engine,
        "backend": backend,
        "spec": spec,
        "created_unix": round(time.time(), 1),
        "knobs": dict(knobs),
        "tuner": dict(tuner or {}),
    }


def _knob_error(path: str, k: str, val) -> Optional[str]:
    """The range violation of one knob value, or None."""
    if k == "fpset_stages":
        ok = isinstance(val, (list, tuple)) and all(
            isinstance(s, (list, tuple)) and len(s) == 2
            and all(isinstance(x, int) and not isinstance(x, bool)
                    for x in s)
            and s[0] >= 2 and s[1] >= 1
            for s in val
        )
        return None if ok else (
            f"{path}: fpset_stages must be [[div >= 2, limit >= 1], ...]")
    if not isinstance(val, _SCALAR):
        return f"{path}: knob {k!r} has non-scalar value {val!r}"
    if k in _POSITIVE_INT_KNOBS and (
            isinstance(val, bool) or not isinstance(val, int) or val < 1):
        return f"{path}: knob {k!r} must be a positive integer (got {val!r})"
    if k == "compact_impl" and val not in _COMPACT_IMPLS:
        return (f"{path}: knob compact_impl must be one of "
                f"{_COMPACT_IMPLS} (got {val!r})")
    if k in ("adapt", "spill_compress") and not isinstance(val, bool):
        return f"{path}: knob {k} must be a boolean (got {val!r})"
    if k == "hbm_headroom" and (
            isinstance(val, bool) or not isinstance(val, (int, float))
            or not 0.0 <= float(val) < 1.0):
        return (f"{path}: knob hbm_headroom must be a fraction in [0, 1) "
                f"(got {val!r})")
    return None


def validate(profile, path: str = "<profile>") -> List[str]:
    """Structural violations in one profile dict (empty = valid)."""
    if not isinstance(profile, dict):
        return [f"{path}: not a JSON object"]
    errs: List[str] = []
    v = profile.get("profile_v")
    if v != PROFILE_VERSION:
        errs.append(f"{path}: profile_v {v!r} != supported {PROFILE_VERSION}")
    for k in ("sig", "engine", "backend"):
        if not isinstance(profile.get(k), str) or not profile.get(k):
            errs.append(f"{path}: missing/empty {k!r}")
    engine = str(profile.get("engine"))
    if engine not in tune_space.PROFILE_KNOBS:
        errs.append(f"{path}: unknown engine {engine!r} (known: "
                    f"{sorted(tune_space.PROFILE_KNOBS)})")
    knobs = profile.get("knobs")
    if not isinstance(knobs, dict):
        errs.append(f"{path}: knobs is not an object")
        return errs
    known = tune_space.PROFILE_KNOBS.get(engine, ())
    for k, val in knobs.items():
        if known and k not in known:
            errs.append(f"{path}: unknown knob {k!r} for engine "
                        f"{engine!r} (known: {sorted(known)})")
        e = _knob_error(path, k, val)
        if e:
            errs.append(e)
    return errs


def validate_file(path: str) -> List[str]:
    """One profile file's violations, plus the filename/sig agreement
    the loader enforces (``--profile`` of the schema script)."""
    try:
        with open(path) as f:
            profile = json.load(f)
    except (OSError, json.JSONDecodeError) as e:
        return [f"{path}: unreadable ({e})"]
    errs = validate(profile, path=path)
    base = os.path.splitext(os.path.basename(path))[0]
    sig = profile.get("sig") if isinstance(profile, dict) else None
    if isinstance(sig, str) and base != sig:
        errs.append(f"{path}: filename key {base!r} != embedded sig "
                    f"{sig!r} (the loader would ignore this file)")
    return errs


def load(sig: str, engine: Optional[str] = None) -> Optional[dict]:
    """The profile stored under ``sig``, or None — warning (never
    raising) on a corrupt, version-mismatched, wrong-engine or
    sig-mismatched file."""
    path = path_for(sig)
    if not os.path.exists(path):
        return None
    try:
        with open(path) as f:
            profile = json.load(f)
    except (OSError, json.JSONDecodeError) as e:
        _warn(f"{path} is unreadable ({e}); using defaults")
        return None
    errs = validate(profile, path=path)
    if errs:
        _warn(errs[0] + "; using defaults")
        return None
    if profile["sig"] != sig:
        _warn(f"{path} embeds sig {profile['sig']!r} but was looked up as "
              f"{sig!r}; using defaults")
        return None
    if engine is not None and profile["engine"] != engine:
        _warn(f"{path} targets engine {profile['engine']!r}, not "
              f"{engine!r}; using defaults")
        return None
    return profile


def resolve(
    profile: Union[None, str, dict],
    *,
    model,
    invariants: Tuple[str, ...],
    engine: str = "device_bfs",
    tiered: bool = False,
    backend: Optional[str] = None,
) -> Optional[dict]:
    """Engine-side resolution: ``None`` -> no profile; ``"auto"`` ->
    look up by config signature; a dict -> validate and hold its
    sig/engine to this config; a path -> load that file, same checks.
    ``backend``: the engine's (``default_backend(device)``)."""
    if profile is None:
        return None
    key = profile_key(model=model, invariants=invariants, engine=engine,
                      backend=backend, tiered=tiered)
    if isinstance(profile, dict):
        errs = validate(profile)
        if errs:
            _warn(errs[0] + "; using defaults")
            return None
        if profile["sig"] != key or profile["engine"] != engine:
            _warn(f"profile sig/engine ({profile.get('sig')!r}, "
                  f"{profile.get('engine')!r}) do not match this config "
                  f"({key!r}, {engine!r}); using defaults")
            return None
        return profile
    if profile == "auto":
        return load(key, engine=engine)
    try:
        with open(profile) as f:
            prof = json.load(f)
    except (OSError, json.JSONDecodeError) as e:
        _warn(f"{profile} is unreadable ({e}); using defaults")
        return None
    return resolve(prof, model=model, invariants=invariants, engine=engine,
                   tiered=tiered, backend=backend)


def knobs_for(profile: Optional[dict], engine: str) -> Dict:
    """The profile's knobs filtered to the engine's known knobs
    (``fpset_stages`` as a tuple of tuples)."""
    if not profile:
        return {}
    known = tune_space.PROFILE_KNOBS.get(engine, ())
    out: Dict = {}
    for k, v in (profile.get("knobs") or {}).items():
        if k not in known or v is None:
            continue
        if k == "fpset_stages":
            v = tuple(tuple(int(x) for x in s) for s in v)
        out[k] = v
    return out
