"""The HBM budget knob: parsing and resolution — a copy of
``pulsar_tlaplus_tpu/store/budget.py`` (the port imports nothing of the
JAX package).

A tiered run is configured with a byte budget for what the engine keeps
resident on the device — the visited table (+ its generation column),
the row-store and trace-log window, and the expand window's packed rows
and keys.  The engine's growth sites consult the budget instead of
growing unboundedly toward ``max_states``: a growth step that would
overflow it triggers an eviction/spill instead
(``engine/device_bfs.py``), which is what breaks the "visited set must
fit device memory" ceiling.

The knob is testable on the CPU by setting it artificially small — the
spill machinery does not depend on the device, so the CPU tests run the
same code path the card does.
"""

from __future__ import annotations

import os
import re
from typing import Optional, Union

ENV_VAR = "PTT_HBM_BUDGET"

_UNITS = {
    "": 1,
    "b": 1,
    "k": 1 << 10, "kb": 1 << 10, "kib": 1 << 10,
    "m": 1 << 20, "mb": 1 << 20, "mib": 1 << 20,
    "g": 1 << 30, "gb": 1 << 30, "gib": 1 << 30,
    "t": 1 << 40, "tb": 1 << 40, "tib": 1 << 40,
}


def parse_budget(spec: Union[str, int, float]) -> int:
    """``"512M"`` / ``"7.5G"`` / ``"65536"`` -> bytes (int).

    Raises ValueError with the offending token on malformed input; a
    non-positive budget is rejected too (0 would mean "nothing fits",
    which is never what the caller meant — pass ``None`` upstream to
    disable tiering)."""
    if isinstance(spec, (int, float)) and not isinstance(spec, bool):
        n = int(spec)
        if n <= 0:
            raise ValueError(f"hbm budget must be positive: {spec!r}")
        return n
    m = re.fullmatch(
        r"\s*([0-9]+(?:\.[0-9]+)?)\s*([a-zA-Z]*)\s*", str(spec)
    )
    if not m:
        raise ValueError(
            f"bad hbm budget {spec!r} (want e.g. 512M, 7.5G, 65536)"
        )
    unit = _UNITS.get(m.group(2).lower())
    if unit is None:
        raise ValueError(
            f"bad hbm budget unit {m.group(2)!r} in {spec!r} "
            "(want K/M/G/T)"
        )
    n = int(float(m.group(1)) * unit)
    if n <= 0:
        raise ValueError(f"hbm budget must be positive: {spec!r}")
    return n


def resolve_budget(
    arg: Union[None, str, int, float] = None,
) -> Optional[int]:
    """The effective budget in bytes: an explicit ctor/CLI value wins,
    then the ``PTT_HBM_BUDGET`` env override, else ``None`` (tiering
    off — the pre-r16 all-resident memory contract)."""
    if arg is not None:
        return parse_budget(arg)
    env = os.environ.get(ENV_VAR)
    if env:
        return parse_budget(env)
    return None


def fmt_bytes(n: int) -> str:
    """Human rendering for logs/errors (binary units)."""
    for unit, div in (("GiB", 1 << 30), ("MiB", 1 << 20), ("KiB", 1 << 10)):
        if n >= div:
            return f"{n / div:.1f} {unit}"
    return f"{n} B"
