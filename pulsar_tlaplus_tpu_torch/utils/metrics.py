"""Per-level metrics records (the engines' ``metrics_path``): one JSON
line a BFS level, appended as the level closes, with the JAX engines'
keys.  A resumed run first drops the records past the level its frame
holds (the interrupted run may have gone past its last frame) and
marks the cut with ``{"resumed_at_level": L}``, as the JAX host engines
do."""

from __future__ import annotations

import json
import os
from typing import Optional


def append(path: Optional[str], record: dict) -> None:
    if path:
        with open(path, "a") as f:
            f.write(json.dumps(record) + "\n")


def rewind(path: Optional[str], resumed_level: int) -> None:
    """Keep the records up to ``resumed_level`` and mark the resume."""
    if not path or not os.path.exists(path):
        return
    kept = []
    with open(path) as f:
        for line in f:
            try:
                rec = json.loads(line)
            except json.JSONDecodeError:
                continue
            if rec.get("level", 0) <= resumed_level:
                kept.append(line)
    kept.append(json.dumps({"resumed_at_level": resumed_level}) + "\n")
    with open(path, "w") as f:
        f.writelines(kept)
