"""Model registry: TLA+ module name -> model factory — the counterpart of
``pulsar_tlaplus_tpu/models/registry.py`` with the one model this port
carries so far.

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


COMPILED: Dict[str, Callable] = {"compaction": _compaction}
