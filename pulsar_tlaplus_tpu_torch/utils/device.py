"""Device selection for the port's entry points."""

from __future__ import annotations

import torch


def resolve(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller
    names another.  Raises when CUDA is wanted and absent — a run never
    falls back to the CPU silently (pass ``device="cpu"``, or ``-cpu``
    on the CLI, to run there)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' "
                "(CLI: -cpu) to run on the CPU"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev} (cuda or cpu)")
    return dev
