"""Counterexample reconstruction — the counterpart of the trace helpers
of ``pulsar_tlaplus_tpu/engine/core.py`` (``build_trace``,
``replay_lane_trace``).

A trace is rebuilt from the engine's parent/lane logs: the parent chain
ends at an initial state, logged as ``-1 - init_idx``; the lanes along
the chain replay from that initial state.
"""

from __future__ import annotations

import torch

from pulsar_tlaplus_tpu_torch.ops.packing import smap
from pulsar_tlaplus_tpu_torch.ref import pyeval


def build_trace(model, parent_log: torch.Tensor, lane_log: torch.Tensor,
                gid: int, max_depth: int):
    """The behavior ending at state ``gid``: walk the parent chain (at
    most ``max_depth`` states) and replay its lanes through the model.
    Returns (pyeval.State list, action names)."""
    lanes = []
    g = int(gid)
    for _ in range(max_depth):
        if g < 0:
            break
        lanes.append(int(lane_log[g]))
        g = int(parent_log[g])
    else:
        raise RuntimeError(
            f"parent chain did not reach an initial state within "
            f"{max_depth} steps (last gid {g}): trace log corrupt"
        )
    lanes.reverse()
    replay = getattr(model, "replay_trace", None)
    if replay is None:
        return replay_lane_trace(model, -1 - g, lanes[1:])
    return replay(-1 - g, lanes[1:])


def replay_lane_trace(model, init_idx: int, lanes):
    """Replay a lane chain through the model's batched ``successors``
    (for models without a bespoke ``replay_trace``): from initial state
    ``#init_idx``, take each recorded lane in turn.  Returns (states via
    ``to_pystate``, action names)."""
    s = model.gen_initial(torch.tensor([init_idx], dtype=torch.int64))
    to_py = getattr(model, "to_pystate", lambda x: x)
    names = getattr(model, "action_names", pyeval.ACTION_NAMES)
    aids = getattr(model, "action_ids", None)
    states, actions = [to_py(s)], []
    for lane in lanes:
        succ, _valid = model.successors(s)
        s = smap(lambda x: x[:, int(lane)], succ)
        states.append(to_py(s))
        actions.append(
            names[int(aids[int(lane)])] if aids is not None else str(lane)
        )
    return states, actions
