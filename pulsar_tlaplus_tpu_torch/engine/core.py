"""Counterexample reconstruction — the counterpart of the trace helpers
of ``pulsar_tlaplus_tpu/engine/core.py`` (``build_trace``,
``replay_lane_trace``).

A trace is rebuilt from the engine's parent/lane logs (on the device, or
a tiered run's merged logs on the host): the parent chain ends at an
initial state, logged as ``-1 - init_idx``; the lanes along the chain
replay from that initial state.
"""

from __future__ import annotations

import torch

from pulsar_tlaplus_tpu_torch.ops.packing import smap


def build_trace(model, parent_log, lane_log, gid: int, max_depth: int):
    """The behavior ending at state ``gid``: walk the parent chain (at
    most ``max_depth`` states) and replay its lanes through the model.
    The logs are indexed by absolute gid: int32 tensors, or numpy
    arrays (a tiered run's merged cold + window logs).  Returns
    (states as the model's ``to_pystate`` renders them, action
    names)."""
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
    ``to_pystate``, action names via ``action_ids`` / ``action_names``)."""
    s = model.gen_initial(torch.tensor([init_idx], dtype=torch.int64))
    states, actions = [model.to_pystate(s)], []
    for lane in lanes:
        lane = int(lane)
        succ, valid = model.successors(s)
        if not bool(valid[0, lane]):
            raise RuntimeError(f"lane {lane} not enabled during replay")
        s = smap(lambda x: x[:, lane], succ)
        states.append(model.to_pystate(s))
        actions.append(model.action_names[int(model.action_ids[lane])])
    return states, actions
