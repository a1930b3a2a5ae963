"""The host engines' dedup steps and counterexample reconstruction —
the counterpart of ``pulsar_tlaplus_tpu/engine/core.py``
(``partition_perm``, ``dedup_core``, ``dedup_core_hash``,
``build_trace``, ``replay_lane_trace``).

``dedup_core`` settles a batch of candidate lanes against the sorted
visited columns (``ops/dedup.py``): the new states come out in key
order.  ``dedup_core_hash`` settles them against the hash table
(``ops/hashtable.py``; K1 + H1 on the card): the new states come out in
lane order.  Both take the keys from ``dedup.make_keys`` (K2 on the
card) and check the invariants on exactly the new lanes, reporting the
lowest violating lane.

A device engine's trace is rebuilt from its parent/lane logs (on the
device, or a tiered run's merged logs on the host): the parent chain
ends at an initial state, logged as ``-1 - init_idx``; the lanes along
the chain replay from that initial state.  A host engine's trace reads
its state log (``engine/statelog.py``): every record holds the packed
row, the parent gid (-1 at a root) and the action id.
"""

from __future__ import annotations

import torch

from pulsar_tlaplus_tpu_torch.ops import dedup, hashtable
from pulsar_tlaplus_tpu_torch.ops.dedup import SENTINEL
from pulsar_tlaplus_tpu_torch.ops.packing import smap


def partition_perm(keep: torch.Tensor) -> torch.Tensor:
    """Stable permutation moving the ``keep`` lanes to the front."""
    return torch.sort((~keep).to(torch.int8), stable=True).indices


def _violations(model, invariant_names, packed, n_new) -> torch.Tensor:
    """For each invariant, the lowest of the first ``n_new`` lanes of
    ``packed`` violating it, else the lane count (int64 ``[n_inv]``)."""
    n = packed.shape[0]
    dev = packed.device
    if not invariant_names:
        return torch.zeros((0,), dtype=torch.int64, device=dev)
    states = model.layout.unpack(packed)
    lane = torch.arange(n, device=dev)
    live = lane < n_new
    return torch.stack([
        torch.where(live & ~model.invariants[name](states), lane, n).amin()
        for name in invariant_names
    ])


def dedup_core(model, invariant_names, packed, valid, parent, action,
               vk1, vk2, vk3, n_visited):
    """Dedup candidate lanes against the sorted visited columns and merge
    them in.  Returns ``(out_packed, out_parent, out_action, n_new, vk1',
    vk2', vk3', viol)``: the first ``n_new`` output lanes are the new
    states in key order, and ``viol[i]`` is the first output lane
    violating invariant ``i`` (the lane count if none)."""
    n = packed.shape[0]
    k1, k2, k3 = dedup.make_keys(packed, model.layout.total_bits)
    perm = dedup.sort_perm(~valid, k1, k2, k3).to(torch.int64)
    sp, sv = packed[perm], valid[perm]
    sk = [k1[perm], k2[perm], k3[perm]]
    spar, sact = parent[perm], action[perm]
    member = dedup.bsearch_member(vk1, vk2, vk3, n_visited, *sk)
    is_new = sv & ~dedup.same_as_prev(sk) & ~member
    n_new = is_new.sum()
    perm2 = partition_perm(is_new)
    out_packed, out_parent, out_action = sp[perm2], spar[perm2], sact[perm2]
    live = torch.arange(n, device=packed.device) < n_new
    nvk = dedup.merge_sorted(
        vk1, vk2, vk3,
        *[torch.where(live, c[perm2], SENTINEL) for c in sk])
    viol = _violations(model, invariant_names, out_packed, n_new)
    return (out_packed, out_parent, out_action, n_new, *nvk, viol)


def dedup_core_hash(model, invariant_names, packed, valid, parent, action,
                    tcols, claims=None):
    """Dedup candidate lanes against the hash table (in place).  Returns
    ``(out_packed, out_parent, out_action, n_new, tcols, viol,
    n_failed)``: the first ``n_new`` output lanes are the new states in
    lane order; a nonzero ``n_failed`` is a probe overflow."""
    k = dedup.make_keys(packed, model.layout.total_bits)
    is_new, tcols, n_failed = hashtable.lookup_insert(tcols, k, valid,
                                                      claims)
    n_new = is_new.sum()
    perm = partition_perm(is_new)
    out_packed = packed[perm]
    viol = _violations(model, invariant_names, out_packed, n_new)
    return (out_packed, parent[perm], action[perm], n_new, tcols, viol,
            n_failed)


def build_log_trace(model, gid: int, log):
    """The behavior ending at state ``gid`` of a host engine's state log:
    walk the parent gids to a root (-1) and render every state's row.
    Returns (states as ``to_pystate`` renders them, action names)."""
    chain = []
    g = int(gid)
    while g >= 0:
        chain.append(g)
        g = log.get(g)[1]
    chain.reverse()
    states, actions = [], []
    for i, g in enumerate(chain):
        row, _parent, action = log.get(g)
        r = torch.from_numpy(row.view("int32").reshape(1, -1).copy())
        states.append(model.to_pystate(model.layout.unpack(r)))
        if i:
            actions.append(model.action_names[action])
    return states, actions


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
