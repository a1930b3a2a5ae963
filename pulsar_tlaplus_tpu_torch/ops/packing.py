"""Packed-state codec — the counterpart of ``pulsar_tlaplus_tpu/ops/packing.py``
(``SState``, ``Layout.pack`` / ``unpack``, ``StructLayout``) as batched
tensor ops.

Every state is ``W`` uint32 words (int32 bit patterns here) with the JAX
package's bit layout, bit for bit: a field of ``n`` elements of ``width``
bits occupies a contiguous bit range, so packing is two ``scatter_add``
per field (the bit ranges are disjoint, so add is or) and unpacking two
gathers plus shifts.  All shifting happens on int64 values below 2^32,
where a left shift by at most 31 stays in range.

The unpacked state carries the ledger masks as ``bool[..., C, M]`` bits
(one per message position) instead of the JAX package's ``u32[C, MW]``
words: the layout packs them as ``M`` one-bit fields either way, so the
packed words are identical, and the batched model reads bits directly.

Canonical-form obligations on writers are the JAX package's: keys/vals
zero past ``length``, ledger bits clear when the slot is absent,
``p1_readpos`` zero without ``p1``, cursor fields zero without a cursor.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from pulsar_tlaplus_tpu_torch.ops.dedup import U32, i32, u32
from pulsar_tlaplus_tpu_torch.ref.pyeval import Constants


class SState(NamedTuple):
    """A batch of compaction states, batch shape ``[*B]`` leading every
    field (compaction.tla:56-70 under the compressed encoding)."""

    length: torch.Tensor  # i32[*B]: Len(messages), 0..M
    keys: torch.Tensor  # i32[*B, M]: message keys, 0 = NullKey / padding
    vals: torch.Tensor  # i32[*B, M]: message values, 0 = NullValue
    led_present: torch.Tensor  # i32[*B, C]: compactedLedgers[c+1] # Nil
    led_bits: torch.Tensor  # bool[*B, C, M]: kept positions per ledger
    cursor_present: torch.Tensor  # i32[*B]
    cursor_h: torch.Tensor  # i32[*B]: cursor.compactionHorizon
    cursor_c: torch.Tensor  # i32[*B]: cursor.compactedTopicContext
    cstate: torch.Tensor  # i32[*B]: 0..5 (compaction.tla:38-44 order)
    p1_present: torch.Tensor  # i32[*B]
    p1_readpos: torch.Tensor  # i32[*B]: phaseOneResult.readPosition
    horizon: torch.Tensor  # i32[*B]: compactionHorizon
    context: torch.Tensor  # i32[*B]: compactedTopicContext
    crash: torch.Tensor  # i32[*B]: crashTimes
    consume: torch.Tensor  # i32[*B]: consumeTimes


def lane_planes(x: torch.Tensor, a: int) -> torch.Tensor:
    """``[B, *S]`` -> a fresh ``[B, a, *S]``: every successor lane starts
    as a copy of its source state's field."""
    return x.unsqueeze(1).expand(x.shape[0], a, *x.shape[1:]).clone()


def smap(fn, *states):
    """Apply ``fn`` leaf by leaf across equally shaped state trees (a
    tree map): the hand models' NamedTuples of tensors, and the compiled
    models' dicts and tuples of tensors.  The result has the trees'
    structure and classes."""
    s = states[0]
    if isinstance(s, dict):
        return {k: smap(fn, *(x[k] for x in states)) for k in s}
    if isinstance(s, tuple) and hasattr(s, "_fields"):
        return type(s)(*(smap(fn, *fs) for fs in zip(*states)))
    if isinstance(s, (tuple, list)):
        return type(s)(smap(fn, *fs) for fs in zip(*states))
    return fn(*states)


def tree_leaves(state) -> list:
    """The leaves of a state tree, dict keys sorted (the JAX pytree
    order) and NamedTuple / tuple items in order."""
    if isinstance(state, dict):
        return [x for k in sorted(state) for x in tree_leaves(state[k])]
    if isinstance(state, (tuple, list)):
        return [x for t in state for x in tree_leaves(t)]
    return [state]


class _FieldCodec:
    """Bit-level codec over an ordered list of (name, n_elems, width)."""

    def __init__(self, fields):
        self.fields = []
        base = 0
        for name, n, width in fields:
            if not 0 <= width <= 32:
                raise ValueError(f"{name}: width {width} not in 0..32")
            offs = base + np.arange(n, dtype=np.int64) * width
            widx = offs // 32
            shift = offs % 32
            spill = shift + width > 32
            # shift for the spilled high part; 0 where unused (width <=
            # 32 makes shift >= 1 whenever a field spills)
            shr = np.where(spill, 32 - shift, 0)
            self.fields.append((name, n, width, widx, shift, spill, shr))
            base += n * width
        self.total_bits = base
        self.W = max(1, math.ceil(base / 32))
        self._consts = {}

    def _on(self, device):
        """The per-field index/shift tensors on ``device`` (cached; one
        host-to-device copy for all of them, so the first use costs one
        sync with the card, not four a field)."""
        key = str(device)
        if key not in self._consts:
            flat = torch.as_tensor(np.concatenate(
                [np.concatenate([widx, shift, spill, shr]).astype(np.int64)
                 for _name, _n, _w, widx, shift, spill, shr in self.fields]
            )).to(device)
            consts, off = [], 0
            for _name, n, _w, _widx, _shift, spill, _shr in self.fields:
                widx, shift, spl, shr = flat[off: off + 4 * n].view(4, n)
                consts.append((widx, shift, spl.bool(), shr,
                               bool(spill.any())))
                off += 4 * n
            self._consts[key] = consts
        return self._consts[key]

    def pack(self, values_by_field, n_rows: int, device) -> torch.Tensor:
        """Field values (each reshapeable to ``[n_rows, n]``) -> int32
        ``[n_rows, W]``."""
        words = torch.zeros((n_rows, self.W + 1), dtype=torch.int64,
                            device=device)
        for (name, n, width, *_), (widx, shift, spill, shr, spills), v in zip(
            self.fields, self._on(device), values_by_field
        ):
            if width == 0 or n == 0:
                continue
            v = v.reshape(n_rows, n).to(torch.int64) & ((1 << width) - 1)
            idx = widx.expand(n_rows, n)
            words.scatter_add_(1, idx, v << shift)
            if spills:
                hi = torch.where(spill, v >> shr, 0)
                words.scatter_add_(1, idx + 1, hi)
        return i32(words[:, : self.W] & U32)

    def unpack(self, words: torch.Tensor):
        """int32 ``[n_rows, W]`` -> dict name -> int32 ``[n_rows, n]``."""
        n_rows = words.shape[0]
        ext = torch.cat(
            [u32(words), torch.zeros((n_rows, 1), dtype=torch.int64,
                                     device=words.device)],
            dim=1,
        )
        out = {}
        for (name, n, width, *_), (widx, shift, spill, shr, spills) in zip(
            self.fields, self._on(words.device)
        ):
            if width == 0 or n == 0:
                out[name] = torch.zeros((n_rows, n), dtype=torch.int32,
                                        device=words.device)
                continue
            lo = ext[:, widx] >> shift
            if spills:
                # the high bits spilled to word widx+1 from bit 0 slot
                # back in at bit 32 - shift
                lo = lo | torch.where(spill, ext[:, widx + 1] << shr, 0)
            out[name] = (lo & ((1 << width) - 1)).to(torch.int32)
        return out


def bitlen(n: int) -> int:
    """Bits needed to represent values 0..n (0 -> 0 bits)."""
    return n.bit_length()


class Layout:
    """Static bit layout of the compaction spec (field order and widths
    equal to the JAX package's ``Layout``); batched pack/unpack."""

    def __init__(self, c: Constants):
        self.c = c
        m = c.message_sent_limit
        self.M = m
        self.C = c.compaction_times_limit
        kb, vb, mb = bitlen(c.num_keys), bitlen(c.num_values), bitlen(m)
        cb = bitlen(self.C)
        cob = bitlen(c.consume_times_limit) if c.model_consumer else 0
        fields = [("length", 1, mb), ("keys", m, kb), ("vals", m, vb)]
        for cc in range(self.C):
            fields.append((f"led_present{cc}", 1, 1))
            fields.append((f"led_mask{cc}", m, 1))
        fields += [
            ("cursor_present", 1, 1),
            ("cursor_h", 1, mb),
            ("cursor_c", 1, cb),
            ("cstate", 1, 3),
            ("p1_present", 1, 1),
            ("p1_readpos", 1, mb),
            ("horizon", 1, mb),
            ("context", 1, cb),
            ("crash", 1, bitlen(c.max_crash_times)),
            ("consume", 1, cob),
        ]
        self._codec = _FieldCodec(fields)
        self.total_bits = self._codec.total_bits
        self.W = self._codec.W

    def pack(self, s: SState) -> torch.Tensor:
        """States ``[*B]`` -> int32 words ``[*B, W]``."""
        batch = tuple(s.length.shape)
        n = math.prod(batch)
        values = [s.length, s.keys, s.vals]
        for cc in range(self.C):
            values.append(s.led_present[..., cc])
            values.append(s.led_bits[..., cc, :])
        values += [
            s.cursor_present, s.cursor_h, s.cursor_c, s.cstate,
            s.p1_present, s.p1_readpos, s.horizon, s.context, s.crash,
            s.consume,
        ]
        words = self._codec.pack(values, n, s.length.device)
        return words.reshape(*batch, self.W)

    def unpack(self, words: torch.Tensor) -> SState:
        """int32 words ``[N, W]`` -> states ``[N]``."""
        d = self._codec.unpack(words)
        sc = lambda name: d[name][:, 0]  # noqa: E731
        n = words.shape[0]
        if self.C:
            led_present = torch.stack(
                [sc(f"led_present{cc}") for cc in range(self.C)], dim=1
            )
            led_bits = torch.stack(
                [d[f"led_mask{cc}"] != 0 for cc in range(self.C)], dim=1
            )
        else:
            led_present = torch.zeros((n, 0), dtype=torch.int32,
                                      device=words.device)
            led_bits = torch.zeros((n, 0, self.M), dtype=torch.bool,
                                   device=words.device)
        return SState(
            length=sc("length"),
            keys=d["keys"],
            vals=d["vals"],
            led_present=led_present,
            led_bits=led_bits,
            cursor_present=sc("cursor_present"),
            cursor_h=sc("cursor_h"),
            cursor_c=sc("cursor_c"),
            cstate=sc("cstate"),
            p1_present=sc("p1_present"),
            p1_readpos=sc("p1_readpos"),
            horizon=sc("horizon"),
            context=sc("context"),
            crash=sc("crash"),
            consume=sc("consume"),
        )


class StructLayout:
    """Bit layout over a NamedTuple state class of int32 scalars, vectors
    and matrices (the JAX package's ``StructLayout``, bit for bit): the
    fields in NamedTuple order, row-major within a field, each element
    ``width`` bits.  ``specs`` maps field -> ``(shape, width_bits)``.
    A batch of states carries its batch shape ``[*B]`` before every
    field's own shape.  Every element must be a non-negative integer
    below ``2**width`` (the models' canonical-form obligation), so the
    words are unique per state."""

    def __init__(self, state_cls, specs: dict):
        self.state_cls = state_cls
        missing = [f for f in state_cls._fields if f not in specs]
        if missing:
            raise ValueError(f"specs missing fields: {missing}")
        self.shapes = {}
        fields = []
        for name in state_cls._fields:
            shape, width = specs[name]
            shape = tuple(shape)
            n = math.prod(shape)
            self.shapes[name] = (shape, n)
            fields.append((name, n, width))
        self._codec = _FieldCodec(fields)
        self.total_bits = self._codec.total_bits
        self.W = self._codec.W

    def pack(self, s) -> torch.Tensor:
        """States ``[*B]`` -> int32 words ``[*B, W]``."""
        first = s[0]
        nd = len(self.shapes[self.state_cls._fields[0]][0])
        batch = tuple(first.shape[: first.dim() - nd])
        n = math.prod(batch)
        values = [getattr(s, name) for name in self.state_cls._fields]
        words = self._codec.pack(values, n, first.device)
        return words.reshape(*batch, self.W)

    def unpack(self, words: torch.Tensor):
        """int32 words ``[*B, W]`` -> states ``[*B]``."""
        batch = tuple(words.shape[:-1])
        d = self._codec.unpack(words.reshape(-1, self.W))
        return self.state_cls(**{
            name: d[name].reshape(*batch, *shape)
            for name, (shape, _n) in self.shapes.items()
        })

    def from_numpy(self, fields, device="cpu"):
        """A state of numpy (or array-like) fields, batched or not ->
        int32 tensors on ``device``, batch shape ``[*B]`` (``[1]`` for
        one unbatched state)."""
        names = self.state_cls._fields
        out = [torch.as_tensor(np.asarray(v).astype(np.int32)).to(device)
               for v in fields]
        if out[0].dim() == len(self.shapes[names[0]][0]):
            out = [t[None] for t in out]
        return self.state_cls(*out)
