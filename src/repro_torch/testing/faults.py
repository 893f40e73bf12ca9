"""Deterministic fault injection for the supervised forecasting stack.

A port of `repro.testing.faults`. An always-on forecast service is only
trustworthy unattended if every failure mode it claims to survive is
rehearsed, deterministically: a seedable `FaultInjector` that the
`ForecastEngine` consults at its supervision points, plus file-level
corruption helpers for the checkpoint integrity tests.

Faults are declared as `FaultSpec`s — what kind, at which engine round,
into which slot:

* ``poison_nan`` / ``poison_inf``: overwrite elements of one ensemble
  slot's state with NaN/Inf at a chosen round boundary. Positions are drawn
  from the injector's seeded numpy rng by the same calls, in the same
  order, as the JAX package's injector, so a seed poisons the same elements
  in both packages; they are written into the lane's tensors by index.
* ``compile_fail``: raise `InjectedCompileError` from a chosen stage of the
  engine's compile chain (``native`` -> ``reference`` in the port; the JAX
  package also has ``interpret``, which a spec may still name).
* ``device_loss``: raise `InjectedDeviceLoss` when a chosen round starts —
  a transient runtime failure the engine must retry with backoff. A
  per-device loss (`device=<id>`) fires only while that device is in the
  `device_ids` the engine reports (a mesh's logical ids,
  `launch.mesh.Mesh.ids`), which is None without a mesh: on one device it
  never fires, as in the JAX package.
* ``wire_corrupt``: finite, in-bounds garbage in one slot's rows of one
  shard's slab (on one device: the slab is the whole grid) — only the
  per-slot fingerprint (`program.slot_guard`) catches it.

Poison and wire corruption act in place on a lane's batch, a
`WeatherState` or a sharded lane's `domain.ShardedState`: the positions are
drawn over the whole grid as the JAX package draws them, and each shard
holding the slot takes those inside its block.
* ``straggler``: sleep `delay_s` seconds as the round starts; the engine's
  round deadline (`round_deadline_s`) must notice.

Every fired fault is appended to ``injector.log`` (kind, round, slot).
Checkpoint corruption is file-level: `truncate_file`, `bitflip_file` and
`corrupt_checkpoint` damage a written checkpoint in place.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.weather.domain import (ShardedState, block_offsets,
                                        slot_shards)
from repro_torch.weather.fields import WeatherState, state_leaves

__all__ = ["FaultSpec", "FaultInjector", "InjectedFault",
           "InjectedCompileError", "InjectedDeviceLoss", "truncate_file",
           "bitflip_file", "corrupt_checkpoint"]

KINDS = ("poison_nan", "poison_inf", "compile_fail", "device_loss",
         "wire_corrupt", "straggler")


class InjectedFault(RuntimeError):
    """Base class of all injected failures (never raised by real code)."""


class InjectedCompileError(InjectedFault):
    """Simulated backend lowering/compile failure."""


class InjectedDeviceLoss(InjectedFault):
    """Simulated device loss / transient runtime failure mid-round.
    `lost_device` is the failed device's id for a per-device persistent
    loss (None for the transient, device-less flavor)."""

    def __init__(self, msg: str, lost_device: Optional[int] = None):
        super().__init__(msg)
        self.lost_device = lost_device


@dataclasses.dataclass
class FaultSpec:
    """One declared fault.

    `round` indexes the engine's global round counter (poison and
    device-loss faults fire when that round runs).  `slot` picks the lane
    slot to poison; None (or an inactive slot) falls back to a seeded
    choice among the slots actually busy that round.  `op` restricts the
    fault to lanes/compiles of one stencil op (None = any).  `attempt`
    names which stage of the compile fallback chain a ``compile_fail``
    kills (``"native"``, ``"interpret"``, ``"reference"``, or ``"all"``).
    `once` (default) retires the spec after it fires — the transient-fault
    model; set False for a persistent fault.

    `device` (``device_loss`` only) makes the loss per-device and
    persistent-while-present: it fires on every round >= `round` as long
    as that device id is in the `device_ids` the engine passes to
    `on_round` — so a failover onto surviving devices genuinely clears
    it.  `delay_s` is the ``straggler`` sleep.  `shard` picks which
    shard's slab a ``wire_corrupt`` lands in (the y-decomposed slab
    index)."""

    kind: str
    round: int = 0
    slot: Optional[int] = None
    field: Optional[str] = None                 # poison: field name, None=all
    op: Optional[str] = None
    attempt: str = "native"
    once: bool = True
    device: Optional[int] = None                # device_loss: device id
    delay_s: float = 0.0                        # straggler: sleep seconds
    shard: int = 0                              # wire_corrupt: slab index

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"kind={self.kind!r} not one of {KINDS}")
        if self.device is not None and self.kind != "device_loss":
            raise ValueError(f"device= only applies to device_loss specs, "
                             f"not {self.kind!r}")


class FaultInjector:
    """Seeded, deterministic fault source.  The engine calls the hooks;
    specs decide whether they fire.  Thread-hostile by design (the engine
    is single-threaded); same (specs, seed) => same faults."""

    def __init__(self, specs: Sequence[FaultSpec] = (), seed: int = 0):
        self.specs: List[FaultSpec] = list(specs)
        self.seed = seed
        self.rng = np.random.default_rng(seed)
        self.log: List[Dict[str, Any]] = []
        self._spent: List[FaultSpec] = []

    # -- bookkeeping --------------------------------------------------------
    def _fire(self, spec: FaultSpec, **event) -> None:
        self.log.append({"kind": spec.kind, **event})
        if spec.once:
            self.specs.remove(spec)
            self._spent.append(spec)

    def fired(self, kind: Optional[str] = None) -> int:
        return sum(1 for e in self.log if kind is None or e["kind"] == kind)

    # -- engine hooks -------------------------------------------------------
    def on_compile(self, program, attempt: str) -> None:
        """Called before each stage of the compile fallback chain; raises
        `InjectedCompileError` when a ``compile_fail`` spec matches."""
        for spec in list(self.specs):
            if spec.kind != "compile_fail":
                continue
            if spec.op is not None and spec.op != program.op:
                continue
            if spec.attempt not in ("all", attempt):
                continue
            self._fire(spec, op=program.op, attempt=attempt)
            raise InjectedCompileError(
                f"injected lowering failure: op={program.op!r} "
                f"attempt={attempt!r}")

    def on_round(self, op: str, round_index: int,
                 device_ids: Optional[Sequence[int]] = None) -> None:
        """Called as a lane round starts.  Raises `InjectedDeviceLoss`
        when a ``device_loss`` spec matches this round (or, for a
        per-device spec, while its device is in `device_ids` — the ids of
        the mesh the engine is about to step on); sleeps for a matching
        ``straggler`` spec."""
        for spec in list(self.specs):
            if spec.kind == "straggler":
                if spec.round != round_index:
                    continue
                if spec.op is not None and spec.op != op:
                    continue
                self._fire(spec, op=op, round=round_index,
                           delay_s=spec.delay_s)
                time.sleep(spec.delay_s)
                continue
            if spec.kind != "device_loss":
                continue
            if spec.device is not None:
                # Per-device persistent loss: the chip is gone from
                # `round` on; it only stops failing rounds once the
                # engine stops scheduling onto it.
                if round_index < spec.round:
                    continue
                if device_ids is None or spec.device not in device_ids:
                    continue
            elif spec.round != round_index:
                continue
            if spec.op is not None and spec.op != op:
                continue
            self._fire(spec, op=op, round=round_index, device=spec.device)
            raise InjectedDeviceLoss(
                f"injected device loss: op={op!r} round={round_index}"
                + (f" device={spec.device}" if spec.device is not None
                   else ""),
                lost_device=spec.device)

    def poison(self, batch, op: str, round_index: int,
               active_slots: Sequence[int],
               nonparticipants: Sequence[int] = (),
               shards: Sequence[int] = (1, 1)):
        """Called at the round boundary (post-step, pre-guard); applies
        matching poison specs to ONE active slot each, in place, and returns
        `batch` — only that slot's elements are written, so healthy slots
        keep their exact bits.

        ``wire_corrupt`` specs also land here (the round boundary IS the
        moment a bad wire buffer would have materialized as bad slab
        rows): they prefer a slot from `nonparticipants` (rolled-back or
        idle slots, whose bits the engine can PROVE must not change) and
        damage only shard `spec.shard`'s rows of the y-decomposed slab
        (`shards` = the plan's (py, px))."""
        for spec in list(self.specs):
            if spec.kind == "wire_corrupt":
                if spec.round != round_index:
                    continue
                if spec.op is not None and spec.op != op:
                    continue
                pool = list(nonparticipants) or list(active_slots)
                if spec.slot is not None:
                    slot = spec.slot
                elif pool:
                    slot = int(self.rng.choice(pool))
                else:
                    continue
                batch = self._corrupt_shard(batch, slot, spec.field,
                                            spec.shard, shards)
                self._fire(spec, op=op, round=round_index, slot=slot,
                           shard=spec.shard)
                continue
            if spec.kind not in ("poison_nan", "poison_inf"):
                continue
            if spec.round != round_index:
                continue
            if spec.op is not None and spec.op != op:
                continue
            if not active_slots:
                continue                     # nothing to poison this round
            slot = (spec.slot if spec.slot in active_slots
                    else int(self.rng.choice(list(active_slots))))
            val = np.nan if spec.kind == "poison_nan" else np.inf
            batch = self._poison_slot(batch, slot, spec.field, val)
            self._fire(spec, op=op, round=round_index, slot=slot)
        return batch

    def _corrupt_shard(self, batch, slot: int, field: Optional[str],
                       shard: int, shards: Sequence[int]):
        """Finite, in-bounds damage to one slot's rows inside ONE shard's
        slab, in place: a seeded handful of elements of the slab's first
        rows gets +1.0 — invisible to the NaN/Inf/magnitude validity guard,
        visible to the fingerprint. The positions are the JAX package's (its
        draw over the whole state); on a sharded lane they land in every
        x-shard of y-block `shard` (and its copies)."""
        py = max(1, int(shards[0]))
        name = field if field is not None else \
            sorted(_first(batch).fields)[0]
        nz, ny, nx = _grid(batch)
        ly = max(1, ny // py)
        lo = min(int(shard), py - 1) * ly
        rows = max(1, min(2, ly))
        n = max(1, nz * rows * nx // 16)
        idx = self.rng.choice(nz * rows * nx, size=n, replace=False)
        z, r, x = np.unravel_index(idx, (nz, rows, nx))

        def bump(t, at):
            t[at] = t[at] + torch.ones((), dtype=t.dtype, device=t.device)
        _update(batch, lambda st: st.fields[name], slot, (z, lo + r, x),
                bump)
        return batch

    def _poison_slot(self, batch, slot: int, field: Optional[str],
                     val: float):
        """Overwrite a seeded handful of elements of `slot` with `val`, in
        place, leaf by leaf in the JAX package's leaf order (`field`: that
        field only); on a sharded lane in the shards that hold them."""
        grid = _grid(batch)
        size = int(np.prod(grid))
        n = max(1, size // 8)
        if field is not None:
            pickers = [lambda st: st.fields[field]]
        else:
            pickers = [lambda st, k=k: state_leaves(st)[k]
                       for k in range(len(state_leaves(_first(batch))))]

        def put(t, at):
            t[at] = val
        for leaf_of in pickers:
            idx = self.rng.choice(size, size=n, replace=False)
            _update(batch, leaf_of, slot, np.unravel_index(idx, grid), put)
        return batch


def _first(batch) -> WeatherState:
    return batch.shards[0] if isinstance(batch, ShardedState) else batch


def _grid(batch):
    if isinstance(batch, ShardedState):
        return tuple(batch.grid_shape)
    return tuple(batch.wcon.shape[1:])


def _update(batch, leaf_of, slot: int, pos, update) -> None:
    """`update(slot_view, index)` at the whole-grid positions `pos`
    ((z, y, x) numpy arrays) of slot `slot` of the leaf `leaf_of(state)`,
    in place: on a `domain.ShardedState` in every shard holding the slot,
    each at the positions inside its block."""
    z, y, x = (np.asarray(a) for a in pos)
    if not isinstance(batch, ShardedState):
        t = leaf_of(batch)[slot]                 # a view of the slot
        update(t, _index(t, (z, y, x)))
        return
    offsets = block_offsets(batch)
    for s, local in slot_shards(batch, slot):
        _, y0, x0 = offsets[s]
        t = leaf_of(batch.shards[s])[local]
        ly, lx = t.shape[-2:]
        inside = (y >= y0) & (y < y0 + ly) & (x >= x0) & (x < x0 + lx)
        if inside.any():
            update(t, _index(t, (z[inside], y[inside] - y0,
                                 x[inside] - x0)))


def _index(t: torch.Tensor, pos):
    """Index arrays `pos` as an index tuple on `t`'s device: writes
    through it land in `t`'s storage, whatever its strides."""
    return tuple(torch.as_tensor(p, device=t.device) for p in pos)


# ---------------------------------------------------------------------------
# Checkpoint file corruption (drives ckpt's manifest verification tests)
# ---------------------------------------------------------------------------


def truncate_file(path: str, frac: float = 0.5) -> int:
    """Truncate `path` to `frac` of its size (a torn write / full disk);
    returns the new size."""
    size = os.path.getsize(path)
    new = max(1, int(size * frac))
    with open(path, "r+b") as f:
        f.truncate(new)
    return new


def bitflip_file(path: str, seed: int = 0, nbits: int = 1) -> List[int]:
    """Flip `nbits` seeded-random bits of `path` in place (silent media
    corruption); returns the byte offsets touched.  Offsets avoid the
    head/tail of the file so an npz flip lands in archive member data
    (detected by the manifest crc), not in the zip trailer."""
    rng = np.random.default_rng(seed)
    size = os.path.getsize(path)
    lo = min(512, size // 4)
    hi = max(lo + 1, size - min(1024, size // 4))
    offsets = sorted(int(o) for o in
                     rng.choice(np.arange(lo, hi),
                                size=min(nbits, hi - lo), replace=False))
    with open(path, "r+b") as f:
        for off in offsets:
            f.seek(off)
            byte = f.read(1)[0]
            f.seek(off)
            f.write(bytes([byte ^ (1 << int(rng.integers(8)))]))
    return offsets


def corrupt_checkpoint(ckpt_dir: str, step: int, mode: str = "truncate",
                       seed: int = 0) -> str:
    """Damage one written checkpoint's arrays.npz in place.  `mode` is
    ``"truncate"`` or ``"bitflip"``; returns the corrupted path."""
    path = os.path.join(ckpt_dir, f"step_{step:08d}", "arrays.npz")
    if not os.path.exists(path):
        raise FileNotFoundError(path)
    if mode == "truncate":
        truncate_file(path)
    elif mode == "bitflip":
        bitflip_file(path, seed=seed, nbits=8)
    else:
        raise ValueError(f"mode={mode!r} must be 'truncate' or 'bitflip'")
    return path
