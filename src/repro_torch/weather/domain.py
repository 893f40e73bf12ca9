"""Distributed dycore primitives in one process: the halo exchange and
sharding.

A port of `repro.weather.domain`, NERO's scale-out story: every shard owns
an (ny/Py, nx/Px) slab of the horizontal domain in its own device memory,
the compound stencils run shard-locally, and the only communication is a
circular halo exchange over the mesh axes. Vertical columns are never
split (vadvc's z dependency).

The JAX package runs a shard's round under `shard_map`, each shard's
program moving its halo with `jax.lax.ppermute`. The port drives every
shard of a `launch/mesh.py::Mesh` from this one process instead, so the
round is written over lists: each operand is a list of per-shard tensors
in shard order, and a ride moves one direction's buffer for all shards at
once, a `copy_` of each shard's buffer into a fresh tensor on the
receiving shard's device (a peer copy between two cards, a copy within
the device when both shards share one). `RIDES` counts the rides and the
bytes they move, the twin of `kernels/_build.py::LAUNCHES`: one ride is
one `ppermute` of the JAX package's traced round, so a round's count is
`report()["collectives_per_round"]`. Each exchange runs inside a
`halo_exchange` range (`core/spans.py::span`, recorded only while a
profiler records), so a profile tells its host time and device kernels
from the round's others.

* `_exchange` — the per-operand circular exchange (the per-field paths);
* `_exchange_packed` — the stacked ragged exchange: several operands with
  per-operand, per-side depths share one flattened wire buffer per
  direction; a zero side ships nothing, a direction nothing rides is
  elided, `wire_dtype` casts only the buffer, and one shard on an axis is
  wrap padding with no cast;
* `_right_column` / `_staggered_w` — the x-staggered velocity build;
* `_local_hdiff` / `_local_vadvc` — the unfused oracle's exchanged plain
  stencils;
* `ShardedState`, `shard_state`, `gather_state` — a state placed on a mesh
  and brought back; `block_offsets`, `distinct_shards`, `slot_shards` —
  where a shard's block sits in the whole state, which shards hold each
  block once, and which hold a slot; `zeros_sharded` — an all-zero state
  made on the shards' devices;
* `failover_meshes` — the candidate meshes over surviving devices.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import torch

from repro_torch.core.spans import span
from repro_torch.kernels.hdiff import ref as hdiff_ref
from repro_torch.kernels.vadvc import ref as vadvc_ref
from repro_torch.launch.mesh import Mesh, make_mesh
from repro_torch.weather.dycore import HALO, stack_state
from repro_torch.weather.fields import (WeatherState, field_views, torch_dtype,
                                        zeros_state)

__all__ = ["RIDES", "reset_rides", "ShardedState", "shard_state",
           "gather_state", "block_offsets", "distinct_shards", "slot_shards",
           "zeros_sharded", "failover_meshes"]

# Rides of the halo exchange (one per direction a buffer moved, for all
# shards at once) and the bytes they moved, since the last reset.
RIDES: Dict[str, int] = {"rides": 0, "bytes": 0}


def reset_rides() -> None:
    for k in RIDES:
        RIDES[k] = 0


def _send(bufs: Sequence[torch.Tensor], mesh: Mesh, axis_name: str,
          offset: int) -> List[torch.Tensor]:
    """One ride: shard i's buffer lands on the shard `offset` steps along
    `axis_name`, copied into a new tensor on that shard's device. Returns
    what each shard received, in shard order."""
    devices = mesh.device_list
    out = []
    for j, dev in enumerate(devices):
        src = bufs[mesh.neighbor(j, axis_name, -offset)]
        dst = torch.empty(src.shape, dtype=src.dtype, device=dev)
        dst.copy_(src, non_blocking=True)
        out.append(dst)
    RIDES["rides"] += 1
    RIDES["bytes"] += sum(b.numel() * b.element_size() for b in bufs)
    return out


def _take(a: torch.Tensor, dim: int, sl: slice) -> torch.Tensor:
    idx = [slice(None)] * a.dim()
    idx[dim] = sl
    return a[tuple(idx)]


_RANGE = "halo_exchange"


def _exchange(fs: Sequence[torch.Tensor], mesh: Mesh, axis_name: str,
              halo: int, dim: int) -> List[torch.Tensor]:
    """Circular halo exchange of per-shard `fs` along `dim` over mesh axis
    `axis_name`: each comes back extended by `halo` on both sides of `dim`.
    With one shard on the axis this is periodic wrap padding (no ride).
    `halo` must not exceed the local extent (callers check and raise)."""
    with span(_RANGE):
        return _exchange_body(fs, mesh, axis_name, halo, dim)


def _exchange_body(fs, mesh, axis_name, halo, dim):
    lo = [_take(f, dim, slice(0, halo)) for f in fs]      # -> neighbour below
    hi = [_take(f, dim, slice(-halo, None)) for f in fs]  # -> neighbour above
    if mesh.axis_size(axis_name) == 1:
        top, bot = hi, lo
    else:
        top = _send(hi, mesh, axis_name, +1)              # from rank - 1
        bot = _send(lo, mesh, axis_name, -1)              # from rank + 1
    return [torch.cat([t, f, b], dim=dim) for t, f, b in zip(top, fs, bot)]


def _exchange_packed(parts, mesh: Mesh, axis_name: str, dim: int,
                     wire_dtype=None) -> List[List[torch.Tensor]]:
    """Circular halo exchange along `dim` for several operands with
    per-operand, per-side depths, packed into one flattened wire buffer per
    direction: at most one ride each way, whatever the operand count.

    `parts` is a sequence of `(shards, depth)`, `shards` the operand's
    per-shard tensors and `depth` an int (symmetric) or a `(lo, hi)` pair:
    the operand comes back extended by `lo` on the low side of `dim` (the
    lower neighbour's last `lo` rows) and `hi` on the high side (the upper
    neighbour's first `hi` rows). A zero side ships nothing for that
    operand, and a direction empty for every operand is elided. `wire_dtype`
    (e.g. "bfloat16") casts the packed buffer before the ride and restores
    each operand's dtype on arrival: the rounding stays in the received halo.
    With one shard on the axis this is wrap padding, with no cast. Returns
    the extended operands, each a list in shard order."""
    with span(_RANGE):
        return _packed_body(parts, mesh, axis_name, dim, wire_dtype)


def _packed_body(parts, mesh, axis_name, dim, wire_dtype):
    depths = []
    for _, h in parts:
        lo_h, hi_h = (h, h) if isinstance(h, int) else h
        if lo_h < 0 or hi_h < 0:
            raise ValueError(f"packed-exchange depth {h!r} must be >= 0 "
                             f"on both sides")
        depths.append((lo_h, hi_h))
    # slice(-0, None) would be the whole tensor; a zero depth is empty
    last = lambda a, d: _take(a, dim, slice(-d, None) if d else slice(0, 0))
    first = lambda a, d: _take(a, dim, slice(0, d))
    # The low pad is the lower neighbour's last lo rows (forward ride); the
    # high pad is the upper neighbour's first hi rows (backward ride).
    hi_parts = [[last(t, lo_h) for t in ts]
                for (ts, _), (lo_h, _) in zip(parts, depths)]
    lo_parts = [[first(t, hi_h) for t in ts]
                for (ts, _), (_, hi_h) in zip(parts, depths)]
    n = mesh.axis_size(axis_name)
    wire = None if wire_dtype is None else torch_dtype(wire_dtype)

    def ride(xs, offset):
        """One packed ride of operands `xs`; elided when nothing rides."""
        if n == 1 or all(x[0].numel() == 0 for x in xs):
            return xs
        bufs = []
        for s in range(mesh.size):
            buf = torch.cat([x[s].reshape(-1) for x in xs])
            bufs.append(buf if wire is None else buf.to(wire))
        recv = _send(bufs, mesh, axis_name, offset)
        out = [[None] * mesh.size for _ in xs]
        for s, buf in enumerate(recv):
            off = 0
            for o, x in enumerate(xs):
                size = x[s].numel()
                out[o][s] = buf[off:off + size].reshape(x[s].shape).to(
                    x[s].dtype)
                off += size
        return out

    top = ride(hi_parts, +1)
    bot = ride(lo_parts, -1)
    return [[torch.cat([t_, t, b_], dim=dim)
             for t_, t, b_ in zip(tops, ts, bots)]
            for (ts, _), tops, bots in zip(parts, top, bot)]


def _right_column(wcons: Sequence[torch.Tensor], mesh: Mesh,
                  ax_x: str) -> List[torch.Tensor]:
    """The x-staggered neighbour of each slab's last column: the x
    neighbour shard's first column (a one-column ride)."""
    first = [w[..., :1] for w in wcons]
    if mesh.axis_size(ax_x) == 1:
        return first
    with span(_RANGE):
        return _send(first, mesh, ax_x, -1)


def _staggered_w(wcons: Sequence[torch.Tensor], mesh: Mesh,
                 ax_x: str) -> List[torch.Tensor]:
    """w = wcon_i + wcon_{i+1} on each local slab (see _right_column)."""
    right = _right_column(wcons, mesh, ax_x)
    return [w + torch.cat([w[..., 1:], r], dim=-1)
            for w, r in zip(wcons, right)]


def _local_hdiff(fs: Sequence[torch.Tensor], coeff: float, mesh: Mesh,
                 ax_y: str, ax_x: str) -> List[torch.Tensor]:
    """Per-shard `(E, nz, ly, lx)` slabs -> diffused slabs, by the plain
    compound hdiff on the exchanged slab."""
    g = _exchange(fs, mesh, ax_y, HALO, dim=2)
    g = _exchange(g, mesh, ax_x, HALO, dim=3)
    out = []
    for f, a in zip(fs, g):
        ly, lx = f.shape[-2:]
        d = hdiff_ref.hdiff(a.reshape((-1,) + a.shape[-2:]), coeff=coeff)
        out.append(d.reshape(a.shape)[..., HALO:HALO + ly, HALO:HALO + lx])
    return out


def _local_vadvc(u_stage, wcon, u_pos, utens, utens_stage, mesh: Mesh,
                 ax_x: str) -> List[torch.Tensor]:
    """The plain vadvc of per-shard `(E, nz, ly, lx)` slabs; the staggered
    wcon column comes from the x neighbour."""
    right = _right_column(wcon, mesh, ax_x)
    return [vadvc_ref.vadvc(us, torch.cat([w, r], dim=-1), up, ut, uts)
            for us, w, r, up, ut, uts in zip(u_stage, wcon, right, u_pos,
                                             utens, utens_stage)]


# ---------------------------------------------------------------------------
# A state on a mesh
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class ShardedState:
    """A `WeatherState` placed on `mesh` by `spec`: `shards[i]` is shard
    i's slab of every leaf, on its device, each dict of it the planes of
    one contiguous field-stacked tensor. `spec` names, for each leaf axis
    (E, nz, ny, nx), the mesh axis it is split over, or None (the JAX
    package's `PartitionSpec`); shards along a mesh axis the spec does not
    name hold copies. `grid_shape` and `ensemble` are the whole state's."""

    mesh: Mesh
    spec: Tuple[Optional[str], ...]
    shards: Tuple[WeatherState, ...]
    grid_shape: Tuple[int, int, int]
    ensemble: int


def _blocks(mesh: Mesh, spec, shape) -> List[Tuple[slice, ...]]:
    """Each shard's block of a leaf of `shape` under `spec`."""
    out = []
    for s in range(mesh.size):
        coords = dict(zip(mesh.axis_names, mesh.coords(s)))
        sl = []
        for extent, ax in zip(shape, spec):
            n = mesh.axis_size(ax)
            if ax is None or n == 1:
                sl.append(slice(None))
                continue
            b = extent // n
            sl.append(slice(coords[ax] * b, (coords[ax] + 1) * b))
        out.append(tuple(sl))
    return out


def block_offsets(state: ShardedState) -> List[Tuple[int, int, int]]:
    """Each shard's `(e0, y0, x0)`: where its block starts in the whole
    state's ensemble, y and x axes."""
    shape = (state.ensemble,) + tuple(state.grid_shape)
    return [tuple(sl[a].start or 0 for a in (0, 2, 3))
            for sl in _blocks(state.mesh, state.spec, shape)]


def distinct_shards(state: ShardedState) -> List[int]:
    """The shards that hold each block of the state once: along a mesh
    axis the spec does not name the shards hold copies, and only the first
    of them is taken."""
    unnamed = [a for a, name in enumerate(state.mesh.axis_names)
               if name not in state.spec]
    return [s for s in range(state.mesh.size)
            if all(state.mesh.coords(s)[a] == 0 for a in unnamed)]


def slot_shards(state: ShardedState, e: int) -> List[Tuple[int, int]]:
    """`(shard, local slot)` of every shard holding slot `e` of the whole
    ensemble (copies included)."""
    if not 0 <= e < state.ensemble:
        raise IndexError(f"slot {e} of an ensemble of {state.ensemble}")
    out = []
    for s, (e0, _, _) in enumerate(block_offsets(state)):
        local = e - e0
        if 0 <= local < int(state.shards[s].wcon.shape[0]):
            out.append((s, local))
    return out


def zeros_sharded(grid_shape: Tuple[int, int, int], ensemble: int, dtype,
                  names: Tuple[str, ...], mesh: Mesh, spec) -> ShardedState:
    """An all-zero state placed on `mesh` by `spec`, each shard's block
    made on its device (`shard_state` of `fields.zeros_state`, without the
    whole state on the host)."""
    spec = tuple(spec)
    shape = (ensemble,) + tuple(grid_shape)
    for extent, ax in zip(shape, spec):
        if extent % mesh.axis_size(ax):
            raise ValueError(f"a state axis of {extent} does not divide "
                             f"over the {mesh.axis_size(ax)} shards of mesh "
                             f"axis {ax!r}")
    shards = []
    for sl, dev in zip(_blocks(mesh, spec, shape), mesh.device_list):
        local = [len(range(*s.indices(n))) for s, n in zip(sl, shape)]
        shards.append(zeros_state(tuple(local[1:]), ensemble=local[0],
                                  dtype=dtype, names=names, device=dev))
    return ShardedState(mesh=mesh, spec=spec, shards=tuple(shards),
                        grid_shape=tuple(grid_shape), ensemble=ensemble)


def _copy_to(a: torch.Tensor, device) -> torch.Tensor:
    """A contiguous copy of `a` on `device`."""
    out = torch.empty(a.shape, dtype=a.dtype, device=device)
    out.copy_(a)
    return out


def shard_state(state, mesh: Mesh, spec) -> ShardedState:
    """`state` placed on `mesh` by `spec`, each shard's slab copied to its
    device. A `ShardedState` already so placed comes back as it is; one on
    another mesh or spec is gathered and placed anew."""
    spec = tuple(spec)
    if isinstance(state, ShardedState):
        if state.mesh == mesh and state.spec == spec:
            return state
        state = gather_state(state)
    shape = tuple(state.wcon.shape)
    if len(spec) != len(shape):
        raise ValueError(f"spec {spec} does not match a state leaf of "
                         f"rank {len(shape)}")
    for extent, ax in zip(shape, spec):
        if ax is not None and ax not in mesh.axis_names:
            raise ValueError(f"spec {spec} names axis {ax!r}, which mesh "
                             f"{mesh.shape} lacks")
        if extent % mesh.axis_size(ax):
            raise ValueError(f"a state axis of {extent} does not divide "
                             f"over the {mesh.axis_size(ax)} shards of mesh "
                             f"axis {ax!r}")
    blocks = _blocks(mesh, spec, shape)
    stacked = {part: stack_state(getattr(state, part),
                                 tuple(getattr(state, part)))
               for part in ("fields", "tens", "stage_tens")}
    shards = []
    for sl, dev in zip(blocks, mesh.device_list):
        put = lambda part: field_views(
            _copy_to(stacked[part][(sl[0], slice(None)) + sl[1:]], dev),
            tuple(getattr(state, part)))
        shards.append(WeatherState(fields=put("fields"),
                                   wcon=_copy_to(state.wcon[sl], dev),
                                   tens=put("tens"),
                                   stage_tens=put("stage_tens")))
    return ShardedState(mesh=mesh, spec=spec, shards=tuple(shards),
                        grid_shape=tuple(shape[-3:]), ensemble=shape[0])


def gather_state(state, slot: Optional[int] = None) -> WeatherState:
    """The whole state as CPU tensors: a `ShardedState`'s shards put back
    together (the reshard pivot: gather on one mesh, `shard_state` on
    another), or a `WeatherState` copied to the CPU. With `slot`, only that
    ensemble slot, as an ensemble-1 state: each of its blocks is read from
    one shard that holds it."""
    if isinstance(state, WeatherState):
        take = (lambda t: t) if slot is None else (
            lambda t: t[slot:slot + 1])
        put = lambda d: {k: take(v).to("cpu", copy=True)
                         for k, v in d.items()}
        return WeatherState(fields=put(state.fields),
                            wcon=take(state.wcon).to("cpu", copy=True),
                            tens=put(state.tens),
                            stage_tens=put(state.stage_tens))
    first = state.shards[0]
    grid = tuple(state.grid_shape)
    blocks = _blocks(state.mesh, state.spec, (state.ensemble,) + grid)
    if slot is None:
        picks = [(s, blocks[s], slice(None)) for s in distinct_shards(state)]
        shape = (state.ensemble,) + grid
    else:
        held = dict(slot_shards(state, slot))
        picks = [(s, (slice(0, 1),) + blocks[s][1:],
                  slice(held[s], held[s] + 1))
                 for s in distinct_shards(state) if s in held]
        shape = (1,) + grid
    wcon = torch.empty(shape, dtype=first.dtype)
    for s, sl, es in picks:
        wcon[sl] = state.shards[s].wcon[es].to("cpu")

    def join(part):
        names = tuple(getattr(first, part))
        out = torch.empty((shape[0], len(names)) + shape[1:],
                          dtype=first.dtype)
        for s, sl, es in picks:
            d = getattr(state.shards[s], part)
            out[(sl[0], slice(None)) + sl[1:]] = stack_state(
                {n: d[n][es] for n in names}, names).to("cpu")
        return field_views(out, names)
    return WeatherState(fields=join("fields"), wcon=wcon, tens=join("tens"),
                        stage_tens=join("stage_tens"))


def _mesh_from(devices, shape: Tuple[int, int], axes, ids=None) -> Mesh:
    return make_mesh(shape, axes, devices=list(devices), ids=ids)


def failover_meshes(devices, grids: Iterable[Tuple[int, int, int]],
                    axes=("data", "model"),
                    like: Optional[Tuple[int, int]] = None,
                    ids: Optional[Sequence[int]] = None) -> List[Mesh]:
    """Candidate meshes over surviving `devices`, best first; each takes
    the first devices it needs, with their logical `ids` (default: their
    positions in `devices`).

    Every candidate's (py, px) divides every grid in `grids` (ny over py,
    nx over px): one mesh must carry every lane. More devices first; then
    shapes whose sharded-axis pattern matches `like` (the dying mesh's
    (py, px)): collapsing a sharded axis to one shard switches it from the
    exchange to wrap padding, which may change result bits, whereas
    shrinking a sharded axis (4 -> 2 shards) keeps them. A caller walks the
    list and takes the first mesh its plans compile on."""
    devices = list(devices)
    grids = list(grids)
    cands: List[Tuple[int, int]] = []
    for n in range(len(devices), 0, -1):
        for py in range(n, 0, -1):
            if n % py:
                continue
            px = n // py
            if all(ny % py == 0 and nx % px == 0 for _, ny, nx in grids):
                cands.append((py, px))

    def score(pp):
        py, px = pp
        match = 0
        if like is not None:
            match = ((py > 1) == (like[0] > 1)) + ((px > 1) == (like[1] > 1))
        return (-(py * px), -match, -py)

    return [_mesh_from(devices, pp, axes, ids)
            for pp in sorted(cands, key=score)]
