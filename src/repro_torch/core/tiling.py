"""Tile spaces of the planner and tile choice for the CUDA stencil kernels.

Two kinds of tile live here.

* The planner's, ported from `repro.core.tiling`: an `OpSpec` describes a
  memory-bound operator, a `TilePlan` one 3-D window of it with its
  near-memory footprint and main-memory traffic, and `candidate_tiles`
  enumerates the windows that fit a `Hierarchy`'s near memory. The
  autotuner (`core/autotune.py`) and the performance model
  (`core/perfmodel.py`) search and score these, in the JAX package's
  arithmetic, so both packages pick the same window under the same spec.
* The kernel's: a `CudaTile` is a block shape a CUDA kernel launches with,
  at most 1024 threads and 227 KB of shared memory (232,448 bytes, NVIDIA's
  H100 data sheet). Each kernel has a fixed default (`hdiff_tile`, ...)
  and candidate (ty, tx) requests (`FUSED_TILES`, `HDIFF_TILES`, ...)
  that `compile(tune="measure")` times on the device; `cuda_tile_for` maps
  a planner's window for hdiff or vadvc onto the kernel's tile. Every
  kernel masks its own ragged edge tiles, so a tile need not divide the
  grid; results do not depend on the tile, bit for bit.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Sequence, Tuple

from repro_torch.core import hierarchy as hw
from repro_torch.weather.fields import dtype_name

MAX_THREADS_PER_BLOCK = 1024
SMEM_BYTES_PER_BLOCK = 232_448
MAX_CLUSTER = 8          # blocks of a thread block cluster, portable
HALO = 2


@dataclasses.dataclass(frozen=True)
class CudaTile:
    """A kernel's block shape: `ty` x `tx` output points (vadvc: columns;
    the hdiff stream: a y-segment of `ty` rows of an x-strip of `tx`
    columns) per block, the block's threads and its shared memory; a kernel
    that runs thread block clusters also names the cluster's size (the
    whole-state dycore: the field blocks of a tile; the dycore k-step: the
    blocks that split a tile's rows, `rows` each)."""

    op: str
    ty: int
    tx: int
    threads: int
    smem_bytes: int
    cluster: int = 1     # blocks of a thread block cluster
    rows: int = 0        # rows of the tile a block of the cluster runs

    def __post_init__(self):
        if not 1 <= self.threads <= MAX_THREADS_PER_BLOCK:
            raise ValueError(f"{self.op} tile {self.ty}x{self.tx} needs "
                             f"{self.threads} threads per block; at most "
                             f"{MAX_THREADS_PER_BLOCK}")
        if self.smem_bytes > SMEM_BYTES_PER_BLOCK:
            raise ValueError(f"{self.op} tile {self.ty}x{self.tx} needs "
                             f"{self.smem_bytes} bytes of shared memory; at "
                             f"most {SMEM_BYTES_PER_BLOCK}")
        if not 1 <= self.cluster <= MAX_CLUSTER:
            raise ValueError(f"{self.op} tile {self.ty}x{self.tx}: a cluster "
                             f"of {self.cluster} blocks; at most "
                             f"{MAX_CLUSTER}")

    def describe(self) -> dict:
        return dataclasses.asdict(self)


# The hdiff stream (`csrc/hdiff.cu`, one kernel for one step and for k
# steps): a block walks the rows of one y-segment of one x-strip of a plane,
# a thread for each HDIFF_COLS columns of the strip and its 2k-column halo
# either side, through a ring of HDIFF_RING input rows in shared memory. A
# launch runs 1 <= k <= HDIFF_MAX_K stages (`kMaxSteps`: more spill); the
# wrapper runs a longer round as `hdiff_launches(k)`.
HDIFF_MAX_K = 3
HDIFF_COLS = 2          # window columns a thread owns (`kCols`)
HDIFF_SEGMENT = 66      # default tallest segment, a stage (k = 1: 4 x 65)
HDIFF_RING = 8          # ring rows (`kRing`): 5 rows in flight
HDIFF_WRAP = 32         # periodic mode's wrap bytes a ring row (`kWrap`)
# the stream's candidate (ty, tx) requests, which `compile(tune="measure")`
# times beside the default tile (`hdiff_kstep_tile`; at the main path's
# 260-268 square planes: segments of at most 67, 134 or 268 rows, 4, 2 or 1
# a plane, by strips of at most 268, 134, 90 or 54 columns, 1, 2, 3 or 5)
HDIFF_TILES = tuple((ty, tx) for ty in (67, 134, 268)
                    for tx in (268, 134, 90, 54))


def balanced(n: int, most: int) -> int:
    """The width of the widest of the fewest parts, differing by at most
    one, that split `n` into parts of at most `most` (260 by 96: 87)."""
    parts = -(-n // max(1, min(most, n)))
    return -(-n // parts)


def _stream_threads(width: int, k: int) -> int:
    """Threads of a stream block for a strip `width` columns wide at k
    stages: HDIFF_COLS columns of the strip and its 2k-column halo either
    side a thread, and HDIFF_COLS - 1 more (a row's copy starts up to that
    many columns early, at its first aligned chunk), in whole warps."""
    return 32 * -(-(width + 2 * HALO * k + HDIFF_COLS - 1)
                  // (32 * HDIFF_COLS))


def hdiff_strip(nx: int, k: int) -> int:
    """The default strip width: of the balanced splits of `nx` into strips
    at least 8 columns wide, the one whose blocks need the fewest threads
    a row (a warp's idle columns cost as much as its used ones), the
    narrowest on ties (260 at k = 1: 5 strips of 52, 160 threads)."""
    best = (None, nx)
    for parts in range(1, max(1, nx // 8) + 1):
        width = -(-nx // parts)
        cost = parts * _stream_threads(width, k)
        if best[0] is None or cost <= best[0]:
            best = (cost, width)
    return best[1]


def hdiff_stream_smem(k: int, threads: int, periodic: bool = False) -> int:
    """Shared bytes of an hdiff stream block (`stream_smem` in
    `csrc/hdiff.cu`) of w = HDIFF_COLS·threads window columns, in rows of
    4·(w + 8) bytes: two fp32 laplacian rows a stage and four output rows
    a stage but the last, then a row and an 8-byte mbarrier a ring row,
    and in periodic mode HDIFF_WRAP bytes a ring row."""
    row = 4 * (HDIFF_COLS * threads + 8)
    return row * (2 * k + 4 * (k - 1) + HDIFF_RING) + 8 * HDIFF_RING + \
        (HDIFF_WRAP * HDIFF_RING if periodic else 0)


def hdiff_launches(k: int) -> List[int]:
    """The stages of each launch of a round of `k` hdiff steps: the fewest
    launches of at most HDIFF_MAX_K stages, as even as can be (4: [2, 2];
    9: [3, 3, 3])."""
    if not isinstance(k, int) or k < 1:
        raise ValueError(f"hdiff: k={k!r} stages; at least 1")
    n = -(-k // HDIFF_MAX_K)
    return [(k + i) // n for i in range(n)]


def hdiff_kstep_tile(ny: int, nx: int, k: int = 1, ty: Optional[int] = None,
                     tx: Optional[int] = None) -> CudaTile:
    """The hdiff stream's tile for a round of `k` steps (k = 1: one step):
    balanced y-segments of at most `ty` rows (default k·HDIFF_SEGMENT) and
    x-strips of at most `tx` columns (default `hdiff_strip`), a thread for
    each HDIFF_COLS columns of the widest strip and its halo (rounded up to
    whole warps). A round of more than HDIFF_MAX_K steps is planned for
    the largest of its `hdiff_launches`."""
    k = max(hdiff_launches(k))
    ty = balanced(ny, HDIFF_SEGMENT * k if ty is None else ty)
    tx = balanced(nx, hdiff_strip(nx, k) if tx is None else tx)
    threads = _stream_threads(tx, k)
    return CudaTile("hdiff", ty, tx, threads, hdiff_stream_smem(k, threads))


def hdiff_tile(ny: int, nx: int, ty: Optional[int] = None,
               tx: Optional[int] = None, periodic: bool = False) -> CudaTile:
    """`hdiff_kstep_tile` at k = 1; `periodic` plans the periodic mode on
    the unpadded plane: the same window, and the wrap area."""
    tile = hdiff_kstep_tile(ny, nx, 1, ty, tx)
    return dataclasses.replace(
        tile, smem_bytes=hdiff_stream_smem(1, tile.threads, periodic))


# The vadvc sweep (`csrc/vadvc.cu`): a block is one warp and owns a segment
# of at most VADVC_COLS adjacent columns of a row, one a lane, for the whole
# column: the levels ahead stream through a ring of VADVC_RING levels, and
# the forward sweep keeps (c, d) and u_pos of every level in shared memory.
VADVC_COLS = 32
VADVC_RING = 4
VADVC_STREAMS = 5       # ring regions a level: 4 fields and wcon
# the sweep's candidate segment widths (columns a warp), timed by
# `compile(tune="measure")` beside the default
VADVC_TILES = (32, 24, 16, 12, 8, 4)


def vadvc_smem(nz: int, cols: int, itemsize: int) -> int:
    """Shared bytes of a vadvc warp (`warp_smem` in `csrc/vadvc.cu`): a ring
    of VADVC_RING levels (five regions of the 4-byte words that hold 32
    elements, and a word for the wcon element right of the segment,
    rounded to 16 bytes), then c and d in fp32 and u_pos in the storage
    dtype for every level of `cols` columns."""
    region = 32 * itemsize + 4
    slot = -(-(VADVC_STREAMS * region + 4) // 16) * 16
    return VADVC_RING * slot + nz * cols * (8 + itemsize)


def vadvc_tile(ny: int, nx: int, nz: int, itemsize: int = 4,
               cols: Optional[int] = None) -> CudaTile:
    """The vadvc sweep's tile: segments of at most `cols` columns of a row
    (default VADVC_COLS, fewer where nz levels of them would not fit a
    block's shared memory), balanced over nx; a warp a block. `itemsize`
    is the fields' (4 fp32, 2 bf16)."""
    if cols is None:
        cols = VADVC_COLS
        while cols > 1 and vadvc_smem(nz, cols, itemsize) > \
                SMEM_BYTES_PER_BLOCK:
            cols -= 1
    if not 1 <= cols <= VADVC_COLS:
        raise ValueError(f"vadvc tile: {cols} columns a warp; 1 to "
                         f"{VADVC_COLS}, one a lane")
    cols = balanced(nx, cols)
    return CudaTile("vadvc", 1, cols, 32, vadvc_smem(nz, cols, itemsize))


def snap_to_divisor(t: int, n: int, lo: int = 2) -> int:
    """Largest divisor of `n` that is `<= t` and `>= lo`; `n` itself when
    no divisor lands in `[lo, t]`. The JAX package's one snapping rule,
    which the model's windows (`kernels/*/ops.py::plan_tile`) and the
    traffic hooks (`weather/stencil_ops.py`) snap through."""
    t = max(lo, min(int(t), n))
    while n % t and t > lo:
        t -= 1
    return t if n % t == 0 else n


def snap_ty_kstep(ty: int, ny: int, k_steps: int) -> int:
    """Legal k-step y-window: a divisor of `ny` that is at least
    `k_steps * HALO` (each local step consumes a HALO-deep ring of window
    validity). Prefers the largest legal divisor <= `ty`; falls back to the
    smallest legal divisor (possibly ny itself) when `ty` is too small. The
    JAX package's rule, so a k-step program is refused where it refuses
    it."""
    lo = max(2, k_steps * HALO)
    if ny < lo:
        raise ValueError(
            f"ny={ny} < k_steps*HALO={lo}: no window can hold the k-step "
            f"validity front; use a bigger grid or a smaller k_steps")
    divisors = [d for d in range(lo, ny + 1) if ny % d == 0]
    at_most = [d for d in divisors if d <= ty]
    return at_most[-1] if at_most else divisors[0]


def dycore_cluster(nf: int) -> int:
    """Field blocks of one tile that the whole-state kernel runs as a thread
    block cluster, sharing one copy of w's sweep coefficients: the largest
    divisor of `nf` up to `MAX_CLUSTER` (1 for one field)."""
    return max(d for d in range(1, min(nf, MAX_CLUSTER) + 1) if nf % d == 0)


# the whole-state kernel's candidate (ty, tx) requests, which
# `compile(tune="measure")` times beside the default (`dycore_tile` may
# shrink a request's ty, so two requests can give one tile)
FUSED_TILES = ((8, 32), (12, 32), (16, 32), (20, 32), (24, 32), (8, 64))


def dycore_default(nf: int) -> Tuple[int, int]:
    """The whole-state kernel's default (ty, tx): 24 x 32 for several
    fields, the tallest tile of 32 columns a block of 1024 threads holds
    (1.31x the columns in halo, against 1.69x at 8 x 32); 16 x 32 for one
    field, where the 24-row tile's blocks would fill the card's block slots
    only 1.3 times on the paper's ensemble, a third of the card idle through
    the second wave. chip_smoke.py times the candidates on the H100
    (PERF.md)."""
    return (24, 32) if nf > 1 else (16, 32)


def dycore_tile(ny: int, nx: int, ty: Optional[int] = None,
                tx: Optional[int] = None, *, nz: int = 64,
                nf: int = 1) -> CudaTile:
    """The whole-state kernel's tile for `nf` fields of `nz` levels: one
    thread per column of the haloed tile, two fp32 levels of it in shared
    memory, the sweep's scratch in device memory (so any nz >= 2 runs the
    one build), and the tile's field blocks in clusters of
    `dycore_cluster(nf)`. `ty`, `tx` default to `dycore_default(nf)`; `ty`
    then shrinks, by at most half, to the rows that compute the fewest
    haloed rows over the grid, tiles_y * (ty + 4) (a divisor of ny where
    one costs no more)."""
    if nz < 2:
        raise ValueError(f"dycore_fused: nz={nz} must be >= 2 (staggered "
                         f"vertical sweep)")
    dty, dtx = dycore_default(nf)
    ty, tx = min(ty or dty, ny), min(tx or dtx, nx)
    ty = min(range(max(1, ty // 2), ty + 1),
             key=lambda t: (-(-ny // t) * (t + 2 * HALO), -t))
    cols = (ty + 2 * HALO) * (tx + 2 * HALO)
    return CudaTile("dycore_fused", ty, tx, cols, 2 * 4 * cols,
                    cluster=dycore_cluster(nf))


# The dycore k-step kernel (`csrc/dycore_kstep.cu`): one thread a column,
# holding the column's field and stage in 2·64 fp32 registers. Built
# with `__launch_bounds__(256, 1)`, so ptxas keeps a thread within 255
# registers and one block of at most 256 threads fits an SM's register file;
# the register arrays hold 64 levels, so the kernel takes 2 <= nz <= 64.
DYCORE_KSTEP_THREADS = 256
DYCORE_KSTEP_MAX_NZ = 64
_KSTEP_CHUNK, _KSTEP_BUFS = 8, 3                   # as in the kernel
# the k-step kernel's candidate (ty, tx) requests for
# `compile(tune="measure")`; a request `dycore_kstep_tile` refuses at a
# grid, nz or k is no candidate there
DYCORE_KSTEP_TILES = ((16, 32), (32, 24), (8, 32), (16, 24), (24, 24),
                      (32, 16))


def check_kstep_nz(nz: int) -> None:
    """Raises unless the k-step kernel takes `nz` levels: 2 (the staggered
    sweep's least) to 64 (its register arrays' size)."""
    if not 2 <= nz <= DYCORE_KSTEP_MAX_NZ:
        raise ValueError(f"dycore k-step: nz={nz} outside [2, "
                         f"{DYCORE_KSTEP_MAX_NZ}]: the kernel's register "
                         f"arrays hold {DYCORE_KSTEP_MAX_NZ} levels")


def dycore_kstep_smem(nz: int, rows: int, tw: int) -> int:
    """Shared memory of one k-step block of `rows` x `tw` columns: a record
    per column of w's Thomas coefficients (as, divided) and the field's
    utens, 3 floats a level and an odd stride, and three plane buffers of 8
    levels with 2 ghost rows on each side."""
    return 4 * ((3 * nz | 1) * rows * tw + _KSTEP_BUFS * _KSTEP_CHUNK *
                (rows + 4) * tw)


def dycore_kstep_default(k: int) -> Tuple[int, int]:
    """The default (ty, tx) of a k-step round: 16 x 32 up to k = 2, 32 x 24
    from k = 3, where the deeper halo makes a taller tile pay (chip_smoke.py
    times both tilings of each round on the H100; PERF.md)."""
    return (16, 32) if k <= 2 else (32, 24)


def dycore_kstep_tile(ny: int, nx: int, k: int, ty: Optional[int] = None,
                      tx: Optional[int] = None, nz: int = 64) -> CudaTile:
    """A `ty` x `tx` tile of output columns with a `2k`-deep halo, run by a
    cluster of blocks that split its `ty+4k` rows, `rows` a block, one
    thread a column of `tx+4k`. `ty` (default `dycore_kstep_default`) snaps
    as the JAX package's k-step window does (`snap_ty_kstep`), which
    refuses `ny < 2k`. `tx=None` takes the widest tile up to the default
    whose cluster has at most 8 blocks; an explicit `tx` is kept or
    refused. Raises when the tile does not fit: a
    block of at most 256 threads and 227 KB of shared memory (at `nz`
    levels) with 2 rows or more, a cluster of at most 8 blocks."""
    check_kstep_nz(nz)
    ty = snap_ty_kstep(dycore_kstep_default(k)[0] if ty is None else ty, ny,
                       k)
    halo = 2 * k * HALO
    need = ty + halo                      # haloed rows the cluster covers

    def most_rows(tw):                    # rows of tw columns a block holds
        rows = DYCORE_KSTEP_THREADS // tw
        while rows and dycore_kstep_smem(nz, rows, tw) > SMEM_BYTES_PER_BLOCK:
            rows -= 1
        return rows

    if tx is None:                        # narrow until a cluster covers it
        tx = min(dycore_kstep_default(k)[1], nx)
        while tx > 1 and most_rows(tx + halo) * MAX_CLUSTER < need:
            tx -= 1
    tx = min(tx, nx)
    tw = tx + halo
    rows = most_rows(tw)
    if rows < 2:
        raise ValueError(f"dycore_kstep tile {ty}x{tx} at k={k}: a row of "
                         f"{tw} columns leaves room for {rows} rows in a "
                         f"block; at least 2")
    cluster = -(-need // rows)
    if cluster > MAX_CLUSTER:
        raise ValueError(f"dycore_kstep tile {ty}x{tx} at k={k} needs a "
                         f"cluster of {cluster} blocks of {rows} rows; at "
                         f"most {MAX_CLUSTER}")
    rows = -(-need // cluster)            # the fewest rows a block
    return CudaTile("dycore_kstep", ty, tx, rows * tw,
                    dycore_kstep_smem(nz, rows, tw), cluster=cluster,
                    rows=rows)


# The hadv row stream (`csrc/hadv.cu`): a block holds HADV_WARPS warps, and
# a warp streams one y-segment of one x-strip of a plane through a ring of
# HADV_RING rows, 16 bytes of a row a lane (4 fp32 or 8 bf16 columns, 32
# apart), so a strip is at most 512 bytes wide.
HADV_RING = 8
HADV_WARPS = 4
HADV_SEGMENT = 32       # default tallest segment
# the stream's candidate (ty, tx) requests for `compile(tune="measure")`
HADV_TILES = tuple((ty, tx) for ty in (16, 32, 64) for tx in (128, 64, 32))


def ring_region(n: int, itemsize: int) -> int:
    """Bytes of a ring region that holds a segment of `n` elements at any
    alignment in 16-byte chunks (`nero::ring_region` in
    `csrc/warp_ring.cuh`)."""
    return 16 * ((n * itemsize + 15) // 16 + 1)


def hadv_smem(tx: int, itemsize: int) -> int:
    """Shared bytes of an hadv block (`block_smem` in `csrc/hadv.cu`): a
    ring region of a strip of `tx` columns and its left neighbour, and a
    16-byte chunk for the periodic wrap, a ring row and warp."""
    return HADV_WARPS * HADV_RING * (ring_region(tx + 1, itemsize) + 16)


def hadv_tile(ny: int, nx: int, itemsize: int = 4, ty: Optional[int] = None,
              tx: Optional[int] = None) -> CudaTile:
    """The hadv stream's tile: balanced y-segments of at most `ty` rows
    (default HADV_SEGMENT) and x-strips of at most `tx` columns (default
    the widest a warp holds, 16 bytes a lane), a warp a (segment, strip);
    257 fp32 columns are 3 strips of 86, 256 are 2 of 128."""
    widest = 32 * (16 // itemsize)
    tx = widest if tx is None else tx
    if not 1 <= tx <= widest:
        raise ValueError(f"hadv tile: a strip of {tx} columns needs "
                         f"{-(-tx // (16 // itemsize))} threads of "
                         f"{16 // itemsize} columns; a warp has 32")
    ty = balanced(ny, HADV_SEGMENT if ty is None else ty)
    tx = balanced(nx, tx)
    return CudaTile("hadv", ty, tx, 32 * HADV_WARPS, hadv_smem(tx, itemsize))


# ---------------------------------------------------------------------------
# The planner's tile space (a port of `repro.core.tiling`)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class OpSpec:
    """Abstract description of a memory-bound operator for planning.

    `fields_in` / `fields_out`: number of same-shaped 3-D input/output
    fields the op streams (vadvc: 7 in / 1 out; hdiff: 1 in / 1 out); may be
    fractional when a stream is amortized across an outer batch axis.
    `halo`: per-axis one-sided halo (hdiff: (0, 2, 2)). `halo_tiles`: extra
    per-axis halo in multiples of the tile extent (dycore_kstep: (0, 1, 0)).
    `seq_axes`: axes kept whole because the op is sequential along them
    (vadvc: z; lru_scan: t). `flops_per_point`: useful FLOPs per output
    point. `scratch_fields`: tile-shaped fp32 temporaries, sized to the
    padded window when `scratch_padded`. `extra_vmem_buffers`:
    padded-window dtype-width buffers beyond those.
    """

    name: str
    fields_in: float
    fields_out: int
    halo: Tuple[int, int, int]
    seq_axes: Tuple[int, ...]
    flops_per_point: float
    scratch_fields: int = 0
    parallel_axes: Tuple[int, ...] = ()
    halo_tiles: Tuple[int, int, int] = (0, 0, 0)
    scratch_padded: bool = False
    extra_vmem_buffers: float = 0.0

    @property
    def bytes_moved_per_point(self) -> float:
        """Ideal main-memory traffic per point per dtype-byte."""
        return float(self.fields_in + self.fields_out)

    def arithmetic_intensity(self, dtype) -> float:
        return self.flops_per_point / (
            self.bytes_moved_per_point * hw.dtype_bytes(dtype))


# The JAX package's op specs, value for value (`repro/core/tiling.py`).
HDIFF = OpSpec(
    name="hdiff", fields_in=1, fields_out=1, halo=(0, 2, 2),
    seq_axes=(), parallel_axes=(0, 1, 2), flops_per_point=21.0)

# vadvc: 7 input fields (ccol, dcol, wcon, ustage, upos, utens,
# utensstage), 1 output, ~38 flops a point, sequential in z.
VADVC = OpSpec(
    name="vadvc", fields_in=7, fields_out=1, halo=(0, 0, 1),
    seq_axes=(0,), parallel_axes=(1, 2), flops_per_point=38.0,
    scratch_fields=3)

COPY = OpSpec(
    name="copy", fields_in=1, fields_out=1, halo=(0, 0, 0),
    seq_axes=(), parallel_axes=(0, 1, 2), flops_per_point=0.0)

LRU_SCAN = OpSpec(
    name="lru_scan", fields_in=3, fields_out=1, halo=(0, 0, 0),
    seq_axes=(0,), parallel_axes=(1,), flops_per_point=9.0,
    scratch_fields=1)

# vadvc (38) + update (2) + hdiff (21) flops a point; z and x whole.
DYCORE_FUSED = OpSpec(
    name="dycore_fused", fields_in=4, fields_out=2, halo=(0, 2, 0),
    seq_axes=(0, 2), parallel_axes=(1,), flops_per_point=61.0,
    scratch_fields=6)

HADV_UPWIND = OpSpec(
    name="hadv_upwind", fields_in=1, fields_out=1, halo=(0, 1, 1),
    seq_axes=(), parallel_axes=(0, 1, 2), flops_per_point=5.0)

VADVC_UPDATE = OpSpec(
    name="vadvc_update", fields_in=7, fields_out=2, halo=(0, 0, 1),
    seq_axes=(0,), parallel_axes=(1, 2), flops_per_point=40.0,
    scratch_fields=3)

ASSELIN = OpSpec(
    name="asselin", fields_in=3, fields_out=1, halo=(0, 0, 0),
    seq_axes=(), parallel_axes=(0, 1, 2), flops_per_point=3.0)


def pipeline_spec(name: str, stage_specs: Sequence[OpSpec], *,
                  fields_in: float, fields_out: int,
                  halo: Tuple[int, int, int]) -> OpSpec:
    """The tile space of a stage chain (`weather/pipeline.py`), as the
    model prices it: ONE pass streams the union of the stages' operands
    (`fields_in` / `fields_out`, from the chain's operand bindings) while
    intermediates stay on chip, so flops are the sum over the stages and
    the byte streams are not. Sequential axes union (one z-sequential
    stage pins the chain's z), scratch is the largest stage's, and `halo`
    is the chain's summed one-sided reach. The port runs a chain as one
    launch a stage, its intermediates in device memory: this is the
    model's chain, not what runs."""
    if not stage_specs:
        raise ValueError("pipeline needs at least one stage spec")
    seq = tuple(sorted({a for s in stage_specs for a in s.seq_axes}))
    par = tuple(sorted(set(range(3)) - set(seq)))
    return OpSpec(
        name=name, fields_in=float(fields_in), fields_out=int(fields_out),
        halo=tuple(int(h) for h in halo), seq_axes=seq, parallel_axes=par,
        flops_per_point=float(sum(s.flops_per_point for s in stage_specs)),
        scratch_fields=max(s.scratch_fields for s in stage_specs))


def dycore_whole_state_spec(n_fields: int = 4) -> OpSpec:
    """Tile space of the whole-state fused dycore step: 3 private input
    streams per field plus the shared `w` amortized over the field axis,
    and `w`'s window resident beside the 6 temporaries (7 scratch)."""
    if n_fields < 1:
        raise ValueError(f"n_fields={n_fields} must be >= 1")
    return OpSpec(
        name="dycore_whole_state", fields_in=3 + 1.0 / n_fields,
        fields_out=2, halo=(0, 2, 0), seq_axes=(0, 2), parallel_axes=(1,),
        flops_per_point=61.0, scratch_fields=7)


DYCORE_WHOLE_STATE = dycore_whole_state_spec()


def dycore_kstep_spec(n_fields: int = 4, k_steps: int = 2) -> OpSpec:
    """Tile space of the k-step fused dycore round: a three-window working
    slab (`halo_tiles=(0, 1, 0)`), 8 padded temporaries, 2 padded `w`
    prefetch buffers; the bytes of one step and the flops of k."""
    if n_fields < 1:
        raise ValueError(f"n_fields={n_fields} must be >= 1")
    if k_steps < 1:
        raise ValueError(f"k_steps={k_steps} must be >= 1")
    return OpSpec(
        name="dycore_kstep", fields_in=3 + 1.0 / n_fields, fields_out=2,
        halo=(0, 0, 0), halo_tiles=(0, 1, 0), seq_axes=(0, 2),
        parallel_axes=(1,), flops_per_point=61.0 * k_steps,
        scratch_fields=8, scratch_padded=True, extra_vmem_buffers=2.0)


DYCORE_KSTEP = dycore_kstep_spec()


@dataclasses.dataclass(frozen=True)
class TilePlan:
    """A concrete 3-D window choice for an OpSpec on a grid."""

    op: OpSpec
    grid_shape: Tuple[int, int, int]     # full (z, y, x) domain
    tile: Tuple[int, int, int]           # window shape (z, y, x)
    dtype: str
    pipeline_depth: int = 2              # double buffering

    @property
    def tile_points(self) -> int:
        return int(self.tile[0] * self.tile[1] * self.tile[2])

    @property
    def padded_tile(self) -> Tuple[int, int, int]:
        """Window + halos staged into near memory."""
        return tuple(t + 2 * h + 2 * ht * t for t, h, ht in
                     zip(self.tile, self.op.halo, self.op.halo_tiles))

    @property
    def num_tiles(self) -> int:
        return int(math.prod(
            math.ceil(g / t) for g, t in zip(self.grid_shape, self.tile)))

    @property
    def vmem_bytes(self) -> int:
        """Near-memory bytes the plan claims: double-buffered streamed
        fields, fp32 scratch and the op's extra buffers."""
        b = hw.dtype_bytes(self.dtype)
        pt = math.prod(self.padded_tile)
        streamed = (self.op.fields_in + self.op.fields_out) * pt * b
        scratch_pts = pt if self.op.scratch_padded else self.tile_points
        scratch = self.op.scratch_fields * scratch_pts * max(b, 4)
        extra = self.op.extra_vmem_buffers * pt * b
        return int(streamed * self.pipeline_depth + scratch + extra)

    def fits(self, hier: hw.Hierarchy) -> bool:
        return self.vmem_bytes <= hier.vmem.capacity_bytes

    @property
    def lane_aligned(self) -> bool:
        """Minor-most dim a multiple of 128 lanes, next of 8 sublanes (the
        JAX package's candidate order)."""
        z, y, x = self.padded_tile
        return (x % hw.VPU_LANES[1] == 0) and (y % hw.VPU_LANES[0] == 0)

    @property
    def hbm_bytes_per_tile(self) -> int:
        b = hw.dtype_bytes(self.dtype)
        pt = math.prod(self.padded_tile)
        return int((self.op.fields_in * pt + self.op.fields_out *
                    self.tile_points) * b)

    @property
    def hbm_bytes_total(self) -> int:
        return self.hbm_bytes_per_tile * self.num_tiles

    @property
    def halo_overhead(self) -> float:
        """Fraction of main-memory traffic that is redundant halo
        re-reads."""
        ideal = (self.op.bytes_moved_per_point *
                 hw.dtype_bytes(self.dtype) * math.prod(self.grid_shape))
        return self.hbm_bytes_total / max(ideal, 1.0) - 1.0

    @property
    def flops_total(self) -> float:
        return self.op.flops_per_point * math.prod(self.grid_shape)

    def describe(self) -> dict:
        return {"op": self.op.name,
                "grid": list(self.grid_shape),
                "tile": list(self.tile),
                "padded_tile": list(self.padded_tile),
                "dtype": self.dtype,
                "vmem_bytes": int(self.vmem_bytes),
                "lane_aligned": bool(self.lane_aligned),
                "hbm_bytes_total": int(self.hbm_bytes_total),
                "halo_overhead": float(self.halo_overhead)}


def candidate_tiles(op: OpSpec,
                    grid_shape: Sequence[int],
                    dtype,
                    hier: hw.Hierarchy | None = None,
                    max_candidates: int = 512) -> List[TilePlan]:
    """Enumerate the legal tile space (the autotuner's search domain):
    sequential axes whole, the others power-of-two sizes (and the full
    extent), every window within `hier`'s near memory; larger, aligned
    tiles first. `hier` defaults to the H100's."""
    hier = hier or hw.h100_sxm()
    grid_shape = tuple(int(g) for g in grid_shape)

    def axis_options(ax: int) -> List[int]:
        g = grid_shape[ax]
        if ax in op.seq_axes:
            return [g]
        opts = []
        s = 1
        while s <= g:
            opts.append(s)
            s *= 2
        if g not in opts:
            opts.append(g)
        return opts

    plans: List[TilePlan] = []
    for tz in axis_options(0):
        for ty in axis_options(1):
            for tx in axis_options(2):
                plan = TilePlan(op=op, grid_shape=grid_shape,
                                tile=(tz, ty, tx), dtype=dtype_name(dtype))
                if plan.fits(hier):
                    plans.append(plan)
    plans.sort(key=lambda p: (-int(p.lane_aligned), -p.tile_points))
    return plans[:max_candidates]


def cuda_tile_for(plan: TilePlan) -> CudaTile:
    """The kernel tile that launches a planner's hdiff or vadvc window.

    The planner sizes a window against near memory. The hdiff stream takes
    the window's x extent as its strip, clamped to the grid and to the
    columns 1024 threads hold with the halo, and its y extent as its
    segment, clamped to the grid, both then balanced. A vadvc warp takes a
    segment of the window's x extent, clamped to the grid, to VADVC_COLS
    and to what fits the window's nz levels in shared memory; its y extent
    is one row. The window's z extent is not a kernel parameter: both
    kernels take one plane (hdiff) or the whole column (vadvc) per block.
    The tile's shared memory stays within 232,448 bytes at any such shape
    (`CudaTile` checks both limits)."""
    nz, ny, nx = plan.grid_shape
    _, ty, tx = plan.tile
    if plan.op.name == "hdiff":
        return hdiff_tile(ny, nx, max(1, min(ty, ny)), max(1, min(
            tx, nx, HDIFF_COLS * MAX_THREADS_PER_BLOCK - 2 * HALO
            - HDIFF_COLS + 1)))
    if plan.op.name == "vadvc":
        itemsize = hw.dtype_bytes(plan.dtype)
        fit = vadvc_tile(ny, nx, nz, itemsize).tx
        return vadvc_tile(ny, nx, nz, itemsize,
                          max(1, min(tx, nx, VADVC_COLS, fit)))
    raise ValueError(f"no CUDA tile for op {plan.op.name!r}; the copy "
                     f"kernel takes no tile and the others have none yet")
