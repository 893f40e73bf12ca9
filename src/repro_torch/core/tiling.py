"""Tile choice for the CUDA stencil kernels on an H100.

The JAX package tunes its TPU tiles against VMEM (`repro.core.tiling` and
`repro.core.autotune`). The port starts from fixed defaults per kernel that
fit a Hopper block: at most 1024 threads and 227 KB of shared memory
(232,448 bytes, NVIDIA's H100 data sheet). A tuner is later work. Every
kernel masks its own ragged edge tiles, so a tile need not divide the grid;
results do not depend on the tile, bit for bit.
"""

from __future__ import annotations

import dataclasses

MAX_THREADS_PER_BLOCK = 1024
SMEM_BYTES_PER_BLOCK = 232_448
HALO = 2


def snap_to_divisor(t: int, n: int, lo: int = 2) -> int:
    """Largest divisor of `n` that is `<= t` and `>= lo`; falls back to `n`
    itself when no divisor lands in `[lo, t]` (the JAX package's rule)."""
    t = max(lo, min(int(t), n))
    while n % t and t > lo:
        t -= 1
    return t if n % t == 0 else n


@dataclasses.dataclass(frozen=True)
class CudaTile:
    """A kernel's block shape: `ty` x `tx` output points (vadvc: columns)
    per block, the block's threads and its shared memory."""

    op: str
    ty: int
    tx: int
    threads: int
    smem_bytes: int

    def __post_init__(self):
        if not 1 <= self.threads <= MAX_THREADS_PER_BLOCK:
            raise ValueError(f"{self.op} tile {self.ty}x{self.tx} needs "
                             f"{self.threads} threads per block; at most "
                             f"{MAX_THREADS_PER_BLOCK}")
        if self.smem_bytes > SMEM_BYTES_PER_BLOCK:
            raise ValueError(f"{self.op} tile {self.ty}x{self.tx} needs "
                             f"{self.smem_bytes} bytes of shared memory; at "
                             f"most {SMEM_BYTES_PER_BLOCK}")

    def describe(self) -> dict:
        return dataclasses.asdict(self)


def hdiff_tile(ny: int, nx: int, ty: int = 8, tx: int = 32) -> CudaTile:
    """One thread per output point; the tile plus its 2-deep halo staged in
    shared memory as fp32."""
    ty, tx = min(ty, ny), min(tx, nx)
    return CudaTile("hdiff", ty, tx, ty * tx,
                    4 * (ty + 2 * HALO) * (tx + 2 * HALO))


def vadvc_tile(ny: int, nx: int, tj: int = 2, ti: int = 128) -> CudaTile:
    """One thread per (y, x) column; no shared memory."""
    tj, ti = min(tj, ny), min(ti, nx)
    return CudaTile("vadvc", tj, ti, tj * ti, 0)


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


def dycore_tile(ny: int, nx: int, ty: int = 8, tx: int = 32) -> CudaTile:
    """One thread per column of the haloed tile; two fp32 levels of it in
    shared memory. `ty` snaps to a divisor of ny when one lies within a
    factor of two, so y-tiles carry no idle rows."""
    ty, tx = min(ty, ny), min(tx, nx)
    snapped = snap_to_divisor(ty, ny, lo=max(1, ty // 2))
    ty = snapped if snapped <= ty else ty
    cols = (ty + 2 * HALO) * (tx + 2 * HALO)
    return CudaTile("dycore_fused", ty, tx, cols, 2 * 4 * cols)


# Threads per block of the k-step kernels, which loop over their tile's
# columns or points (`csrc/dycore_kstep.cu` is built for at most 512).
KSTEP_THREADS = 512


def dycore_kstep_tile(ny: int, nx: int, k: int, ty: int = 8,
                      tx: int = 32) -> CudaTile:
    """A `ty` x `tx` tile of output columns with a `2k`-deep halo,
    `(ty+4k)·(tx+4k)` columns that the threads loop over; two fp32 levels of
    them and each column's running Thomas value in shared memory. `ty`
    snaps as the JAX package's k-step window does (`snap_ty_kstep`), which
    refuses `ny < 2k`."""
    ty, tx = snap_ty_kstep(ty, ny, k), min(tx, nx)
    cols = (ty + 2 * k * HALO) * (tx + 2 * k * HALO)
    return CudaTile("dycore_kstep", ty, tx, min(cols, KSTEP_THREADS),
                    3 * 4 * cols)


def hdiff_kstep_tile(ny: int, nx: int, k: int, ty: int = 8,
                     tx: int = 32) -> CudaTile:
    """A `ty` x `tx` tile of output points with a `2k`-deep halo,
    `(ty+4k)·(tx+4k)` points that the threads loop over, in two fp32
    shared-memory buffers."""
    ty, tx = min(ty, ny), min(tx, nx)
    points = (ty + 2 * k * HALO) * (tx + 2 * k * HALO)
    return CudaTile("hdiff_kstep", ty, tx, min(points, KSTEP_THREADS),
                    2 * 4 * points)


def hadv_tile(ny: int, nx: int, ty: int = 8, tx: int = 32) -> CudaTile:
    """One thread per output point; no shared memory."""
    ty, tx = min(ty, ny), min(tx, nx)
    return CudaTile("hadv", ty, tx, ty * tx, 0)
