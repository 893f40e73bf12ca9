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


def dycore_tile(ny: int, nx: int, ty: int = 8, tx: int = 32) -> CudaTile:
    """One thread per column of the haloed tile; two fp32 levels of it in
    shared memory. `ty` snaps to a divisor of ny when one lies within a
    factor of two, so y-tiles carry no idle rows."""
    ty, tx = min(ty, ny), min(tx, nx)
    snapped = snap_to_divisor(ty, ny, lo=max(1, ty // 2))
    ty = snapped if snapped <= ty else ty
    cols = (ty + 2 * HALO) * (tx + 2 * HALO)
    return CudaTile("dycore_fused", ty, tx, cols, 2 * 4 * cols)
