"""Plain PyTorch slot guard: per-slot validity and content digest.

A port of `repro.weather.program.slot_guard` (an XLA-fused `jnp`
function in the JAX package, no Pallas kernel) over a list of leaves, each
`(E, ...)` with `E` the ensemble (slot) axis. It returns `(ok, fp)`:

* `ok` (E,) bool: every element of the slot finite and `|x| <= limit`,
  with the magnitude compared in the leaf's dtype as the JAX package
  compares it (`limit` rounded to float32, then to the leaf's dtype);
* `fp` (E,) int64 holding the JAX package's uint32 digest exactly: each
  element's bits widened to uint32 (bf16: its 16 bits), plus the position
  hash `sum_d iota_d * FP_AXIS[d % 4]` over the non-ensemble axes d, times
  `FP_MIX`, then `v ^= v >> 16`; XOR over every non-ensemble element (the
  JAX package's halving cascade is that XOR); leaves combined in order as
  `fp = fp * FP_LEAF ^ f`.

Torch has no unsigned 32-bit arithmetic to trust, so the digest is
computed in int64 and masked to 32 bits after every add and multiply;
products are split in 16-bit halves so that none leaves int64. This is
the CPU path of `ops.slot_guard` and the oracle of the CUDA kernel, which
must match it bit for bit.

On a mesh the guard is the same function of the whole state, composed
from the shards: each block's partial words (`guard_words`, its positions
hashed at the block's global offset `(y0, x0)`) are one XOR word and one
magnitude word a (slot, leaf); the blocks' XOR words XOR together and
their magnitude words take the largest (the bits of the largest |x|, NaN
and Inf above every finite value), and `guard_finish` then combines the
leaves in order and holds each leaf's magnitude to `threshold`. Each
distinct block must enter once: a copy would cancel its XOR word.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import torch

FP_MIX = 0x9E3779B1
FP_LEAF = 0x01000193
FP_AXIS = (0x85EBCA6B, 0xC2B2AE35, 0x27D4EB2F, 0x165667B1)
MASK = 0xFFFFFFFF

_BITS = {4: (torch.int32, 0xFFFFFFFF), 2: (torch.int16, 0xFFFF),
         1: (torch.int8, 0xFF)}


def mulmod(v: torch.Tensor, c: int) -> torch.Tensor:
    """`v * c mod 2**32` of int64 values in [0, 2**32), exactly."""
    hi = ((v >> 16) * c) & MASK
    return ((hi << 16) + (v & 0xFFFF) * c) & MASK


def limit_in(dtype: torch.dtype, limit: float) -> torch.Tensor:
    """`limit` as the JAX package compares it with a leaf of `dtype`: a
    weakly typed float32 scalar, cast to the leaf's dtype."""
    return torch.tensor(float(limit), dtype=torch.float32).to(dtype)


def leaf_ok(a: torch.Tensor, limit: float) -> torch.Tensor:
    """(E,) bool: the slot's elements all finite and within `limit`."""
    flat = a.reshape(a.shape[0], -1)
    finite = torch.isfinite(flat)
    mag = torch.where(finite, flat.abs(), torch.zeros_like(flat)).amax(1)
    return finite.all(1) & (mag <= limit_in(a.dtype, limit).to(a.device))


def leaf_bits(a: torch.Tensor) -> torch.Tensor:
    """The leaf's element bits, zero-extended, as int64."""
    try:
        view, mask = _BITS[a.element_size()]
    except KeyError:
        raise ValueError(f"slot_guard: {a.dtype} leaves are not supported "
                         f"(1-, 2- and 4-byte dtypes)") from None
    return a.view(view).to(torch.int64) & mask


def xor_fold(v: torch.Tensor) -> torch.Tensor:
    """XOR of each row of a 2-D int64 tensor, by halving as the JAX
    package folds."""
    while v.shape[1] > 1:
        n = v.shape[1]
        h = n // 2
        r = v[:, :h] ^ v[:, h:2 * h]
        if n % 2:
            r = torch.cat([r, v[:, 2 * h:]], dim=1)
        v = r
    return v[:, 0]


def leaf_fp(a: torch.Tensor, y0: int = 0, x0: int = 0) -> torch.Tensor:
    """(E,) int64: one leaf's uint32 digest per slot. `(y0, x0)`: where the
    leaf's block starts in the whole state's y and x axes (the last two),
    so a block's digest hashes its global positions."""
    bits = leaf_bits(a)
    pos = torch.zeros((), dtype=torch.int64, device=a.device)
    start = {a.dim() - 2: int(y0), a.dim() - 1: int(x0)}
    for d in range(1, a.dim()):
        shape = [1] * a.dim()
        shape[d] = a.shape[d]
        iota = torch.arange(a.shape[d], dtype=torch.int64,
                            device=a.device).reshape(shape)
        iota = (iota + start.get(d, 0)) & MASK
        pos = (pos + mulmod(iota, FP_AXIS[d % len(FP_AXIS)])) & MASK
    v = mulmod((bits + pos) & MASK, FP_MIX)
    v = v ^ (v >> 16)                   # element swaps don't cancel
    return xor_fold(v.reshape(a.shape[0], -1))


# the largest finite magnitude's bits: anything above is Inf or NaN
_MAX_FINITE = {torch.float32: 0x7F7FFFFF, torch.bfloat16: 0x7F7F}
_ABS = {torch.float32: 0x7FFFFFFF, torch.bfloat16: 0x7FFF}


def threshold(dtype: torch.dtype, limit: float) -> int:
    """The largest bits of |x| that pass `|x| <= limit` in `dtype` and are
    finite, or -1 when nothing passes (a NaN or negative limit; a limit of
    zero of either sign passes zeros of either sign)."""
    if dtype not in _MAX_FINITE:
        raise ValueError(f"slot_guard: dtype {dtype}; the guard's words "
                         f"take float32 or bfloat16")
    lim = limit_in(dtype, limit)
    if math.isnan(float(lim)) or float(lim) < 0:
        return -1
    return min(int(leaf_bits(lim.abs().reshape(1))[0]), _MAX_FINITE[dtype])


def guard_words(leaves: Sequence[torch.Tensor], y0: int = 0,
                x0: int = 0) -> torch.Tensor:
    """(E, leaves, 2) int64: each (slot, leaf)'s XOR word (`leaf_fp` at the
    block's offset) and magnitude word (the bits of its largest |x|)."""
    words = []
    for a in leaves:
        if a.dtype not in _ABS:
            raise ValueError(f"slot_guard: dtype {a.dtype}; the guard's "
                             f"words take float32 or bfloat16")
        mag = (leaf_bits(a) & _ABS[a.dtype]).reshape(a.shape[0], -1)
        words.append(torch.stack([leaf_fp(a, y0, x0), mag.amax(1)], dim=-1))
    return torch.stack(words, dim=1)


def guard_finish(words: torch.Tensor, thr: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """`(ok, fp)` from (S, E, leaves, 2) partial words of S distinct
    blocks (zeros where a block holds no slot): XOR and largest magnitude
    over the blocks, then the leaves in order, `fp = fp * FP_LEAF ^ f`, and
    every magnitude at most `thr`."""
    acc = xor_fold(words[..., 0].permute(1, 2, 0).reshape(
        -1, words.shape[0])).reshape(words.shape[1:3])
    mag = words[..., 1].amax(0)
    fp = acc[:, 0]
    for leaf in range(1, acc.shape[1]):
        fp = mulmod(fp, FP_LEAF) ^ acc[:, leaf]
    return (mag <= thr).all(1), fp


def slot_guard(leaves: Sequence[torch.Tensor], limit: float
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """`(ok, fp)` over `leaves` in order (see the module docstring)."""
    oks, fp = [], None
    for leaf in leaves:
        oks.append(leaf_ok(leaf, limit))
        f = leaf_fp(leaf)
        fp = f if fp is None else mulmod(fp, FP_LEAF) ^ f
    return torch.stack(oks).all(0), fp
