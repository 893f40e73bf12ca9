"""The CUDA slot-guard kernel (`csrc/slot_guard.cu`) and its launcher.

Replaces `repro.weather.program.slot_guard` (src/repro/weather/program.py:
263), an XLA-fused `jnp` function with no Pallas kernel. The plain version
beside it is `ref.slot_guard`; the kernel's result is bit-equal to it.
"""

from __future__ import annotations

import ctypes
import math
from typing import Sequence, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.slot_guard.ref import limit_in

MAX_LEAVES = 16                 # csrc/slot_guard.cu: kMaxLeaves
# the largest finite magnitude's bits: anything above is Inf or NaN
_MAX_FINITE = {torch.float32: 0x7F7FFFFF, torch.bfloat16: 0x7F7F}
_BITS = {torch.float32: torch.int32, torch.bfloat16: torch.int16}


def threshold(dtype: torch.dtype, limit: float) -> int:
    """The largest bits of |x| that pass `|x| <= limit` in `dtype` and are
    finite, or -1 when nothing passes (a NaN or negative limit; a limit of
    zero of either sign passes zeros of either sign)."""
    lim = limit_in(dtype, limit)
    if math.isnan(float(lim)) or float(lim) < 0:
        return -1
    bits = int(lim.abs().view(_BITS[dtype])) & (0xFFFFFFFF if dtype ==
                                                torch.float32 else 0xFFFF)
    return min(bits, _MAX_FINITE[dtype])


def slot_guard_cuda(leaves: Sequence[torch.Tensor], limit: float
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """`(ok, fp)` of CUDA leaves, each `(E, nz, ny, nx)` of one shape and
    one dtype (float32 or bfloat16), x contiguous (any other strides; a
    leaf whose x axis is not contiguous is copied): ok (E,) bool, fp (E,)
    int64 holding each slot's uint32 digest."""
    leaves = list(leaves)
    if not 1 <= len(leaves) <= MAX_LEAVES:
        raise ValueError(f"slot_guard: {len(leaves)} leaves; the kernel "
                         f"takes 1 to {MAX_LEAVES}")
    t0 = leaves[0]
    if t0.dim() != 4:
        raise ValueError(f"slot_guard: leaves must be (E, nz, ny, nx), got "
                         f"{tuple(t0.shape)}")
    for i, t in enumerate(leaves):
        if not isinstance(t, torch.Tensor) or t.device.type != "cuda":
            raise ValueError(f"slot_guard: leaf {i} must be a CUDA tensor, "
                             f"got {getattr(t, 'device', type(t))}")
        if t.device != t0.device or t.shape != t0.shape or \
                t.dtype != t0.dtype:
            raise ValueError(f"slot_guard: leaf {i} is {tuple(t.shape)} "
                             f"{t.dtype} on {t.device}; leaf 0 is "
                             f"{tuple(t0.shape)} {t0.dtype} on {t0.device}")
    if t0.dtype not in _BITS:
        raise ValueError(f"slot_guard: dtype {t0.dtype}; the kernel takes "
                         f"float32 or bfloat16")
    E, nz, ny, nx = t0.shape
    leaves = [t if t.stride(-1) == 1 or nx == 1 else t.contiguous()
              for t in leaves]
    vec_elems = 16 // t0.element_size()
    vec = nx % vec_elems == 0 and all(
        t.data_ptr() % 16 == 0
        and all(s % vec_elems == 0 for s in t.stride()[:3])
        for t in leaves)
    desc = (ctypes.c_longlong * (4 * len(leaves)))()
    for i, t in enumerate(leaves):
        desc[4 * i:4 * i + 4] = [t.data_ptr(), *t.stride()[:3]]
    words = torch.empty((E, len(leaves), 2), dtype=torch.int32,
                        device=t0.device)
    fp = torch.empty(E, dtype=torch.int64, device=t0.device)
    ok = torch.empty(E, dtype=torch.bool, device=t0.device)
    lib = _build.load()
    with torch.cuda.device(t0.device):
        err = lib.nero_slot_guard(
            ctypes.addressof(desc), len(leaves), E, nz, ny, nx,
            int(t0.dtype == torch.bfloat16), int(vec),
            threshold(t0.dtype, limit), words.data_ptr(), fp.data_ptr(),
            ok.data_ptr(), _build.stream_of(t0))
    _build.check(err, "slot_guard")
    _build.LAUNCHES["slot_guard"] += 1
    return ok, fp
