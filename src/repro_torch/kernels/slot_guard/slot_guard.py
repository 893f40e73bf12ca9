"""The CUDA slot-guard kernel (`csrc/slot_guard.cu`) and its launcher.

Replaces `repro.weather.program.slot_guard` (src/repro/weather/program.py:
263), an XLA-fused `jnp` function with no Pallas kernel. The plain version
beside it is `ref.slot_guard` (over blocks: `ref.guard_words` and
`ref.guard_finish`); the kernel's result is bit-equal to it.
"""

from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import torch

from repro_torch.core.spans import spanned
from repro_torch.kernels import _build
from repro_torch.kernels.slot_guard.ref import threshold

MAX_LEAVES = 16                 # csrc/slot_guard.cu: kMaxLeaves
_DTYPES = (torch.float32, torch.bfloat16)


def _describe(leaves: Sequence[torch.Tensor]):
    """The kernel's view of CUDA `leaves`, each `(E, nz, ny, nx)` of one
    shape, dtype (float32 or bfloat16) and device, x contiguous (any other
    strides; a leaf whose x axis is not contiguous is copied): the leaf
    descriptors, the leaves (kept alive while the launch reads them), the
    shape and whether every row takes 16-byte loads."""
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
    if t0.dtype not in _DTYPES:
        raise ValueError(f"slot_guard: dtype {t0.dtype}; the kernel takes "
                         f"float32 or bfloat16")
    nx = t0.shape[-1]
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
    return desc, leaves, tuple(t0.shape), int(vec)


@spanned("nero.kernel.slot_guard")
def slot_guard_cuda(leaves: Sequence[torch.Tensor], limit: float
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """`(ok, fp)` of CUDA leaves (see `_describe`): ok (E,) bool, fp (E,)
    int64 holding each slot's uint32 digest. One call: the partial pass and
    the leaves' combine, counted as one launch."""
    desc, leaves, (E, nz, ny, nx), vec = _describe(leaves)
    t0 = leaves[0]
    words = torch.empty((E, len(leaves), 2), dtype=torch.int32,
                        device=t0.device)
    fp = torch.empty(E, dtype=torch.int64, device=t0.device)
    ok = torch.empty(E, dtype=torch.bool, device=t0.device)
    lib = _build.load()
    with torch.cuda.device(t0.device):
        err = lib.nero_slot_guard(
            ctypes.addressof(desc), len(leaves), E, nz, ny, nx,
            int(t0.dtype == torch.bfloat16), vec,
            threshold(t0.dtype, limit), words.data_ptr(), fp.data_ptr(),
            ok.data_ptr(), _build.stream_of(t0))
    _build.check(err, "slot_guard")
    _build.LAUNCHES["slot_guard"] += 1
    return ok, fp


@spanned("nero.kernel.slot_guard")
def slot_guard_blocks_cuda(blocks, ensemble: int, limit: float
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """`(ok, fp)` of a state held in blocks on CUDA devices: `blocks` lists
    each distinct block once as `(leaves, e0, y0, x0)`, its leaves (see
    `_describe`) and where it starts in the whole state's ensemble, y and
    x axes. One partial launch a block, on its device, into its rows of an
    `(S, ensemble, leaves, 2)` word buffer on the first block's device
    (a block on another device fills its own and is copied over), then one
    combine launch there: S + 1 launches, counted as such. Returns tensors
    on the first block's device."""
    blocks = list(blocks)
    first = blocks[0][0][0]
    dev0 = first.device
    nleaves = len(blocks[0][0])
    thr = threshold(first.dtype, limit)
    words = torch.zeros((len(blocks), ensemble, nleaves, 2),
                        dtype=torch.int32, device=dev0)
    lib = _build.load()
    for s, (leaves, e0, y0, x0) in enumerate(blocks):
        desc, leaves, (E, nz, ny, nx), vec = _describe(leaves)
        t0 = leaves[0]
        if len(leaves) != nleaves or t0.dtype != first.dtype:
            raise ValueError(f"slot_guard: block {s} has {len(leaves)} "
                             f"{t0.dtype} leaves; block 0 has {nleaves} "
                             f"{first.dtype}")
        rows = words[s, e0:e0 + E]
        out = rows if t0.device == dev0 else torch.zeros(
            rows.shape, dtype=torch.int32, device=t0.device)
        with torch.cuda.device(t0.device):
            err = lib.nero_slot_guard_partial(
                ctypes.addressof(desc), nleaves, E, nz, ny, nx,
                int(t0.dtype == torch.bfloat16), vec, int(y0), int(x0),
                out.data_ptr(), _build.stream_of(t0))
        _build.check(err, "slot_guard_partial")
        _build.LAUNCHES["slot_guard"] += 1
        if out is not rows:
            rows.copy_(out)
    fp = torch.empty(ensemble, dtype=torch.int64, device=dev0)
    ok = torch.empty(ensemble, dtype=torch.bool, device=dev0)
    with torch.cuda.device(dev0):
        err = lib.nero_slot_guard_finish(
            words.data_ptr(), len(blocks), ensemble, nleaves, thr,
            fp.data_ptr(), ok.data_ptr(), _build.stream_of(words))
    _build.check(err, "slot_guard_finish")
    _build.LAUNCHES["slot_guard"] += 1
    return ok, fp
