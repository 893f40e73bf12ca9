"""Public slot-guard entry point: the leaves' device decides what runs.

CPU leaves take the plain version (`ref.slot_guard`); CUDA leaves launch
the CUDA kernel (`slot_guard.slot_guard_cuda`) or raise. There is no
fallback. `slot_guard_blocks` is the guard of a state held in blocks (a
sharded lane): one partial pass a block, then one combine.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from repro_torch.kernels.slot_guard import ref as _ref
from repro_torch.kernels.slot_guard.slot_guard import (slot_guard_blocks_cuda,
                                                       slot_guard_cuda)


def slot_guard(leaves: Sequence[torch.Tensor], limit: float
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """`(ok, fp)` per slot of `(E, ...)` leaves: ok (E,) bool, fp (E,)
    int64 holding the JAX package's uint32 digest."""
    leaves = list(leaves)
    if all(t.device.type == "cpu" for t in leaves):
        return _ref.slot_guard(leaves, limit)
    return slot_guard_cuda(leaves, limit)


def slot_guard_blocks(blocks, ensemble: int, limit: float
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """`(ok, fp)` of a state held in blocks, each distinct block listed
    once as `(leaves, e0, y0, x0)` (its `(E_b, nz, ny_b, nx_b)` leaves and
    where it starts in the whole state's ensemble, y and x axes): the
    whole state's `slot_guard`, over `ensemble` slots."""
    blocks = list(blocks)
    if all(t.device.type == "cpu" for leaves, *_ in blocks for t in leaves):
        nleaves = len(blocks[0][0])
        words = torch.zeros((len(blocks), ensemble, nleaves, 2),
                            dtype=torch.int64)
        for s, (leaves, e0, y0, x0) in enumerate(blocks):
            w = _ref.guard_words(leaves, y0, x0)
            words[s, e0:e0 + w.shape[0]] = w
        return _ref.guard_finish(words, _ref.threshold(blocks[0][0][0].dtype,
                                                       limit))
    return slot_guard_blocks_cuda(blocks, ensemble, limit)
