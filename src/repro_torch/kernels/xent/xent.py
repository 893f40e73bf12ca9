"""The CUDA cross-entropy kernels and their launcher, two routes by dtype.

Replaces the TPU kernel `repro.kernels.xent.xent.xent_pallas`. Both
kernels compute what it computes — per row, logits against vocab tiles of
the head with fp32 accumulation, `softcap`, padding columns at -1e30, and a
streaming max / sum / gold logit, so that no logit reaches device memory —
and also take N, D and Vp that their tiles do not divide and a head in
either layout (`(D, Vp)` contiguous along V, or `embed.T`), where the TPU
kernel needs both to tile. The dtype picks the route, with no fallback:

- bfloat16: the tensor-core route, `csrc/xent_tc.cu`: the product as bf16
  `wgmma` with fp32 accumulation (a product of two bf16 values is exact in
  fp32), 128 rows by 256 columns a block, the depth in stages of 64
  through a four-stage ring, the max / sum / gold fold in registers.
- float32: the fp32-core route, `csrc/xent.cu`, 128 by 128 a block.

Each returns each row's NLL and log-normaliser (`lse`, which the backward
reuses). Their plain version is `ref.xent_rows`. The launcher is the
forward kernel alone: gradients go through `ops.XentFn`.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.core.spans import spanned
from repro_torch.kernels import _build

BN, BV = 128, 128          # the fp32 kernel's row and vocabulary tiles
BLOCKS_PER_SM = 2          # its `__launch_bounds__`
TC_BN, TC_BV = 128, 256    # the bf16 tensor-core kernel's (`xent_tc.cu`)
TC_BLOCKS_PER_SM = 1       # its `__launch_bounds__`: 193 KB of shared memory
TC_DEPTH, TC_STAGES = 64, 4   # its depth stage and ring
TC_SMEM = TC_STAGES * (TC_BN + TC_BV) * TC_DEPTH * 2 + 1024   # + alignment


def tiles(dtype: torch.dtype = torch.float32) -> Tuple[int, int, int]:
    """(rows, vocabulary columns, blocks a SM) of the route of `dtype`."""
    if dtype == torch.bfloat16:
        return TC_BN, TC_BV, TC_BLOCKS_PER_SM
    return BN, BV, BLOCKS_PER_SM


def check_operands(hidden, head, targets, valid, vocab: int) -> None:
    """hidden (N, D) and head (D, Vp) of one float dtype, targets (N,)
    integer, valid (N,) or None, 0 <= vocab <= Vp."""
    if hidden.dim() != 2 or head.dim() != 2 or head.shape[0] != hidden.shape[1]:
        raise ValueError(f"xent: hidden {tuple(hidden.shape)} and head "
                         f"{tuple(head.shape)} must be (N, D) and (D, Vp)")
    n = hidden.shape[0]
    if tuple(targets.shape) != (n,) or targets.is_floating_point():
        raise ValueError(f"xent: targets must be integer ({n},), got "
                         f"{targets.dtype} {tuple(targets.shape)}")
    if valid is not None and tuple(valid.shape) != (n,):
        raise ValueError(f"xent: valid must be ({n},), got "
                         f"{tuple(valid.shape)}")
    if hidden.dtype != head.dtype:
        raise ValueError(f"xent: dtypes differ: {hidden.dtype}, "
                         f"{head.dtype}")
    if not 0 <= vocab <= head.shape[1]:
        raise ValueError(f"xent: vocab {vocab} outside [0, "
                         f"{head.shape[1]}]")


def splits(n: int, vp: int, sms: int,
           dtype: torch.dtype = torch.float32) -> Tuple[int, int]:
    """(splits, vocab tiles a split) for N rows and Vp columns on `sms`
    SMs, in the tiles of the route of `dtype`: each row tile's vocabulary
    is cut into `splits` blocks so that the blocks fill the card; picks the
    least waves × (tiles a block + 1) (when the last block ends, with a
    tile's worth of set-up a block), fewer splits on a tie."""
    bn, bv, per_sm = tiles(dtype)
    row_tiles, nvt = -(-n // bn), -(-vp // bv)
    slots = per_sm * sms
    best = None
    for want in range(1, nvt + 1):
        tps = -(-nvt // want)
        s = -(-nvt // tps)
        cost = -(-row_tiles * s // slots) * (tps + 1)
        if best is None or cost < best[0]:
            best = (cost, s, tps)
    return best[1], best[2]


@spanned("nero.kernel.xent")
def xent_cuda(hidden: torch.Tensor, head: torch.Tensor,
              targets: torch.Tensor, valid: Optional[torch.Tensor] = None, *,
              vocab: int = 0, softcap: float = 0.0
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the kernel of the dtype (bfloat16: tensor cores; float32:
    fp32 cores) on CUDA tensors: hidden (N, D) with contiguous rows, head
    (D, Vp) contiguous along either axis; targets (N,) integer; valid (N,)
    (None: every row). Returns the per-row NLL (times `valid`) and
    log-normaliser, float32 (N,)."""
    check_operands(hidden, head, targets, valid, vocab)
    for name, x in (("hidden", hidden), ("head", head), ("targets", targets),
                    ("valid", valid)):
        if x is None:
            continue
        if x.device.type != "cuda" or x.device != hidden.device:
            raise ValueError(f"xent: {name} must be a CUDA tensor on "
                             f"{hidden.device}, got {x.device}")
        if torch.is_grad_enabled() and x.requires_grad:
            raise ValueError("xent: the raw launcher is forward only; "
                             f"{name} requires grad (ops.xent "
                             f"differentiates through XentFn)")
    if hidden.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"xent: dtype {hidden.dtype}; expected float32 or "
                         f"bfloat16")
    if hidden.stride(1) != 1:
        raise ValueError(f"xent: hidden needs contiguous rows, got strides "
                         f"{hidden.stride()}")
    if 1 not in head.stride():
        raise ValueError(f"xent: head must be contiguous along D or V, got "
                         f"strides {head.stride()}")
    n, d = hidden.shape
    vp = head.shape[1]
    if n == 0 or d == 0 or vp == 0:
        raise ValueError(f"xent: empty operands {tuple(hidden.shape)}, "
                         f"{tuple(head.shape)}")
    dev = hidden.device
    tgt = targets.to(torch.int32).contiguous()
    valid = (torch.ones(n, dtype=torch.float32, device=dev) if valid is None
             else valid.to(torch.float32).contiguous())
    s, tps = splits(n, vp,
                    torch.cuda.get_device_properties(dev).multi_processor_count,
                    hidden.dtype)
    part = torch.empty((3, s, n), dtype=torch.float32, device=dev)
    nll = torch.empty(n, dtype=torch.float32, device=dev)
    lse = torch.empty(n, dtype=torch.float32, device=dev)
    # a dim of size 1 may carry any stride: name the contiguous one
    w_sd, w_sv = head.stride()
    if vp == 1:
        w_sv = 1
    elif d == 1:
        w_sd = 1
    lib = _build.load()
    launch = (lib.nero_xent_tc if hidden.dtype == torch.bfloat16
              else lib.nero_xent)
    with torch.cuda.device(dev):
        err = launch(
            hidden.data_ptr(), head.data_ptr(), tgt.data_ptr(),
            valid.data_ptr(), part[0].data_ptr(), part[1].data_ptr(),
            part[2].data_ptr(), nll.data_ptr(), lse.data_ptr(), n, d, vp,
            vocab or vp,
            hidden.stride(0), w_sd, w_sv, float(softcap), s, tps,
            _build.stream_of(hidden))
    _build.check(err, "xent")
    _build.LAUNCHES["xent"] += 1
    return nll, lse
