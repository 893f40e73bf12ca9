"""The CUDA copy-stencil kernel (`csrc/copy.cu`) and its launcher.

Replaces the TPU kernel `repro.kernels.copy_stencil.copy_stencil.copy_pallas`.
The plain version beside it is `ref.copy_stencil`.
"""

from __future__ import annotations

import torch

from repro_torch.core.spans import spanned
from repro_torch.kernels import _build


def check_rows(src: torch.Tensor, tr: int) -> None:
    """`copy_pallas`'s contract: a 2-D `(rows, cols)` input with
    `rows % tr == 0` (the TPU kernel streams `(tr, cols)` row blocks)."""
    if src.dim() != 2:
        raise ValueError(f"copy: src must be (rows, cols), got "
                         f"{tuple(src.shape)}")
    rows = src.shape[0]
    if rows % tr:
        raise ValueError(f"rows={rows} % tr={tr} != 0")


@spanned("nero.kernel.copy")
def copy_cuda(src: torch.Tensor, tr: int = 256) -> torch.Tensor:
    """A new tensor equal to the contiguous 2-D CUDA tensor `src`, bit for
    bit, in its dtype. `tr` is the TPU kernel's row block: the CUDA kernel
    streams the whole buffer, so `tr` only keeps the contract. The host path
    is kept short, since the copy of the paper's domain takes about as long
    as it: the device context is entered only when `src` is not on the
    current device, and the stream is read without building a Stream."""
    check_rows(src, tr)
    if not src.is_cuda:
        raise ValueError(f"copy: src must be a CUDA tensor, got {src.device}")
    if not src.is_contiguous():
        raise ValueError("copy: src must be contiguous")
    launch = _build.load().nero_copy
    out = torch.empty_like(src)
    dev = src.get_device()
    if dev == torch.cuda.current_device():
        err = launch(src.data_ptr(), out.data_ptr(), src.nbytes,
                     _build.stream_of(src))
    else:
        with torch.cuda.device(dev):
            err = launch(src.data_ptr(), out.data_ptr(), src.nbytes,
                         _build.stream_of(src))
    _build.check(err, "copy")
    _build.LAUNCHES["copy"] += 1
    return out
