"""The CUDA LRU-sweep kernel (`csrc/lru_scan.cu`) and its launcher.

Replaces the TPU kernel `repro.kernels.lru_scan.lru_scan.lru_scan_pallas`.
The plain version beside it is `ref.lru_scan_ref`. The launcher is one
call of the kernel, forward or reverse in time; gradients go through
`ops.LruScanFn`, whose backward is the reverse sweep, so the launcher
refuses an operand that would need one.
"""

from __future__ import annotations

import torch

from repro_torch.core.spans import spanned
from repro_torch.kernels import _build


def check_operands(a: torch.Tensor, b: torch.Tensor) -> None:
    """a and b of one shape, (T, C) or (B, T, C), and one dtype."""
    if a.shape != b.shape or a.dim() not in (2, 3):
        raise ValueError(f"lru_scan: a {tuple(a.shape)} and b "
                         f"{tuple(b.shape)} must both be (T, C) or (B, T, C)")
    if a.dtype != b.dtype:
        raise ValueError(f"lru_scan: dtypes differ: {a.dtype}, {b.dtype}")


@spanned("nero.kernel.lru_scan")
def lru_scan_cuda(a: torch.Tensor, b: torch.Tensor, *,
                  reverse: bool = False) -> torch.Tensor:
    """h_t = a_t h_{t-1} + b_t along axis -2 of contiguous CUDA tensors
    (T, C) or (B, T, C), float32 or bfloat16, with an fp32 carry; with
    `reverse`, h_t = a_t h_{t+1} + b_t from the last step down. One launch:
    the kernel streams a and b through a shared-memory ring, filled by bulk
    copies when every row is 16-byte aligned (C times the item size a
    multiple of 16, both base addresses on 16 bytes) and by each lane's
    plain loads otherwise; both give the same bits. Returns a new tensor in
    a's dtype."""
    check_operands(a, b)
    for name, x in (("a", a), ("b", b)):
        _build.check_operand("lru_scan", name, x, a.shape, a.dtype)
        if torch.is_grad_enabled() and x.requires_grad:
            raise ValueError("lru_scan: the raw launcher is forward only; "
                             f"{name} requires grad (ops.lru_scan "
                             f"differentiates through LruScanFn)")
    if b.device != a.device:
        raise ValueError("lru_scan: a and b lie on different devices")
    batch = a.shape[0] if a.dim() == 3 else 1
    steps, channels = a.shape[-2], a.shape[-1]
    h = torch.empty_like(a)
    if h.numel() == 0:
        return h
    lib = _build.load()
    with torch.cuda.device(a.device):
        err = lib.nero_lru_scan(a.data_ptr(), b.data_ptr(), h.data_ptr(),
                                int(a.dtype == torch.bfloat16), batch, steps,
                                channels, int(reverse), _build.stream_of(a))
    _build.check(err, "lru_scan")
    _build.LAUNCHES["lru_scan"] += 1
    return h
