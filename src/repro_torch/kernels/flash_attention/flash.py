"""Flash attention: the CUDA kernels' launcher, two routes by dtype.

Replaces the TPU kernel
`repro.kernels.flash_attention.flash.flash_mha_pallas`. Both kernels
compute what it computes — per (batch, head, q block), an online softmax
over kv blocks with the finite -1e30 mask sentinel and fp32 running max,
sum and accumulator — and also take T and S that the blocks do not divide
(the last block is ragged; keys past S add nothing), where the TPU kernel
refuses them. The dtype picks the route, with no fallback:

- bfloat16: the tensor-core route, `csrc/flash_attn_tc.cu`. q·kᵀ and p·v
  run as bf16 `wgmma` with fp32 accumulation (a product of two bf16 values
  is exact in fp32); the scale is applied to the fp32 scores; p enters p·v
  as two bf16 terms, hi + lo. Tiles `TC_BLOCKS`: two warpgroups of 64
  query rows, kv blocks of 128 or 64 keys in a two-stage ring.
- float32: the fp32-core route, `csrc/flash_attn.cu`, q scaled in fp32
  before its product, as the TPU kernel scales it. Tiles `BLOCKS`.

Their plain version is `ref.mha`. The launcher is the forward kernel
alone: gradients go through `ops.FlashFn`, whose backward differentiates
the plain version, so the launcher refuses an operand that would need one.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.core.spans import spanned
from repro_torch.kernels import _build

HEAD_DIMS = (16, 32, 64, 128, 256)     # the kernels' instantiations
# (block_q, block_k) of each route, largest first
BLOCKS = ((64, 64), (32, 32))          # fp32 cores (`flash_attn.cu`)
TC_BLOCKS = ((128, 128), (128, 64))    # bf16 tensor cores (`flash_attn_tc.cu`)
SMEM_BUDGET = 232448       # bytes of shared memory a block may opt into


def blocks(dtype: torch.dtype = torch.float32) -> tuple:
    """The tiles the route of `dtype` is built for, largest first."""
    return TC_BLOCKS if dtype == torch.bfloat16 else BLOCKS


def smem_bytes(hd: int, block_q: int, block_k: int,
               dtype: torch.dtype = torch.float32) -> int:
    """Dynamic shared memory of one kernel block of the route of `dtype`.
    fp32 (`Smem` in `flash_attn.cu`): q and k tiles with padded rows, the v
    tile, the score tile with padded rows, and the running max, sum and
    correction of each row. bf16 (`Tiles` in `flash_attn_tc.cu`): the q
    tile and two stages of k and v tiles, bf16, and 1 KB to align them."""
    if dtype == torch.bfloat16:
        return 2 * (block_q * hd + 2 * 2 * block_k * hd) + 1024
    floats = (block_q * (hd + 1) + block_k * (hd + 1) + block_k * hd
              + block_q * (block_k + 1) + 3 * block_q)
    return 4 * floats


def auto_blocks(hd: int, budget: int = SMEM_BUDGET,
                dtype: torch.dtype = torch.float32) -> Tuple[int, int]:
    """The largest (block_q, block_k) of the route of `dtype` whose
    shared-memory working set (`smem_bytes`) fits `budget`. Any T and S
    tile (the last block may be ragged), so only `hd`, the route and the
    budget decide: fp32 (64, 64) at every head dim; bf16 (128, 128) up to
    hd 128 and (128, 64) at hd 256."""
    for bq, bk in blocks(dtype):
        if smem_bytes(hd, bq, bk, dtype) <= budget:
            return bq, bk
    raise ValueError(f"flash_attn: no block of {blocks(dtype)} fits "
                     f"{budget} bytes of shared memory at head_dim {hd} "
                     f"({dtype})")


def check_operands(q, k, v, window: int) -> None:
    """The shapes the kernel and its plain version take: q (B, T, H, hd), k and v
    (B, S, KH, hd), H % KH == 0, one float dtype."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(f"flash_attn: q, k, v must be 4-D, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, t, h, hd = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != hd:
        raise ValueError(f"flash_attn: k {tuple(k.shape)} and v "
                         f"{tuple(v.shape)} must be (B={b}, S, KH, hd={hd})")
    if k.shape[2] == 0 or h % k.shape[2]:
        raise ValueError(f"flash_attn: H={h} is not a multiple of "
                         f"KH={k.shape[2]}")
    if not (q.dtype == k.dtype == v.dtype):
        raise ValueError(f"flash_attn: dtypes differ: {q.dtype}, {k.dtype}, "
                         f"{v.dtype}")
    if window < 0:
        raise ValueError(f"flash_attn: window={window} < 0")


@spanned("nero.kernel.flash_attn")
def flash_mha_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                   causal: bool = True, window: int = 0,
                   softcap: float = 0.0, block_q: Optional[int] = None,
                   block_k: Optional[int] = None) -> torch.Tensor:
    """Launch the kernel of q's dtype (bfloat16: tensor cores; float32:
    fp32 cores) on CUDA tensors q (B, T, H, hd) and k, v (B, S, KH, hd),
    each with a contiguous last axis (any other strides); returns a new
    contiguous (B, T, H, hd) tensor in q's dtype. Blocks default to
    `auto_blocks`. Raises on what the kernel does not take."""
    check_operands(q, k, v, window)
    for name, x in (("q", q), ("k", k), ("v", v)):
        if not isinstance(x, torch.Tensor) or x.device.type != "cuda":
            raise ValueError(f"flash_attn: {name} must be a CUDA tensor, got "
                             f"{getattr(x, 'device', type(x))}")
        if x.device != q.device:
            raise ValueError("flash_attn: q, k, v lie on different devices")
        if x.stride(-1) != 1:
            raise ValueError(f"flash_attn: {name} needs a contiguous last "
                             f"axis, got strides {x.stride()}")
        if torch.is_grad_enabled() and x.requires_grad:
            raise ValueError("flash_attn: the raw launcher is forward only; "
                             f"{name} requires grad (ops.flash_mha "
                             f"differentiates through FlashFn)")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"flash_attn: dtype {q.dtype}; expected float32 or "
                         f"bfloat16")
    b, t, h, hd = q.shape
    s, kh = k.shape[1], k.shape[2]
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash_attn: head_dim {hd} not in {HEAD_DIMS}")
    if block_q is None or block_k is None:
        block_q, block_k = auto_blocks(hd, dtype=q.dtype)
    if (block_q, block_k) not in blocks(q.dtype):
        raise ValueError(f"flash_attn: blocks ({block_q}, {block_k}) not in "
                         f"{blocks(q.dtype)} ({q.dtype})")
    if smem_bytes(hd, block_q, block_k, q.dtype) > SMEM_BUDGET:
        raise ValueError(f"flash_attn: blocks ({block_q}, {block_k}) need "
                         f"more than {SMEM_BUDGET} bytes of shared memory "
                         f"at head_dim {hd}")
    out = torch.empty((b, t, h, hd), dtype=q.dtype, device=q.device)
    if out.numel() == 0 or s == 0:
        raise ValueError(f"flash_attn: empty operands {tuple(q.shape)}, "
                         f"{tuple(k.shape)}")
    lib = _build.load()
    launch = (lib.nero_flash_attn_tc if q.dtype == torch.bfloat16
              else lib.nero_flash_attn)
    with torch.cuda.device(q.device):
        err = launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, t,
            s, h, kh, hd, block_q, block_k, *q.stride()[:3],
            *k.stride()[:3], *v.stride()[:3],
            *out.stride()[:3], int(causal), int(window), float(softcap),
            float(hd ** -0.5), _build.stream_of(q))
    _build.check(err, "flash_attn")
    _build.LAUNCHES["flash_attn"] += 1
    return out


def attention_flops(b: int, t: int, s: int, h: int, hd: int, *,
                    causal: bool, window: int = 0) -> float:
    """The operations the mask's kept (query, key) pairs need: 2·hd for
    q·k and 2·hd for p·v each (masked pairs need none)."""
    qpos = torch.arange(t, dtype=torch.float64)[:, None]
    kpos = torch.arange(s, dtype=torch.float64)[None, :]
    keep = torch.ones((t, s), dtype=torch.bool)
    if causal:
        keep &= kpos <= qpos
    if window:
        keep &= (qpos - kpos) < window
    return 4.0 * hd * b * h * float(keep.sum())
