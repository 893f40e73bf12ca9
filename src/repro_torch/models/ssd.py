"""Mamba2 SSD (state-space duality) mixer: the chunked scan formulation.

A port of `repro.models.ssd`. Within a chunk the work is dense products
over a (cl, cl) decay kernel; across chunks the state flows through a
first-order recurrence, a loop over chunks here (the JAX package's
`lax.scan`). Grouped B/C (`n_groups`) and the depthwise causal conv front
(`rglru.causal_conv1d`). The scan runs in float32 where the JAX package
casts to it: x, B, C, dt and the state. `_ssd_chunked` runs under the
profiler label `ssd_scan`.

The four-operand einsums of the JAX package are computed as two-operand
products here (C·Bᵀ first, then the decay and x), which sums in another
order: equal to float32 rounding.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.core.spans import span
from repro_torch.models.common import dense_init, normal
from repro_torch.models.rglru import causal_conv1d, softplus
from repro_torch.parallel import policy


def _dims(cfg: ModelConfig):
    s = cfg.ssd
    di = s.expand * cfg.d_model
    nh = di // s.head_dim
    return di, nh, s.head_dim, s.d_state, s.n_groups


def ssd_init(gen: torch.Generator, cfg: ModelConfig, dtype):
    di, nh, p, n, g = _dims(cfg)
    d = cfg.d_model
    cw = cfg.ssd.conv_width
    dev = gen.device
    d_in_proj = 2 * di + 2 * g * n + nh
    conv_dim = di + 2 * g * n
    return {
        "in_proj": dense_init(gen, d, d_in_proj, dtype),
        "conv": normal(gen, (cw, conv_dim), 1.0 / cw, dtype),
        "A_log": torch.log(torch.linspace(1.0, 16.0, nh, dtype=torch.float32,
                                          device=dev)),
        "D": torch.ones(nh, dtype=torch.float32, device=dev),
        "dt_bias": torch.zeros(nh, dtype=torch.float32, device=dev),
        "norm_scale": torch.ones(di, dtype=torch.float32, device=dev),
        "out_proj": dense_init(gen, di, d, dtype),
    }


def _segsum(x: torch.Tensor) -> torch.Tensor:
    """Stable segment-sum: out[..., i, j] = sum_{j < k <= i} x[..., k],
    -inf above the diagonal. x: (..., cl)."""
    cl = x.shape[-1]
    cs = torch.cumsum(x, dim=-1)
    seg = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((cl, cl), dtype=torch.bool,
                                 device=x.device))
    return torch.where(mask, seg, -torch.inf)


def _ssd_chunked(x, dt, A, B, C, chunk: int, h0=None):
    """SSD scan. x: (b, t, h, p); dt: (b, t, h); A: (h,); B, C: (b, t, g,
    n), all float32. Returns (y, h_last)."""
    b, t, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    if t % chunk:
        raise ValueError(f"ssd: T={t} is not a multiple of chunk={chunk}")
    nc = t // chunk
    rep = h // g

    def tochunk(a):
        return a.reshape((b, nc, chunk) + tuple(a.shape[2:]))

    xc, dtc, Bc, Cc = map(tochunk, (x, dt, B, C))
    Bh = Bc.repeat_interleave(rep, dim=3)          # (b,nc,cl,h,n)
    Ch = Cc.repeat_interleave(rep, dim=3)

    dA = dtc * A                                   # (b,nc,cl,h)
    dA_cs = torch.cumsum(dA, dim=2)                # within-chunk cumsum

    # ---- intra-chunk (dense) ----------------------------------------------
    L = torch.exp(_segsum(dA.permute(0, 1, 3, 2)))          # (b,nc,h,cl,cl)
    xdt = xc * dtc[..., None]                               # (b,nc,cl,h,p)
    scores = torch.einsum("bclhn,bcshn->bchls", Ch, Bh) * L
    y_diag = torch.einsum("bchls,bcshp->bclhp", scores, xdt)

    # ---- chunk states -----------------------------------------------------
    decay_states = torch.exp(dA_cs[:, :, -1:, :] - dA_cs)   # (b,nc,cl,h)
    states = torch.einsum("bcshn,bcshp->bchpn", Bh,
                          xc * (decay_states * dtc)[..., None])

    # ---- inter-chunk recurrence -------------------------------------------
    chunk_decay = torch.exp(dA_cs[:, :, -1, :])              # (b,nc,h)
    carry = (torch.zeros((b, h, p, n), dtype=torch.float32, device=x.device)
             if h0 is None else h0.float())
    prev = []
    for c in range(nc):
        prev.append(carry)
        carry = carry * chunk_decay[:, c, :, None, None] + states[:, c]
    prev_states = torch.stack(prev, dim=1)                  # (b,nc,h,p,n)

    # ---- inter-chunk output -------------------------------------------------
    state_decay = torch.exp(dA_cs)                          # (b,nc,cl,h)
    y_off = torch.einsum("bclhn,bchpn->bclhp", Ch,
                         prev_states) * state_decay[..., None]

    y = (y_diag + y_off).reshape(b, t, h, p)
    return y, carry


def ssd_apply(cfg: ModelConfig, params, x: torch.Tensor,
              state: Optional[dict] = None):
    """Full Mamba2 mixer. x: (B, T, D) -> (out, new_state).

    state (decode): {"h": (B, nh, p, n) fp32, "conv": (B, cw-1, conv_dim)}.
    The mixer is never tensor-parallel: under sequence parallelism it runs
    on the whole T on every model rank and leaves on the rank's slice.
    """
    di, nh, p, n, g = _dims(cfg)
    x = policy.enter_layer(x, False)
    b, t, d = x.shape

    zxbcdt = x @ params["in_proj"]
    z, xbc, dt = torch.split(zxbcdt, [di, di + 2 * g * n, nh], dim=-1)
    conv_state = state["conv"] if state is not None else None
    xbc, new_conv = causal_conv1d(xbc, params["conv"], conv_state)
    xbc = F.silu(xbc)
    xi, B, C = torch.split(xbc, [di, g * n, g * n], dim=-1)
    xi = xi.reshape(b, t, nh, p).float()
    B = B.reshape(b, t, g, n).float()
    C = C.reshape(b, t, g, n).float()
    dt = softplus(dt.float() + params["dt_bias"])
    A = -torch.exp(params["A_log"])

    h0 = state["h"] if state is not None else None
    chunk = min(cfg.ssd.chunk, t)
    pad = (-t) % chunk
    with span("ssd_scan"):
        if pad:
            # Left-pad with zeros: contributes nothing to states/outputs
            # when h0 == 0 (x=0 adds nothing; decay of a zero state is
            # zero).
            if h0 is not None:
                raise ValueError("ssd: chunk padding needs a fresh state")
            zpad = lambda a: F.pad(a, (0, 0) * (a.dim() - 2) + (pad, 0))
            y, h_last = _ssd_chunked(zpad(xi), zpad(dt), A, zpad(B),
                                     zpad(C), chunk, None)
            y = y[:, pad:]
        else:
            y, h_last = _ssd_chunked(xi, dt, A, B, C, chunk, h0)
    y = y + xi * params["D"][:, None]
    y = y.reshape(b, t, di)

    # gated RMSNorm (mamba2)
    yz = y * F.silu(z.float())
    yz = yz * torch.rsqrt(torch.mean(yz * yz, dim=-1, keepdim=True) + 1e-6)
    yz = (yz * params["norm_scale"]).to(x.dtype)
    out = yz @ params["out_proj"]
    return policy.leave_layer(out, False), {"h": h_last, "conv": new_conv}


def ssd_decode_step(cfg: ModelConfig, params, x: torch.Tensor, state: dict):
    """Single-token recurrent step (O(1) in sequence length)."""
    return ssd_apply(cfg, params, x, state)


def ssd_init_state(cfg: ModelConfig, batch: int, dtype, device):
    di, nh, p, n, g = _dims(cfg)
    cw = cfg.ssd.conv_width
    conv_dim = di + 2 * g * n
    return {"h": torch.zeros((batch, nh, p, n), dtype=torch.float32,
                             device=device),
            "conv": torch.zeros((batch, cw - 1, conv_dim), dtype=dtype,
                                device=device)}
