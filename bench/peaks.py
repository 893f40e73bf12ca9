"""Published peaks of one NVIDIA H100 SXM (data sheet, dense, 700 W) and
the roofline bound every share in the benchmark is taken against."""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
FLOPS_PER_S = {"float32": 67e12, "bfloat16": 989e12}


def bound_s(nbytes: float, flops: float, dtype: str = "float32") -> float:
    """The least time the chip could take: the larger of the bytes over
    the memory bandwidth and the operations over the dtype's peak rate."""
    return max(nbytes / HBM_BYTES_PER_S, flops / FLOPS_PER_S[dtype])


def itemsize(dtype: str) -> int:
    return {"float32": 4, "bfloat16": 2}[dtype]
