"""The hdiff kernel's share of its roofline (%): the bound of one launch
over its mean device time. A launch reads the wrap-padded plane stack
(members x fields x nz planes of (ny + 4) x (nx + 4)) once and writes it
once; 46 operations an interior point (`ops/hdiff.py`)."""

from bench import peaks
from bench.ops.hdiff import FLOPS_PER_POINT

KERNEL = "hdiff"
HALO = 2


def read(run):
    if run.trace is None:
        return None
    times = run.trace.launches(KERNEL)
    if not times:
        return None
    wl = run.workload
    nz, ny, nx = wl.grid
    planes = wl.members * wl.n_fields * nz
    nbytes = 2 * planes * (ny + 2 * HALO) * (nx + 2 * HALO) * wl.itemsize
    bound = peaks.bound_s(nbytes, FLOPS_PER_POINT * planes * ny * nx,
                          wl.dtype_name)
    return 100.0 * bound / (sum(times) / len(times))
