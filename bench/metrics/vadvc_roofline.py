"""The vadvc kernel's share of its roofline (%): the bound of one launch
over its mean device time. A launch reads the field-stacked fields,
tendencies and stage tendencies and the periodic wcon once and writes the
stage tendencies once; 28 operations a field point (`ops/vadvc.py`)."""

from bench import peaks
from bench.ops.vadvc import FLOPS_PER_POINT

KERNEL = "vadvc"


def read(run):
    if run.trace is None:
        return None
    times = run.trace.launches(KERNEL)
    if not times:
        return None
    wl = run.workload
    nz, ny, nx = wl.grid
    nf, plane = wl.n_fields, wl.members * nz * ny * nx
    nbytes = (3 * nf + 1 + nf) * plane * wl.itemsize
    bound = peaks.bound_s(nbytes, FLOPS_PER_POINT * nf * plane, wl.dtype_name)
    return 100.0 * bound / (sum(times) / len(times))
