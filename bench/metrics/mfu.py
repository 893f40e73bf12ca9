"""The whole step's share of the chip's peak (%): the steps finished in the
window times the step's least time at the peaks (the op's own bytes and
operations, whatever implements them; `ops/<op>.py`, `peaks.py`), over
the window's seconds. For these stencils the bytes bound it."""


def read(run):
    w = run.window
    if not w["steps"]:
        return None
    return 100.0 * w["steps"] * run.workload.step_bound_s() / w["window_s"]
