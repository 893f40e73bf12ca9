"""Device milliseconds a step in operations that are not the program's own
kernels (`kernels/*.json`): the op lowering's pads, crops, stacks, rolls
and sums, from the profiler's trace. The traced forecasts keep no answers,
so the benchmark's own copies are not among them."""


def read(run):
    tr = run.trace
    if tr is None or not tr.steps:
        return None
    return tr.device_s(names=(None,)) / tr.steps * 1e3
