"""Host milliseconds to enqueue one step (`ExecutionPlan.run` timed until
it returns, on an idle device; the benchmark's own span, outside the
profiled stretch)."""


def read(run):
    return None if run.dispatch_s is None else run.dispatch_s * 1e3
