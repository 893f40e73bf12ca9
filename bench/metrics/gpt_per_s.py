"""Grid-point updates a second: members x nz x ny x nx x the steps of the
forecasts finished in the window, over the window's seconds (host clock)."""


def read(run):
    return (run.workload.points * run.window["steps"]
            / run.window["window_s"] / 1e9)
