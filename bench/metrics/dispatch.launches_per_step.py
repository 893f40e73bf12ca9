"""The program's kernel launches a step over the window
(`repro_torch.kernels._build.LAUNCHES`)."""


def read(run):
    steps = run.window["steps"]
    return run.window["launches"] / steps if steps else None
