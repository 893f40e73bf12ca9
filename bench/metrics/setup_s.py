"""Set-up seconds: imports, the CUDA context, the kernel library (built on
a checkout's first run), the inputs drawn, the plan compiled, the warm-up."""


def read(run):
    return run.setup_s
