"""The device's peak allocated memory over set-up and window, in GiB
(`torch.cuda.max_memory_allocated`, read before the check runs)."""


def read(run):
    return run.peak_bytes / 2**30 if run.peak_bytes else None
