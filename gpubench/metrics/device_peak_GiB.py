"""torch.cuda.max_memory_allocated() over the run, the fullest device's,
in GiB."""


def read(run):
    if run.peak_bytes <= 0:
        return None
    return run.peak_bytes / 2 ** 30
