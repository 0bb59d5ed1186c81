"""torch.cuda.max_memory_allocated() over the run, from a reset before the
first step, in GiB."""


def read(run):
    if run.mode != "train" or run.peak_bytes is None:
        return None
    return run.peak_bytes / 2**30
