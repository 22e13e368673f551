"""torch.cuda.max_memory_allocated() over the whole run, in GiB."""


def read(run):
    return run["peak_bytes"] / 2**30
