"""peak_hbm_gib: torch.cuda.max_memory_allocated over the window, reset at
its start, in GiB."""


def read(run):
    return run.memory_peak_bytes / 2 ** 30 if run.memory_peak_bytes else None
