"""setup_s: from the process's first line to the window's start: imports,
the kernel library (built or loaded from its cache), the seeded weights and
shards, the model and optimizer state, and the checked warm-up steps."""


def read(run):
    return run.setup_s
