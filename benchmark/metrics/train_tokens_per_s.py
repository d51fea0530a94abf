"""train_tokens_per_s: every token of the window's whole steps over the time
from the first step's start to the last step's end, synchronised (host
clock)."""


def read(run):
    w = run.window
    return w["tokens"] / w["seconds"]
