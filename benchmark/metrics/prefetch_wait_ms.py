"""prefetch_wait_ms: the mean time a window step waited in
HostPrefetcher.next(), timed by the benchmark around the call (host clock)."""


def read(run):
    waits = run.window["prefetch_wait_s"]
    return 1e3 * sum(waits) / len(waits)
