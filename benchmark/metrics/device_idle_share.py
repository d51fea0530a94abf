"""device_idle_share: 1 - (union of the device's kernel, copy and set
intervals) / (wall span of the profiled steps), in %; profiled without
record_shapes."""


def read(run):
    if run.trace is None:
        return None
    return 100.0 * (1.0 - run.trace["busy_us"] / run.trace["window_us"])
