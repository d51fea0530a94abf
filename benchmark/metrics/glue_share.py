"""glue_share: the device time of library elementwise, reduction and copy
kernels over all device time in the profiled steps, in % (the classes of
harness/kernel_classes.py, copied from cli/profile_step.py)."""

from harness.kernel_classes import GLUE, by_class


def read(run):
    if run.trace is None:
        return None
    cls = by_class(run.trace["by_name"])
    total = sum(cls.values())
    return 100.0 * sum(cls.get(c, 0.0) for c in GLUE) / total
