"""gemm_roofline: the least time the chip could take for the step's matrix
products over the device time they took, in %.

From one step profiled apart with record_shapes: for each product op of the
aten::mm family, 2 x M x N x K (x the batch) operations and the bytes of its
operands and result read and written once; its bound is the larger of the
operations at the cell's compute peak and the bytes at the HBM rate. The sum
of the bounds over the sum of the ops' own device time.
"""

ITEMSIZE = {"bf16": 2, "fp16": 2, "fp32": 4}


def mm_work(shapes) -> tuple:
    """(operations, elements moved) of one product from its input shapes:
    the last two matrices are the operands (a bias comes first)."""
    a, b = shapes[-2], shapes[-1]
    batch = a[0] if len(a) == 3 else 1
    m, k = a[-2], a[-1]
    n = b[-1]
    if b[-2] != k:
        raise ValueError(f"product shapes {a} x {b} do not chain")
    return 2 * batch * m * n * k, batch * (m * k + k * n + m * n)


def read(run):
    if run.trace is None or not run.peaks or not run.trace["mm_ops"]:
        return None
    peak = run.peaks["flops"][run.compute]
    size = ITEMSIZE[run.compute]
    bound = spent = 0.0
    for op in run.trace["mm_ops"]:
        if len(op["shapes"]) < 2 or op["device_us"] <= 0:
            continue
        ops, elems = mm_work(op["shapes"])
        bound += op["count"] * max(ops / peak, elems * size / run.peaks["bytes_per_s"])
        spent += op["device_us"] * 1e-6
    return 100.0 * bound / spent if spent else None
