"""attn_fwd_roofline: the least time the chip could take for the step's
attention forwards over the device time of the attention-forward kernels, in
%.

Per forward of one layer and micro-batch: two products over the causal half,
2 x B x H x T^2 x hs operations, and q, k, v read and o written once (the
compute dtype) with the fp32 log-sum-exp; the bound is the larger of the
operations at the cell's compute peak (989 TFLOP/s bf16, 67 fp32) and the
bytes at the HBM rate. The kernels are the flash forwards of every family and
their merges.
"""

FORWARD = ("flash_fwd", "flash_general_fwd", "flash_lse_fwd", "flash_lse_merge",
           "flash_dt_fwd", "flash_dt_merge")
ITEMSIZE = {"bf16": 2, "fp16": 2, "fp32": 4}


def forward_work(b: int, h: int, t: int, hs: int, itemsize: int) -> tuple:
    """(operations, bytes) of one causal attention forward."""
    return 2 * b * h * t * t * hs, 4 * b * t * h * hs * itemsize + 4 * b * h * t


def read(run):
    if run.trace is None or not run.peaks:
        return None
    spent = sum(us for name, us in run.trace["by_name"].items()
                if any(f in name for f in FORWARD)) * 1e-6 / run.trace["steps"]
    if spent <= 0:
        return None
    d, tr = run.dims, run.traffic
    ops, nbytes = forward_work(tr["micro_batch_size"], d["n_head"], tr["seq_len"],
                               d["n_embd"] // d["n_head"], ITEMSIZE[run.compute])
    calls = d["n_layer"] * tr["grad_accum_steps"]
    bound = calls * max(ops / run.peaks["flops"][run.compute],
                        nbytes / run.peaks["bytes_per_s"])
    return 100.0 * bound / spent
