"""attn_bwd_roofline: the least time the chip could take for the step's
attention backwards over the device time of the attention-backward kernels,
in %.

Per backward of one layer and micro-batch: the four products the inputs need
over the causal half, 4 x B x H x T^2 x hs operations, whatever implements
them (a kernel that recomputes S runs a fifth, which is not counted: this
reads 4/5 of a share that counts it), and q, k, v, o, dO read and dq, dk, dv
written once (the compute dtype) with the fp32 log-sum-exp; the bound is the
larger of the operations at the cell's compute peak and the bytes at the HBM
rate. The kernels are the flash backwards of every family, with the D
pre-kernel and the dq cast.
"""

BACKWARD = ("flash_bwd", "flash_general_dq", "flash_general_dkv", "flash_general_bwd",
            "flash_fused_bwd", "flash_fused_dq_cast", "rowdot", "flash_dt_bwd")
ITEMSIZE = {"bf16": 2, "fp16": 2, "fp32": 4}


def backward_work(b: int, h: int, t: int, hs: int, itemsize: int) -> tuple:
    """(operations, bytes) of one causal attention backward."""
    return 4 * b * h * t * t * hs, 8 * b * t * h * hs * itemsize + 4 * b * h * t


def read(run):
    if run.trace is None or not run.peaks:
        return None
    spent = sum(us for name, us in run.trace["by_name"].items()
                if any(f in name for f in BACKWARD)) * 1e-6 / run.trace["steps"]
    if spent <= 0:
        return None
    d, tr = run.dims, run.traffic
    ops, nbytes = backward_work(tr["micro_batch_size"], d["n_head"], tr["seq_len"],
                                d["n_embd"] // d["n_head"], ITEMSIZE[run.compute])
    calls = d["n_layer"] * tr["grad_accum_steps"]
    bound = calls * max(ops / run.peaks["flops"][run.compute],
                        nbytes / run.peaks["bytes_per_s"])
    return 100.0 * bound / spent
