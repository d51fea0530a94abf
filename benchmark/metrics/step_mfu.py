"""step_mfu: the model FLOPs of the window's steps over (window time x the
peak of the cell's compute dtype), in %.

Per token: 6 x the matmul parameters (each block's qkv, proj, fc and fc-proj
weights and the tied head at the padded vocabulary) + 6 x n_layer x T x
n_embd, causal attention's two forward and four backward products halved by
the mask. Recompute and remat are not counted.
"""


def flops_per_token(n_layer: int, n_embd: int, vocab_pad: int, seq_len: int) -> int:
    matmul_params = n_layer * 12 * n_embd * n_embd + vocab_pad * n_embd
    return 6 * matmul_params + 6 * n_layer * seq_len * n_embd


def read(run):
    if not run.peaks:
        return None
    d = run.dims
    f = flops_per_token(d["n_layer"], d["n_embd"], d["vocab_pad"], run.traffic["seq_len"])
    w = run.window
    return 100.0 * f * w["tokens"] / (w["seconds"] * run.peaks["flops"][run.compute])
