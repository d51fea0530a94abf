"""A cell cut to a size the CPU runs in seconds, for the benchmark's tests:
the cell's own files with 2 layers of width 256 and 4 heads, B=4, T=128, two
micro-batches, a shard of 16,384 tokens."""

from run import prepare


def tiny(workload: str, trace: bool = False):
    prep = prepare(workload, trace)
    prep.config = dict(prep.config, n_layer=2, n_head=4, n_embd=256)
    prep.traffic = dict(prep.traffic, micro_batch_size=4, seq_len=128, grad_accum_steps=2,
                        trace_steps=1, tokens=dict(prep.traffic["tokens"], shard_tokens=1 << 14))
    return prep
