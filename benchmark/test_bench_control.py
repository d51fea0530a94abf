"""The control on the card: the plain reference computed one precision below
what the cell states (fp8 products for a bf16 cell, TF32 for an fp32 one),
put in the program's place, reads ``correct`` false against the cell's
limits, on three seeds. At a size a test run holds: the cell's model whole,
its micro-batches and policy, B cut to 2 rows of at most 4,096 tokens.

    python -m pytest benchmark -m card
"""

import pytest

import calibrate
from harness import compare, manifest
from run import prepare

CELLS = [w["name"] for w in manifest.load_manifest()["workloads"]]


@pytest.mark.card
@pytest.mark.parametrize("workload", CELLS)
def test_control_fails(cuda_device, workload):
    prep = prepare(workload, False)
    t = min(prep.traffic["seq_len"], 4096)
    prep.traffic = dict(prep.traffic, micro_batch_size=min(2, prep.traffic["micro_batch_size"]),
                        seq_len=t, reference_block_tokens=min(t * 2, 8192))
    for seed in (2147483648 + 101, 2147483648 + 102, 2147483648 + 103):
        numbers = calibrate.control(prep, seed, cuda_device)
        correct, checks = compare.judge(numbers, prep.limits)
        assert not correct, (seed, checks)
