"""A run with the timed path broken underneath reads ``correct`` false.

Each fault of ``benchmark/faults.py`` is planted in the program and a whole
run of the cell (set-up, checked steps, a window, the reference, the
comparison against the cell's limits) is driven on the CPU at a tiny size,
past the run's look for a card. A sound run of the same size reads true."""

import pytest
import torch

import faults
import run
from tiny import tiny


def _line(workload, seed):
    return run.execute(tiny(workload), seed, 0.0, False, "cpu")


@pytest.mark.parametrize("fault", faults.FAULTS)
@pytest.mark.parametrize("workload", ["gpt2-124m.pretrain-t1024", "gpt2-124m.longctx-t16384"])
def test_fault_fails(fault, workload):
    with faults.plant(fault):
        line = _line(workload, 2147483648 + 17)
    assert line["correct"] is False, line["checks"]


def test_sound_run_passes():
    line = _line("gpt2-124m.pretrain-t1024", 2147483648 + 17)
    assert line["correct"] is True, line["checks"]
    assert line["device"]["platform"] == "cpu"
    assert set(line["checks"]) == {"loss_gap", "grad_norm_gap", "update_norm_gap"}
    assert list(line)[-1] == "checks"


def test_faults_restore_the_program():
    from gpt2_vision_language_tpu_torch.train import pretrain, step

    before = (step.adamw_update, pretrain.split_rows_on_device)
    for f in faults.FAULTS:
        with faults.plant(f):
            pass
    assert (step.adamw_update, pretrain.split_rows_on_device) == before
    with pytest.raises(ValueError):
        faults.plant("no_such_fault")
    assert torch is not None
