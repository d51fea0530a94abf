"""The port's dry run of the parallel styles (tools/dryrun_multichip.py, the
counterpart of __graft_entry__.py dryrun_multichip) on 4 gloo processes on
the CPU: its one line in the JAX wording, every pin inside it (the ring's
and the pipelined step's loss within 5e-3 of the plain loss at the updated
weights, the pipelined blocks within 1e-4 of run_blocks under fp32); and
the command refuses to run without a card unless asked for the CPU."""

import re

import torch

from gpt2_vision_language_tpu_torch.tools import dryrun_multichip as dr
from torch_dist import TIMEOUT_S
from torch_threads import share_cores  # noqa: F401  (autouse)

LINE = re.compile(r"dryrun_multichip\(4\): ok — loss (\S+), grad_norm (\S+), mesh "
                  r"Mesh\(data=2, model=2; rank 0\), ring step loss (\S+), pp\(2 stages\) "
                  r"err (\S+) step loss (\S+)$")


def test_dryrun_four_processes_on_the_cpu():
    line = dr.dryrun_multichip(4, "cpu", timeout=TIMEOUT_S)
    m = LINE.match(line)
    assert m, line
    loss, grad_norm, ring_loss, err, pp_loss = (float(g) for g in m.groups())
    assert 5.0 < loss < 7.0 and grad_norm > 0
    assert abs(ring_loss - pp_loss) < 1e-2
    assert err < 1e-4


def test_dryrun_asks_for_the_card(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert dr.main(["4"]) == 2
    assert "--device cpu" in capsys.readouterr().err
