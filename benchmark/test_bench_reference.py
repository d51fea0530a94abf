"""The plain reference agrees with the port's plain path at a tiny size on
the CPU: the loss, every gradient and the update of one AdamW step.

The port runs here through its plain paths (no kernel on the CPU) under the
fp32 policy, so the two sides differ by fp32 rounding only (the reference
sums its attention and loss in other orders): 1e-5 relative. Under the bf16
policy the port rounds its products' operands and its residual stream to
bf16 (2^-8 relative): 2e-2 relative L2 a gradient.
"""

import numpy as np
import pytest
import torch

from gpt2_vision_language_tpu_torch.core import config as port_config
from gpt2_vision_language_tpu_torch.core import precision as port_precision
from gpt2_vision_language_tpu_torch.models import gpt2 as port_gpt2
from gpt2_vision_language_tpu_torch.train import optimizer as port_optimizer
from gpt2_vision_language_tpu_torch.train import step as port_step
from harness import traffic as gen
from harness import weights as seeded
from reference import gpt2 as reference
from tiny import tiny


def _port_model(prep, init):
    d = seeded.dims(prep.config, prep.traffic["seq_len"])
    cfg = port_config.GPTConfig(block_size=d["block"], vocab_size=d["vocab"],
                                n_layer=d["n_layer"], n_head=d["n_head"], n_embd=d["n_embd"])
    model = port_gpt2.GPT2(cfg)
    with torch.no_grad():
        for n, p in port_gpt2.named_params(model).items():
            p.copy_(init[n])
    return model, cfg, d


def _rows(prep, tmp_path, seed, steps=1):
    tr = prep.traffic
    paths = gen.write_shards(str(tmp_path), tr["tokens"], seed)
    return gen.step_rows(paths, tr["micro_batch_size"], tr["seq_len"], tr["grad_accum_steps"],
                         steps)


def _rel(a, b):
    return float((a.double() - b.double()).norm() / b.double().norm().clamp(min=1e-30))


@pytest.mark.parametrize("policy,tol", [("FP32_POLICY", 1e-5), ("DEFAULT_POLICY", 2e-2)])
def test_loss_and_grads(tmp_path, policy, tol):
    prep = tiny("gpt2-124m.pretrain-t1024")
    _, init = seeded.make(prep.config, prep.traffic["seq_len"], 5, "cpu")
    rows = torch.from_numpy(_rows(prep, tmp_path, 5)[0, 0])
    model, cfg, d = _port_model(prep, init)
    x, y = rows[:, :-1], rows[:, 1:]
    loss = port_gpt2.loss(model, x, cfg, targets=y, policy=getattr(port_precision, policy))
    loss.backward()
    params = {n: w.clone().requires_grad_(True) for n, w in init.items()}
    r = reference.Rounding("fp32", "cpu")
    ref = reference.nll_sum(params, x, y, d, r) / x.numel()
    ref.backward()
    assert abs(loss.item() - ref.item()) <= tol * ref.item()
    for n, p in port_gpt2.named_params(model).items():
        assert _rel(p.grad, params[n].grad) <= tol, n


def test_update(tmp_path):
    """One step of the port's train step (fp32, two micro-batches, clip and
    AdamW's plain path) against the reference's."""
    prep = tiny("gpt2-124m.pretrain-t1024")
    tr = prep.traffic
    _, init = seeded.make(prep.config, tr["seq_len"], 9, "cpu")
    rows = _rows(prep, tmp_path, 9)
    model, cfg, d = _port_model(prep, init)
    policy = port_precision.FP32_POLICY
    step = port_step.make_train_step(
        lambda m, mb: port_gpt2.loss(m, mb["x"], cfg, targets=mb["y"], policy=policy),
        port_config.OptimizerConfig(**tr["optimizer"]),
        port_config.ScheduleConfig(**tr["schedule"]), decay_mask=port_gpt2.decay_mask(model))
    state = port_optimizer.adamw_init(port_gpt2.named_params(model))
    batch = torch.from_numpy(rows[0])
    metrics = step(model, state, {"x": batch[..., :-1], "y": batch[..., 1:]}, 0)
    ref = reference.train_steps(init, rows, d, tr["optimizer"], tr["schedule"],
                                keep_params=True)
    assert abs(metrics["loss"] - ref["loss"][0]) <= 1e-5 * ref["loss"][0]
    for n, p in port_gpt2.named_params(model).items():
        got, want = p.detach() - init[n], ref["params"][n] - init[n]
        kept = ref["kept"][n]
        assert _rel(got[kept], want[kept]) <= 1e-4, n
        assert float((got - want).abs().max()) <= 1e-3 * tr["schedule"]["max_lr"], n
