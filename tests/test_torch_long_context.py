"""The long-context slice of the PyTorch port at a small size: a 2-layer
model whose self-attention takes the general (streamed-K/V) flash family,
loss and gradients against the JAX package; and cli.pretrain with a
--seq-len over 1024, which grows block_size, checkpoints the longer wpe and
resumes."""

import glob
import os
import tempfile
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpt2_vision_language_tpu.ckpt.torch_export import gpt2_to_torch_state_dict
from gpt2_vision_language_tpu.core import precision as jp
from gpt2_vision_language_tpu.core.config import GPTConfig as JaxGPTConfig
from gpt2_vision_language_tpu.models import gpt2 as jgpt2
from gpt2_vision_language_tpu.ops import flash_attention as jfa
from gpt2_vision_language_tpu_torch.ckpt.checkpoint import load_checkpoint
from gpt2_vision_language_tpu_torch.ckpt.convert import gpt2_from_jax_params
from gpt2_vision_language_tpu_torch.cli import pretrain
from gpt2_vision_language_tpu_torch.core.config import GPTConfig
from gpt2_vision_language_tpu_torch.core.precision import FP32_POLICY
from gpt2_vision_language_tpu_torch.models import gpt2
from gpt2_vision_language_tpu_torch.ops import flash_attention as fa
from torch_threads import share_cores  # noqa: F401  (autouse)

T = 384
KW = dict(block_size=T, vocab_size=500, n_layer=2, n_head=2, n_embd=128)  # hs 64
CFG, JCFG = GPTConfig(**KW), JaxGPTConfig(**KW)


@pytest.fixture(scope="module")
def jax_params():
    return jgpt2.init(jax.random.PRNGKey(0), JCFG)


def test_convert_carries_a_longer_wpe(jax_params):
    """ckpt/convert with block_size != 1024: every key and value of the JAX
    exporter's state dict, wpe of block_size rows."""
    got = gpt2_from_jax_params(jax.tree.map(np.asarray, jax_params), CFG)
    want = gpt2_to_torch_state_dict(jax_params, JCFG)
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)
    assert got["transformer.wpe.weight"].shape == (T, 128)


@pytest.mark.parametrize("jax_impl", ["xla", "flash"])
def test_slice_loss_and_grads_match_jax(jax_params, monkeypatch, jax_impl):
    """B=2, T=384, fp32 policy. JAX: gpt2.loss and jax.grad on its xla
    attention path, and on its flash path with the Pallas kernels in
    interpret mode. Port: loss and autograd with attn_impl='flash' and the
    self-attention family's bound lowered to 256, so every layer's attention
    goes through the general family (forward, D, backward with D passed in).
    Loss within 1e-5, every gradient within 2e-5 of max|ref| (fp32 both
    ways; only the order of sums differs)."""
    toks = np.random.RandomState(0).randint(0, CFG.vocab_size, (2, T + 1))
    idx, tgt = toks[:, :-1], toks[:, 1:]

    def jloss(p):
        return jgpt2.loss(p, jnp.asarray(idx), JCFG, targets=jnp.asarray(tgt),
                          policy=jp.FP32_POLICY, attn_impl=jax_impl)

    with mock.patch.object(jfa, "FORCE_INTERPRET", True):
        want_loss, want_grads = jax.value_and_grad(jloss)(jax_params)
    want = gpt2_from_jax_params(jax.tree.map(np.asarray, want_grads), CFG)
    del want["lm_head.weight"]  # tied: one gradient, held by wte

    model = gpt2.GPT2(CFG)
    model.load_state_dict(gpt2_from_jax_params(jax.tree.map(np.asarray, jax_params), CFG))
    monkeypatch.setattr(fa, "K1_MAX_T", 256)
    calls = {"fwd": 0, "bwd": 0}
    fwd, bwd = fa.flash_general_forward, fa.flash_general_backward
    monkeypatch.setattr(fa, "flash_general_forward",
                        lambda *a, **k: calls.__setitem__("fwd", calls["fwd"] + 1) or fwd(*a, **k))
    monkeypatch.setattr(fa, "flash_general_backward",
                        lambda *a, **k: calls.__setitem__("bwd", calls["bwd"] + 1) or bwd(*a, **k))
    loss = gpt2.loss(model, torch.from_numpy(idx), CFG, targets=torch.from_numpy(tgt),
                     policy=FP32_POLICY, attn_impl="flash")
    loss.backward()
    assert calls == {"fwd": CFG.n_layer, "bwd": CFG.n_layer}
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5, atol=1e-5)
    grads = {n: p.grad for n, p in gpt2.named_params(model).items()}
    assert set(grads) == set(want)
    for n, g in grads.items():
        ref = want[n].numpy()
        np.testing.assert_allclose(g.numpy(), ref, rtol=0, atol=2e-5 * np.abs(ref).max(),
                                   err_msg=n)


TINY = GPTConfig(block_size=64, n_layer=2, n_head=2, n_embd=64)
ARGS = ["--synthetic", "--synthetic-shards", "1", "--micro-batch", "1", "--seq-len", "2048",
        "--total-batch", "4096", "--no-hellaswag", "--device", "cpu"]


def test_pretrain_long_seq_len_grows_block_size_and_resumes(tmp_path, monkeypatch):
    """cli.pretrain --seq-len 2048 on a tiny model (block_size 64 in its
    preset): block_size grows to 2048, two steps run, the checkpoint holds a
    2048-row wpe, and --steps 3 in the same log dir resumes at step 2."""
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))  # synthetic shards
    log_dir = str(tmp_path / "log")
    cfg, _ = pretrain.parse_and_build(ARGS, model=TINY)
    assert cfg.model.block_size == 2048 and cfg.grad_accum_steps(1) == 2
    out = pretrain.main(ARGS + ["--log-dir", log_dir, "--steps", "2"], model=TINY)
    assert out["model"].transformer.wpe.weight.shape == (2048, 64)
    assert out["opt_state"]["step"] == 2 and np.isfinite(out["val_loss"])
    tree, meta = load_checkpoint(os.path.join(log_dir, "ckpts", "model_final.pt"))
    assert tree["model"]["transformer.wpe.weight"].shape == (2048, 64)
    assert tree["opt_state"]["m"]["transformer.wpe.weight"].shape == (2048, 64)
    assert meta["next_step"] == 2
    wpe_grad_rows = out["opt_state"]["m"]["transformer.wpe.weight"].abs().sum(1)
    assert (wpe_grad_rows > 0).all()  # every position was trained on

    out = pretrain.main(ARGS + ["--log-dir", log_dir, "--steps", "3"], model=TINY)
    rows = [line.split(",") for f in sorted(glob.glob(os.path.join(log_dir, "*.csv")))
            for line in open(f).read().splitlines()[1:]]
    assert [int(r[2]) for r in rows if r[1] == "train"] == [0, 1, 2]
    assert out["opt_state"]["step"] == 3
