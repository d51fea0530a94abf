"""Export -> import round-trip, and reference-model consumption of exports."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from conftest import requires_reference

from gpt2_vision_language_tpu.core.config import GPTConfig
from gpt2_vision_language_tpu.core.precision import FP32_POLICY
from gpt2_vision_language_tpu.models import gpt2
from gpt2_vision_language_tpu.ckpt.torch_export import (
    gpt2_to_torch_state_dict,
    save_torch_checkpoint,
)
from gpt2_vision_language_tpu.ckpt.torch_import import gpt2_from_torch_state_dict
from torch_threads import share_cores  # noqa: F401  (autouse)

SMALL = GPTConfig(block_size=32, vocab_size=128, n_layer=2, n_head=2, n_embd=32)
SMALL_X = SMALL.replace(img_embd=16, cross_attention=True)


@pytest.mark.parametrize("cfg", [SMALL, SMALL_X], ids=["plain", "xattn"])
def test_export_import_roundtrip(cfg):
    params = gpt2.init(jax.random.PRNGKey(3), cfg)
    sd = gpt2_to_torch_state_dict(params, cfg)
    back = gpt2_from_torch_state_dict(sd, cfg)
    for (pa, a), (pb, bb) in zip(
        jax.tree_util.tree_flatten_with_path(params)[0],
        jax.tree_util.tree_flatten_with_path(back)[0],
    ):
        np.testing.assert_allclose(
            np.asarray(a), np.asarray(bb), rtol=1e-6, err_msg=str(pa)
        )


@requires_reference
def test_reference_model_loads_export(tmp_path):
    """The torch reference must load our export strict=True and produce the
    same logits as our model."""
    torch = pytest.importorskip("torch")
    import os
    import sys

    sys.path.insert(0, os.path.dirname(__file__))
    from test_parity_reference import _load_ref_module

    ref = _load_ref_module("gpt2_linear")
    params = gpt2.init(jax.random.PRNGKey(4), SMALL)
    p = str(tmp_path / "exported.pt")
    save_torch_checkpoint(p, params, SMALL, meta={"step": 1})

    tmodel = ref.GPT_previous(
        ref.GPTConfig(block_size=32, vocab_size=128, n_layer=2, n_head=2, n_embd=32)
    )
    ckpt = torch.load(p, map_location="cpu", weights_only=False)
    missing, unexpected = tmodel.load_state_dict(ckpt["model"], strict=False)
    assert not unexpected
    # only the unused causal-mask buffers may be missing
    assert all(k.endswith("attn.bias") for k in missing)

    rng = np.random.RandomState(0)
    idx = rng.randint(0, 128, (2, 16))
    with torch.no_grad():
        tlogits, _ = tmodel.eval()(torch.tensor(idx, dtype=torch.long))
    jlogits, _ = gpt2.apply(params, jnp.asarray(idx), SMALL, policy=FP32_POLICY)
    np.testing.assert_allclose(
        np.asarray(jlogits), tlogits.numpy(), rtol=2e-4, atol=2e-4
    )


def test_hf_gpt2_import_parity():
    """HF GPT2LMHeadModel (Conv1D layout) -> our pytree, logit parity."""
    transformers = pytest.importorskip("transformers")
    torch = pytest.importorskip("torch")
    from transformers import GPT2Config, GPT2LMHeadModel

    hf_cfg = GPT2Config(
        vocab_size=128, n_positions=32, n_embd=32, n_layer=2, n_head=2
    )
    torch.manual_seed(0)
    model = GPT2LMHeadModel(hf_cfg).eval()

    from gpt2_vision_language_tpu.ckpt.torch_import import gpt2_from_hf_state_dict

    params = gpt2_from_hf_state_dict(model.state_dict(), SMALL)
    rng = np.random.RandomState(0)
    idx = rng.randint(0, 128, (2, 16))
    with torch.no_grad():
        ref = model(torch.tensor(idx, dtype=torch.long)).logits.numpy()
    ours, _ = gpt2.apply(params, jnp.asarray(idx), SMALL, policy=FP32_POLICY)
    np.testing.assert_allclose(np.asarray(ours), ref, rtol=5e-4, atol=5e-4)
