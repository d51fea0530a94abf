"""The PyTorch port imports without jax, and its GPTConfig is the JAX one."""

import dataclasses
import os
import subprocess
import sys

import pytest

from gpt2_vision_language_tpu.core import config as jax_config
from gpt2_vision_language_tpu_torch.core import config as port_config

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PORT_MODULES = (
    "gpt2_vision_language_tpu_torch.models.gpt2",
    "gpt2_vision_language_tpu_torch.infer.decode",
    "gpt2_vision_language_tpu_torch.cli.sample",
    "gpt2_vision_language_tpu_torch.cli.bench_decode",
    "gpt2_vision_language_tpu_torch.train.step",
    "gpt2_vision_language_tpu_torch.ckpt.convert",
    "gpt2_vision_language_tpu_torch.ops.fused_ce",
    "gpt2_vision_language_tpu_torch.ops.flash_attention",
    # the tokenizer is shared host code the CLIs import from the JAX package
    "gpt2_vision_language_tpu.data.tokenizer",
)


def test_port_imports_no_jax():
    # a subprocess: this test process already holds jax (tests/conftest.py)
    code = (
        "import gpt2_vision_language_tpu_torch as P; "
        + "; ".join(f"import {m}" for m in PORT_MODULES)
        + "; import sys; assert 'jax' not in sys.modules, 'jax was imported'"
    )
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr


def test_gpt_config_fields_match_jax():
    def fields(cls):
        return [(f.name, f.type, f.default) for f in dataclasses.fields(cls)]

    assert fields(port_config.GPTConfig) == fields(jax_config.GPTConfig)


@pytest.mark.parametrize("preset", ["GPT2_124M", "GPT2_350M", "GPT2_774M", "GPT2_1558M"])
def test_presets_match_jax(preset):
    j, p = getattr(jax_config, preset), getattr(port_config, preset)
    assert dataclasses.asdict(p) == dataclasses.asdict(j)
    assert (p.head_dim, p.padded_vocab_size) == (j.head_dim, j.padded_vocab_size)
    assert p.padded_vocab_size == 50304
