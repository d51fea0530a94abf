"""The PyTorch port imports without jax, and its configs are the JAX ones:
GPTConfig, BridgeConfig, ScheduleConfig, OptimizerConfig and FinetuneConfig
field for field, and every field of the JAX PretrainConfig either carried or
named here as left out."""

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
    "gpt2_vision_language_tpu_torch.ops.fused_adamw",
    "gpt2_vision_language_tpu_torch.train.optimizer",
    "gpt2_vision_language_tpu_torch.train.pretrain",
    "gpt2_vision_language_tpu_torch.cli.pretrain",
    "gpt2_vision_language_tpu_torch.ckpt.checkpoint",
    # the port's own host modules: the tokenizer, the token-shard loader and
    # synthetic corpus, the CSV logger, the HellaSwag evaluator
    "gpt2_vision_language_tpu_torch.data.tokenizer",
    "gpt2_vision_language_tpu_torch.data.fineweb",
    "gpt2_vision_language_tpu_torch.obs.csvlog",
    "gpt2_vision_language_tpu_torch.obs.xlsx",
    "gpt2_vision_language_tpu_torch.eval.hellaswag",
    # the caption fine-tunes and the dt-layout A/B tool
    "gpt2_vision_language_tpu_torch.ops.pooling",
    "gpt2_vision_language_tpu_torch.models.bridges",
    "gpt2_vision_language_tpu_torch.models.caption",
    "gpt2_vision_language_tpu_torch.data.coco",
    "gpt2_vision_language_tpu_torch.data.pipeline",
    "gpt2_vision_language_tpu_torch.eval.cider",
    "gpt2_vision_language_tpu_torch.eval.caption_eval",
    "gpt2_vision_language_tpu_torch.train.finetune",
    "gpt2_vision_language_tpu_torch.cli.finetune_linear",
    "gpt2_vision_language_tpu_torch.cli.finetune_qformer",
    "gpt2_vision_language_tpu_torch.cli.finetune_xattn",
    "gpt2_vision_language_tpu_torch.tools.ab_dt_flash",
    # checkpoint in, quality metrics out: the readers, METEOR, the CLI
    "gpt2_vision_language_tpu_torch.ckpt.torch_import",
    "gpt2_vision_language_tpu_torch.eval.meteor",
    "gpt2_vision_language_tpu_torch.eval.synonyms",
    "gpt2_vision_language_tpu_torch.cli.eval_quality",
    # images in, captions out: the CLIP encoder and its two CLIs
    "gpt2_vision_language_tpu_torch.models.clip_vit",
    "gpt2_vision_language_tpu_torch.cli.extract_clip_features",
    "gpt2_vision_language_tpu_torch.cli.caption",
    # the host CLIs: the BPE exporter, the HellaSwag fetcher, the shard writer
    "gpt2_vision_language_tpu_torch.data.bpe_export",
    "gpt2_vision_language_tpu_torch.cli.export_bpe",
    "gpt2_vision_language_tpu_torch.data.hellaswag_download",
    "gpt2_vision_language_tpu_torch.cli.prepare_fineweb",
)


def test_port_imports_no_jax():
    # a subprocess: this test process already holds jax (tests/conftest.py)
    code = (
        "import gpt2_vision_language_tpu_torch as P; "
        + "; ".join(f"import {m}" for m in PORT_MODULES)
        + "; import sys; assert 'jax' not in sys.modules, 'jax was imported'"
        + "; assert 'gpt2_vision_language_tpu' not in sys.modules, 'the JAX package'"
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


# JAX PretrainConfig fields the port does not carry, and why
LEFT_OUT = {
    # TPU-only memory and dispatch mechanisms
    "pin_layouts": "TPU-only", "split_accum": "TPU-only", "sync_accum": "TPU-only",
}


@pytest.mark.parametrize("name", ["ScheduleConfig", "OptimizerConfig", "BridgeConfig"])
def test_train_configs_match_jax(name):
    def fields(cls):
        return [(f.name, f.type, f.default) for f in dataclasses.fields(cls)]

    assert fields(getattr(port_config, name)) == fields(getattr(jax_config, name))


def test_pretrain_config_fields_carried_or_left_out():
    jax_fields = {f.name: f for f in dataclasses.fields(jax_config.PretrainConfig)}
    port_fields = {f.name: f for f in dataclasses.fields(port_config.PretrainConfig)}
    assert set(port_fields) | set(LEFT_OUT) == set(jax_fields)
    assert not set(port_fields) & set(LEFT_OUT)
    j, p = jax_config.PretrainConfig(), port_config.PretrainConfig()
    for name in port_fields:
        want = getattr(j, name)
        got = getattr(p, name)
        if dataclasses.is_dataclass(want):
            assert dataclasses.asdict(got) == dataclasses.asdict(want), name
        else:
            assert got == want, name
    assert p.grad_accum_steps(1) == j.grad_accum_steps(1) == 64


def test_finetune_config_fields_carried():
    """Every field of the JAX FinetuneConfig, in order, with the same
    defaults (the dataclass-valued ones compared by value)."""
    jf = dataclasses.fields(jax_config.FinetuneConfig)
    pf = dataclasses.fields(port_config.FinetuneConfig)
    assert [f.name for f in pf] == [f.name for f in jf]
    j, p = jax_config.FinetuneConfig(), port_config.FinetuneConfig()
    for f in pf:
        want, got = getattr(j, f.name), getattr(p, f.name)
        if dataclasses.is_dataclass(want):
            assert dataclasses.asdict(got) == dataclasses.asdict(want), f.name
        else:
            assert got == want, f.name
