"""The port's image -> caption CLI (cli/caption.py) on the CPU, as
tests/test_caption_cli.py drives the JAX one: random weights and the tiny
CLIP, the same output lines as the JAX CLI; then a bridge read from a
checkpoint in the port's fine-tune format, and the device check."""

import os

import numpy as np
import pytest
import torch

from gpt2_vision_language_tpu_torch.cli import caption as caption_cli
from torch_threads import share_cores  # noqa: F401  (autouse)


@pytest.fixture(scope="module")
def images(tmp_path_factory):
    from PIL import Image

    tmp = tmp_path_factory.mktemp("images")
    rng = np.random.RandomState(0)
    paths = []
    for i, (w, h) in enumerate([(50, 40), (32, 64)]):  # non-square on purpose
        p = str(tmp / f"img{i}.jpg")
        Image.fromarray(rng.randint(0, 255, (h, w, 3), dtype=np.uint8)).save(p)
        paths.append(p)
    return paths


def _prefix(line):
    return line.split(": ", 1)[0] + ": " + line.split(": ", 1)[1][:len("A photo of")]


def test_caption_lines_match_the_jax_cli(images, capsys):
    """Random weights everywhere: one line an image, in order, each
    ``{basename}: {prompt}{caption}``, with the three warnings, as the JAX
    CLI prints them (the captions themselves differ: other random weights
    and another generator)."""
    from gpt2_vision_language_tpu.cli.caption import main as jax_main

    jax_main(images + ["--variant", "tiny", "--new-tokens", "4"])
    want = capsys.readouterr().out.splitlines()
    lines = caption_cli.main(images + ["--variant", "tiny", "--new-tokens", "4",
                                       "--device", "cpu"])
    got = capsys.readouterr().out.splitlines()
    assert [_prefix(line) for line in lines] == ["img0.jpg: A photo of", "img1.jpg: A photo of"]
    assert lines == got[-2:]
    warn = [line for line in got if line.startswith("[caption] WARNING")]
    assert warn == [line for line in want if line.startswith("[caption] WARNING")]
    assert [_prefix(line) for line in want[-2:]] == [_prefix(line) for line in lines]


def test_bridge_from_a_port_finetune_checkpoint(images, tmp_path, capsys):
    """--bridge-ckpt reads a checkpoint in the format the port's fine-tunes
    write (CheckpointManager: the CaptionModel's gpt.* and bridge.*, the
    optimizer state, meta): the CLI takes its bridge half, and with the same
    seed the captions are the same as from the bridge loaded directly."""
    from gpt2_vision_language_tpu_torch.ckpt.checkpoint import CheckpointManager
    from gpt2_vision_language_tpu_torch.core.config import (
        CLIP_TINY, BridgeConfig, GPTConfig,
    )
    from gpt2_vision_language_tpu_torch.models import bridges, caption, clip_vit, gpt2

    bcfg = BridgeConfig(kind="linear", enc_dim=CLIP_TINY.width)
    bridge = bridges.bridge_init(bcfg, 768, generator=torch.Generator().manual_seed(11))
    small = gpt2.init(GPTConfig(block_size=64, vocab_size=256, n_layer=1, n_head=2, n_embd=32))
    manager = CheckpointManager(str(tmp_path / "ckpts"))
    manager.save_final(3, caption.CaptionModel(small, bridge), {"m": {}, "v": {}, "step": 3},
                       next_step=3)
    lines = caption_cli.main(images + ["--variant", "tiny", "--new-tokens", "4", "--device",
                                       "cpu", "--bridge-ckpt", manager.final_path])
    out = capsys.readouterr().out
    assert "random bridge weights" not in out and "random GPT-2 weights" in out
    # the same run by hand: the CLI's seeded CLIP and GPT-2, this bridge
    cfg = GPTConfig()
    clip_model = clip_vit.init(CLIP_TINY, generator=torch.Generator().manual_seed(0))
    gpt = gpt2.init(cfg, generator=torch.Generator().manual_seed(1))
    from gpt2_vision_language_tpu_torch.cli.extract_clip_features import load_batch
    from gpt2_vision_language_tpu_torch.data.tokenizer import get_tokenizer

    tok = get_tokenizer()
    toks = caption_cli.caption_crops(
        clip_model, caption.CaptionModel(gpt, bridge), load_batch(images, 32), CLIP_TINY, cfg,
        bcfg, tok.encode("A photo of"), generator=torch.Generator().manual_seed(0),
        new_tokens=4)
    assert lines == [f"{os.path.basename(p)}: A photo of{tok.decode(t.tolist())}"
                     for p, t in zip(images, toks)]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="--device cpu"):
            caption_cli.main(images + ["--variant", "tiny"])
