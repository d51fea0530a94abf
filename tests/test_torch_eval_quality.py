"""The port's cli.eval_quality against the JAX package's at the TINY config
of tests/test_eval_quality.py: the HellaSwag counts from a reference .pt, an
HF state dict and a JAX .npz, the caption metrics from a GPT_Caption .pt
(linear bridge) and a JAX .npz fine-tune (Q-Former), the same JSON keys; then
the port alone on HF directories, the cross-attention decoder and its
errors."""

import json
import os

import jax
import numpy as np
import pytest
import torch

from gpt2_vision_language_tpu.ckpt.checkpoint import save_checkpoint as jax_save_checkpoint
from gpt2_vision_language_tpu.ckpt.torch_export import (
    gpt2_to_torch_state_dict,
    save_torch_checkpoint,
)
from gpt2_vision_language_tpu.cli import eval_quality as jeq
from gpt2_vision_language_tpu.core.config import BridgeConfig as JaxBridgeConfig
from gpt2_vision_language_tpu.core.config import GPTConfig as JaxGPTConfig
from gpt2_vision_language_tpu.models import caption as jcaption
from gpt2_vision_language_tpu.models import gpt2 as jgpt2
from gpt2_vision_language_tpu_torch.cli import eval_quality
from gpt2_vision_language_tpu_torch.data.coco import write_synthetic_coco

TINY = JaxGPTConfig(block_size=64, vocab_size=256, n_layer=2, n_head=2, n_embd=32)


def _write_hellaswag(path, n=12):
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "hellaswag_val.jsonl"), "w") as f:
        for i in range(n):
            f.write(json.dumps({"ctx": f"Number {i} is",
                                "endings": ["small", "big", "word", "none of these"],
                                "label": i % 4}) + "\n")


def _hf_state_dict(params, cfg):
    """HF GPT2LMHeadModel layout: no transformer. prefix, Conv1D (in, out)."""
    sd = {}
    for k, v in gpt2_to_torch_state_dict(params, cfg).items():
        bare = k.removeprefix("transformer.")
        v = torch.from_numpy(np.array(v))
        sd[bare] = v.t().contiguous() if bare.endswith(
            ("c_attn.weight", "c_proj.weight", "c_fc.weight")) else v
    for i in range(cfg.n_layer):
        sd[f"h.{i}.attn.bias"] = torch.tril(torch.ones(1, 1, 64, 64))
    return sd


@pytest.fixture(scope="module")
def tiny_params():
    # scaled up from init so that the four endings' losses differ clearly
    return jax.tree.map(lambda a: a * 4.0, jgpt2.init(jax.random.PRNGKey(0), TINY))


def test_hellaswag_counts_equal_jax_for_every_format(tmp_path, tiny_params):
    """Reference .pt, HF state dict and JAX .npz at --policy fp32: the port's
    hellaswag_correct and hellaswag_total equal the JAX CLI's on the same
    files, and its JSON keys are the JAX CLI's."""
    hs = tmp_path / "hs"
    _write_hellaswag(hs)
    pt, hf, npz = tmp_path / "model_best.pt", tmp_path / "pytorch_model.bin", tmp_path / "m.npz"
    save_torch_checkpoint(str(pt), tiny_params, TINY, meta={"step": 7})
    torch.save(_hf_state_dict(tiny_params, TINY), str(hf))
    jax_save_checkpoint(str(npz), {"params": tiny_params}, meta={"step": 7})
    common = ["--n-head", "2", "--hellaswag", "--hellaswag-dir", str(hs)]
    for flag, path, fmt in (("--gpt-ckpt", pt, "reference-pt"), ("--hf-ckpt", hf, "hf"),
                            ("--gpt-ckpt", npz, "npz")):
        argv = [flag, str(path)] + common
        want = jeq.main(argv)
        got = eval_quality.main(argv + ["--device", "cpu", "--out", str(tmp_path / "m.json")])
        assert set(got) == set(want), fmt
        assert got["ckpt_format"] == want["ckpt_format"] == fmt
        assert got["model"] == want["model"] == {"n_layer": 2, "n_head": 2, "n_embd": 32,
                                                 "block_size": 64}
        assert (got["hellaswag_correct"], got["hellaswag_total"]) == (
            want["hellaswag_correct"], want["hellaswag_total"]), fmt
        assert got["hellaswag_total"] == 12 and got["policy"] == "fp32"
        assert json.loads((tmp_path / "m.json").read_text()) == got


def test_caption_metrics_match_jax_keys(tmp_path, tiny_params):
    """A GPT_Caption .pt (linear bridge) and a JAX .npz fine-tune (Q-Former),
    each with --meteor on write_synthetic_coco data: the JAX CLI's keys, the
    same cider_samples and synonym provenance, finite scores (the two
    packages draw different random numbers, so the scores are not
    compared)."""
    tokens_dir, ann = write_synthetic_coco(str(tmp_path), split="val", n_images=6,
                                           n_tokens=197, enc_dim=24)
    rng = np.random.RandomState(0)
    sd = {f"gpt.{k}": torch.from_numpy(np.array(v))
          for k, v in gpt2_to_torch_state_dict(tiny_params, TINY).items()}
    sd["bridge.vis_proj.weight"] = torch.from_numpy(rng.randn(32, 24).astype(np.float32) * 0.02)
    sd["bridge.vis_proj.bias"] = torch.zeros(32)
    pt = tmp_path / "model_best_caption.pt"
    torch.save({"model": sd, "step": 5}, str(pt))
    # the Q-Former's default 12 heads need a width that 12 divides
    qcfg = TINY.replace(n_embd=48)
    qparams = {"gpt": jgpt2.init(jax.random.PRNGKey(1), qcfg),
               "bridge": jcaption.init(jax.random.PRNGKey(2), qcfg, JaxBridgeConfig(
                   kind="qformer", enc_dim=24, n_queries=4, n_layers=1))}
    npz = tmp_path / "qformer.npz"
    jax_save_checkpoint(str(npz), {"params": qparams}, meta={"step": 3})
    common = ["--n-head", "2", "--coco-tokens", tokens_dir, "--coco-ann", ann,
              "--cider-samples", "4", "--batch-size", "2", "--new-tokens", "4", "--meteor"]
    for path, kind in ((pt, "linear"), (npz, "qformer")):
        argv = ["--gpt-ckpt", str(path), "--bridge", kind] + common
        want = jeq.main(argv)
        got = eval_quality.main(argv + ["--device", "cpu"])
        assert set(got) == set(want), kind
        assert got["ckpt_format"] == want["ckpt_format"]
        assert got["cider_samples"] == want["cider_samples"] == 4
        assert got["meteor_synonyms"] == want["meteor_synonyms"]
        assert np.isfinite(got["cider"]) and got["cider"] >= 0.0
        assert np.isfinite(got["meteor"]) and 0.0 <= got["meteor"] <= 1.0


def test_hf_directories_and_the_cross_attention_decoder(tmp_path, tiny_params):
    """The port alone: an HF directory with pytorch_model.bin and one with
    model.safetensors give the same counts as the weights file; a
    cross-attention checkpoint scores captions with --bridge xattn."""
    st = pytest.importorskip("safetensors.torch")
    hs = tmp_path / "hs"
    _write_hellaswag(hs, n=4)
    sd = _hf_state_dict(tiny_params, TINY)
    for name, save in (("bin", lambda p: torch.save(sd, p / "pytorch_model.bin")),
                       ("st", lambda p: st.save_file(sd, str(p / "model.safetensors")))):
        os.makedirs(tmp_path / name)
        save(tmp_path / name)
    argv = ["--n-head", "2", "--hellaswag", "--hellaswag-dir", str(hs), "--device", "cpu"]
    outs = [eval_quality.main(["--hf-ckpt", str(p)] + argv)
            for p in (tmp_path / "bin" / "pytorch_model.bin", tmp_path / "bin", tmp_path / "st")]
    assert all(o["hellaswag_correct"] == outs[0]["hellaswag_correct"] for o in outs)
    assert all(o["ckpt_format"] == "hf" and o["hellaswag_total"] == 4 for o in outs)

    from gpt2_vision_language_tpu_torch.core.config import GPTConfig
    from gpt2_vision_language_tpu_torch.models import gpt2

    xcfg = GPTConfig(block_size=64, vocab_size=256, n_layer=2, n_head=2, n_embd=32,
                     img_embd=24, cross_attention=True)
    model = gpt2.init(xcfg, generator=torch.Generator().manual_seed(0))
    torch.save({"model": model.state_dict()}, str(tmp_path / "xattn.pt"))
    tokens_dir, ann = write_synthetic_coco(str(tmp_path), split="val", n_images=3,
                                           n_tokens=197, enc_dim=24)
    out = eval_quality.main(["--gpt-ckpt", str(tmp_path / "xattn.pt"), "--bridge", "xattn",
                             "--n-head", "2",
                             "--coco-tokens", tokens_dir, "--coco-ann", ann,
                             "--cider-samples", "3", "--new-tokens", "3", "--device", "cpu"])
    assert np.isfinite(out["cider"]) and out["cider_samples"] == 3
    with pytest.raises(KeyError, match="cross_attention=False"):  # needs --bridge xattn
        eval_quality.main(["--gpt-ckpt", str(tmp_path / "xattn.pt"), "--hellaswag",
                           "--hellaswag-dir", str(hs), "--device", "cpu"])


def test_entry_point_needs_cuda_unless_asked_for_the_cpu(tmp_path, tiny_params, monkeypatch):
    pt = tmp_path / "model.pt"
    save_torch_checkpoint(str(pt), tiny_params, TINY)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="--device cpu"):
            eval_quality.main(["--gpt-ckpt", str(pt), "--hellaswag"])
    # HellaSwag under the fp32 policy (the default) on the card passes the
    # device check and goes on to read the checkpoint (it was refused before
    # the fp32 forward kernel existed); the forward's route is held by
    # test_fp32_hellaswag_reaches_the_fp32_kernel below
    class Reached(Exception):
        pass

    def load_gpt(args):
        assert args.policy == "fp32" and args.device == "cuda" and args.hellaswag
        raise Reached

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(eval_quality, "load_gpt", load_gpt)
    with pytest.raises(Reached):
        eval_quality.main(["--gpt-ckpt", str(pt), "--hellaswag"])
    monkeypatch.undo()
    with pytest.raises(SystemExit):
        eval_quality.main(["--hellaswag", "--device", "cpu"])
    with pytest.raises(SystemExit):
        eval_quality.main(["--gpt-ckpt", str(pt), "--coco-tokens", "x", "--coco-ann", "y",
                           "--device", "cpu"])


def test_fp32_hellaswag_reaches_the_fp32_kernel(tmp_path, monkeypatch):
    """--hellaswag at the default policy (fp32) on activations that report
    the card: every self-attention of a batch padded to 512 goes through
    ops.attention.sdpa to the fp32 forward kernel's launcher (stubbed with
    its plain version), none to the bf16 one, and the counts equal the CPU
    run's."""
    from test_torch_flash_attention import _OnCard

    from gpt2_vision_language_tpu_torch.models import gpt2 as pgpt2
    from gpt2_vision_language_tpu_torch.ops import flash_attention as fa

    cfg = JaxGPTConfig(block_size=1024, vocab_size=256, n_layer=2, n_head=2, n_embd=128)
    params = jax.tree.map(lambda a: a * 4.0, jgpt2.init(jax.random.PRNGKey(1), cfg))
    pt = str(tmp_path / "model.pt")
    save_torch_checkpoint(pt, params, cfg)
    hs = tmp_path / "hs"
    os.makedirs(hs)
    with open(hs / "hellaswag_val.jsonl", "w") as f:
        for i in range(3):  # contexts of 300+ byte tokens: one batch padded to 512
            f.write(json.dumps({"ctx": f"Number {i} is " + "la " * 100,
                                "endings": ["small", "big", "word", "none of these"],
                                "label": i % 4}) + "\n")
    argv = ["--gpt-ckpt", pt, "--n-head", "2", "--hellaswag", "--hellaswag-dir", str(hs),
            "--device", "cpu"]
    want = eval_quality.main(argv)

    calls = []

    def f32_stub(q, k, v, *, causal=True):
        calls.append(("f32", q.dtype, tuple(q.shape), causal))
        plain = [a.as_subclass(torch.Tensor) for a in (q, k, v)]
        return fa.flash_attention_reference(*plain, causal=causal)

    def bf16_stub(q, k, v, *, causal=True):
        calls.append(("bf16", q.dtype))
        raise AssertionError("fp32 q reached the bf16 kernel")

    embed = pgpt2.embed_tokens
    monkeypatch.setattr(pgpt2, "embed_tokens",
                        lambda *a, **kw: embed(*a, **kw).as_subclass(_OnCard))
    monkeypatch.setattr(fa, "flash_forward_f32", f32_stub)
    monkeypatch.setattr(fa, "flash_fwd_cuda", bf16_stub)
    got = eval_quality.main(argv)
    # one batch: 8 examples (3 and 5 padding) x 4 endings
    assert calls == [("f32", torch.float32, (32, 512, 2, 64), True)] * cfg.n_layer
    assert got["policy"] == "fp32"
    for key in ("hellaswag_correct", "hellaswag_total"):
        assert got[key] == want[key]
    assert got["hellaswag_total"] == 3
