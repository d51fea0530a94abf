"""The port's caption fine-tunes against the JAX package's: optimizer steps
of each bridge from carried-over weights at fp32 (loss, grad norm, updated
trainable leaves, frozen leaves bit-identical), then the trainer and the
three CLIs on synthetic COCO with --device cpu, a resume, and the refusals."""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpt2_vision_language_tpu.core import config as jcfg
from gpt2_vision_language_tpu.core.precision import FP32_POLICY as JAX_FP32
from gpt2_vision_language_tpu.models import bridges as jbridges
from gpt2_vision_language_tpu.models import caption as jcaption
from gpt2_vision_language_tpu.models import gpt2 as jgpt2
from gpt2_vision_language_tpu.train import make_train_step as jax_make_train_step
from gpt2_vision_language_tpu.train.optimizer import adamw_init as jax_adamw_init
from gpt2_vision_language_tpu_torch.ckpt.convert import (
    caption_from_jax_params, gpt2_from_jax_params, opt_state_from_jax,
)
from gpt2_vision_language_tpu_torch.cli import finetune_linear, finetune_qformer, finetune_xattn
from gpt2_vision_language_tpu_torch.core.config import (
    BridgeConfig, FinetuneConfig, GPTConfig, OptimizerConfig, ScheduleConfig,
    finetune_linear_preset, finetune_qformer_preset, finetune_xattn_preset,
)
from gpt2_vision_language_tpu_torch.core.precision import FP32_POLICY
from gpt2_vision_language_tpu_torch.data.coco import write_synthetic_coco
from gpt2_vision_language_tpu_torch.models import bridges, caption, gpt2
from gpt2_vision_language_tpu_torch.ops import fused_adamw as fw
from gpt2_vision_language_tpu_torch.train import finetune
from gpt2_vision_language_tpu_torch.train.optimizer import adamw_init
from gpt2_vision_language_tpu_torch.train.step import make_train_step
from torch_threads import share_cores  # noqa: F401  (autouse)

ARCH = dict(block_size=64, vocab_size=300, n_layer=2, n_head=2, n_embd=32)
XARCH = dict(ARCH, img_embd=24, cross_attention=True)
# dropout off: jax.random masks cannot be matched (the dropout's own
# properties are in tests/test_torch_bridges.py)
BKW = dict(enc_dim=24, n_queries=8, n_layers=2, n_heads=2, dropout=0.0)
SCHED = dict(max_lr=1e-3, min_lr=1e-4, warmup_steps=1, max_steps=10)
OPT = dict(eps=1e-6)  # see tests/test_torch_train_step.py: keeps Adam's first steps tame
ACCUM, B, T, N_BANK = 2, 4, 16, 12


def _window(seed):
    rng = np.random.RandomState(seed)
    return {"x": rng.randint(0, 300, (ACCUM, B, T)).astype(np.int32),
            "y": rng.randint(0, 300, (ACCUM, B, T)).astype(np.int32),
            "mask": np.arange(T)[None, None, :] < rng.randint(3, T, (ACCUM, B, 1)),
            "idx": rng.randint(0, N_BANK, (ACCUM, B)).astype(np.int32)}


def _to_torch(win):
    out = {k: torch.from_numpy(v) for k, v in win.items()}
    out["idx"] = out["idx"].long()
    return out


@pytest.mark.parametrize("kind", ["linear", "qformer", "xattn"])
def test_optimizer_steps_match_jax(kind):
    """Two optimizer steps (accum 2) from the same weights and zero moments:
    loss and grad norm within 1e-5 relative, the updated trainable leaves
    within 1e-5, the frozen leaves bit-identical and without moments."""
    bank = np.random.RandomState(9).randn(N_BANK, 33, 24).astype(np.float32)
    if kind == "xattn":
        jc, pc = jcfg.GPTConfig(**XARCH), GPTConfig(**XARCH)
        params = jgpt2.init(jax.random.PRNGKey(0), jc)
        params["blocks"]["gate"] = jnp.asarray([0.3, -0.2])  # open: every xattn leaf gets a grad
        jtrain, jdecay = jgpt2.trainable_mask_xattn(params), jgpt2.decay_mask(params)

        def jloss(p, micro, bk):
            return jgpt2.loss(p, micro["x"], jc, z=jnp.take(bk, micro["idx"], axis=0),
                              targets=micro["y"], target_mask=micro["mask"], policy=JAX_FP32)

        model = gpt2.GPT2(pc)
        to_port = lambda tree: gpt2_from_jax_params(jax.device_get(tree), pc)  # noqa: E731
        model.load_state_dict(to_port(params))
        trainable, decay = gpt2.trainable_mask_xattn(model), gpt2.decay_mask(model)

        def loss_fn(m, micro, bk):
            return gpt2.loss(m, micro["x"], pc, z=bk[micro["idx"]], targets=micro["y"],
                             target_mask=micro["mask"], policy=FP32_POLICY)
    else:
        jc, pc = jcfg.GPTConfig(**ARCH), GPTConfig(**ARCH)
        jb, pb = jcfg.BridgeConfig(kind=kind, **BKW), BridgeConfig(kind=kind, **BKW)
        params = {"gpt": jgpt2.init(jax.random.PRNGKey(0), jc),
                  "bridge": jcaption.init(jax.random.PRNGKey(1), jc, jb)}
        jtrain = {"gpt": jax.tree.map(lambda _: False, params["gpt"]),
                  "bridge": jax.tree.map(lambda _: True, params["bridge"])}
        jdecay = {"gpt": jgpt2.decay_mask(params["gpt"]),
                  "bridge": jbridges.bridge_decay_mask(params["bridge"])}
        jbase = jcaption.loss_fn_factory(jc, jb, policy=JAX_FP32, train=True)

        def jloss(p, micro, bk):
            return jbase(p, dict(micro, z=jnp.take(bk, micro["idx"], axis=0)))

        model = caption.CaptionModel(gpt2.GPT2(pc), bridges.bridge_init(pb, pc.n_embd))
        to_port = lambda tree: caption_from_jax_params(jax.device_get(tree), pc, pb)  # noqa: E731
        model.load_state_dict(to_port(params))
        trainable = {n: n.startswith("bridge.") for n in gpt2.named_params(model)}
        decay = {f"gpt.{n}": d for n, d in gpt2.decay_mask(model.gpt).items()}
        decay.update({f"bridge.{n}": d
                      for n, d in bridges.bridge_decay_mask(model.bridge).items()})
        base = caption.loss_fn_factory(pc, pb, policy=FP32_POLICY, train=True)

        def loss_fn(m, micro, bk):
            return base(m, {**micro, "z": bk[micro["idx"]]})

    jstate = jax_adamw_init(params, trainable_mask=jtrain)
    jstep = jax_make_train_step(jloss, jcfg.OptimizerConfig(**OPT), jcfg.ScheduleConfig(**SCHED),
                                decay_mask=jdecay, trainable_mask=jtrain, donate=False)
    names = gpt2.named_params(model)
    state = adamw_init(names, trainable_mask=trainable)
    assert set(state["m"]) == {n for n in names if trainable[n]}
    step = make_train_step(loss_fn, OptimizerConfig(**OPT), ScheduleConfig(**SCHED),
                           decay_mask=decay, trainable_mask=trainable)
    before = {n: p.detach().clone() for n, p in names.items()}
    for i in range(2):
        win = _window(i)
        params, jstate, jm = jstep(params, jstate, {k: jnp.asarray(v) for k, v in win.items()},
                                   jnp.int32(i), jnp.asarray(bank))
        m = step(model, state, _to_torch(win), i, torch.from_numpy(bank))
        for key in ("loss", "grad_norm", "lr"):
            assert m[key] == pytest.approx(float(jm[key]), rel=1e-5), (i, key)
        want = to_port(params)
        for n, p in gpt2.named_params(model).items():
            if trainable[n]:
                np.testing.assert_allclose(p.detach().numpy(), want[n].numpy(), rtol=1e-5,
                                           atol=1e-5, err_msg=f"step {i} {n}")
    after = gpt2.named_params(model)
    moved = 0
    for n, p in after.items():
        if trainable[n]:
            moved += not torch.equal(p, before[n])
        else:
            assert torch.equal(p, before[n]) and p.grad is None and not p.requires_grad, n
    assert moved == sum(trainable.values())
    assert fw.fused_adamw.launches == 0  # CPU tensors: the plain version
    # the JAX moments come across under the same names, the frozen placeholders left out
    bridge_cfg = None if kind == "xattn" else pb
    if kind != "xattn":
        ours = opt_state_from_jax(jax.device_get(jstate), pc, bridge_cfg)
        assert set(ours["m"]) == set(state["m"]) and ours["step"] == state["step"] == 2
        for n, a in state["m"].items():
            np.testing.assert_allclose(a.numpy(), ours["m"][n].numpy(), rtol=1e-4, atol=1e-7,
                                       err_msg=n)


def test_presets_match_jax():
    for ours, theirs in ((finetune_linear_preset, jcfg.finetune_linear_preset),
                         (finetune_qformer_preset, jcfg.finetune_qformer_preset),
                         (finetune_xattn_preset, jcfg.finetune_xattn_preset)):
        a, b = ours(), theirs()
        assert dataclasses.asdict(a) == dataclasses.asdict(b)
        assert a.grad_accum_steps(1) == b.grad_accum_steps(1)
    assert finetune_linear_preset().grad_accum_steps(1) == 128
    assert finetune_xattn_preset().grad_accum_steps(1) == 1
    assert finetune_xattn_preset(dataset_size=1000).schedule.max_steps == 8
    with pytest.raises(ValueError, match="divisible"):
        FinetuneConfig(micro_batch_size=3).grad_accum_steps(1)


SMALL = GPTConfig(block_size=64, vocab_size=50257, n_layer=2, n_head=2, n_embd=32)
SMALL_X = SMALL.replace(img_embd=24, cross_attention=True)
SMALL_BRIDGE = dict(enc_dim=24, n_queries=8, n_layers=2, n_heads=2)


@pytest.fixture(scope="module")
def coco_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("coco"))
    write_synthetic_coco(root, split="train", n_images=32, n_tokens=197, enc_dim=24)
    write_synthetic_coco(root, split="val", n_images=16, n_tokens=197, enc_dim=24)
    return root


def _cfg(coco_root, tmp_path, kind):
    return FinetuneConfig(
        model=SMALL_X if kind == "xattn" else SMALL,
        bridge=BridgeConfig(kind=kind, **SMALL_BRIDGE),
        micro_batch_size=4, seq_len=16, total_batch_size=4 * 16 * 2,
        grad_accum_override=1 if kind == "xattn" else None,
        schedule=ScheduleConfig(max_lr=1e-3, min_lr=1e-4, warmup_steps=1, max_steps=3),
        val_every=2, val_steps=2, cider_samples=6, cider_max_new_tokens=6, save_every=100,
        coco_root=coco_root, clip_feats_dir=os.path.join(coco_root, "clip_feats"),
        log_dir=str(tmp_path / "log"),
    )


def _rows(log_dir):
    rows = []
    for f in sorted(os.listdir(log_dir)):
        if f.endswith(".csv"):
            rows += [ln.split(",") for ln in open(os.path.join(log_dir, f)).read().splitlines()[1:]]
    return rows


@pytest.mark.parametrize("kind", ["linear", "qformer", "xattn"])
def test_run_finetune_on_the_cpu(coco_root, tmp_path, kind):
    """tests/test_finetune_workload.py's checks on the port: the run logs
    train, val and cider rows; the frozen GPT-2 is bit-identical to the seeded
    init and what trains has moved; checkpoints are written."""
    cfg = _cfg(coco_root, tmp_path, kind)
    out = finetune.run_finetune(cfg, device="cpu", policy=FP32_POLICY, num_devices=1)
    assert np.isfinite(out["val_loss"]) and np.isfinite(out["cider"])
    phases = [r[1] for r in _rows(cfg.log_dir)]
    assert phases.count("train") == 3 and phases.count("val") == 2 and phases.count("cider") == 2
    assert out["opt_state"]["step"] == 3
    ckpts = os.listdir(os.path.join(cfg.log_dir, "ckpts"))
    assert "model_final.pt" in ckpts and "model_best.pt" in ckpts
    fresh = gpt2.named_params(finetune.load_pretrained_gpt(cfg.model, None, seed=cfg.seed, device="cpu"))
    got = gpt2.named_params(out["model"])
    if kind == "xattn":
        trainable = gpt2.trainable_mask_xattn(out["model"])
        for n, p in fresh.items():
            assert torch.equal(got[n], p) != trainable[n] or n.endswith("bias"), n
        assert not torch.equal(got["transformer.h.0.cross_gate"], fresh["transformer.h.0.cross_gate"])
        assert torch.equal(got["transformer.h.0.ln_x.weight"], fresh["transformer.h.0.ln_x.weight"])
        assert set(out["opt_state"]["m"]) == {n for n, t in trainable.items() if t}
    else:
        for n, p in fresh.items():
            assert torch.equal(got["gpt." + n], p), n
        b0 = caption.init(cfg.model, cfg.bridge,
                          generator=torch.Generator().manual_seed(cfg.seed + 1))
        for n, p in b0.named_parameters():
            assert not torch.equal(got["bridge." + n], p), n
        assert all(n.startswith("bridge.") for n in out["opt_state"]["m"])


def test_qformer_dropout_is_seeded_by_the_config(coco_root, tmp_path):
    """Two runs from one config take the same dropout draws: same losses."""
    runs = []
    for name in ("a", "b"):
        cfg = dataclasses.replace(_cfg(coco_root, tmp_path / name, "qformer"), val_every=0)
        finetune.run_finetune(cfg, device="cpu", policy=FP32_POLICY, max_steps_override=2)
        runs.append([r[3] for r in _rows(cfg.log_dir) if r[1] == "train"])
    assert runs[0] == runs[1] and len(runs[0]) == 2
    off = dataclasses.replace(_cfg(coco_root, tmp_path / "off", "qformer"), val_every=0)
    off = dataclasses.replace(off, bridge=dataclasses.replace(off.bridge, dropout=0.0))
    finetune.run_finetune(off, device="cpu", policy=FP32_POLICY, max_steps_override=2)
    assert [r[3] for r in _rows(off.log_dir) if r[1] == "train"] != runs[0]


CLI_KW = {
    "linear": (finetune_linear, dict(model=SMALL, bridge=BridgeConfig(kind="linear", **SMALL_BRIDGE))),
    "qformer": (finetune_qformer,
                dict(model=SMALL, bridge=BridgeConfig(kind="qformer", **SMALL_BRIDGE))),
    "xattn": (finetune_xattn, dict(model=SMALL_X)),
}
SHORT = dict(total_batch_size=8 * 32 * 2, val_every=2, val_steps=2, cider_every=2, cider_samples=8,
             cider_max_new_tokens=4)


@pytest.mark.parametrize("kind", ["linear", "qformer", "xattn"])
def test_cli_runs_and_resumes_on_the_cpu(tmp_path, kind):
    """--synthetic --steps 2 --device cpu through each CLI's main, then
    --steps 3 resumes at step 2 from the checkpoints and runs one step."""
    cli, kw = CLI_KW[kind]
    argv = ["--synthetic", "--micro-batch", "8", "--device", "cpu", "--log-dir", str(tmp_path)]
    out = cli.main(argv + ["--steps", "2"], overrides=SHORT, **kw)
    assert out["opt_state"]["step"] == 2 and np.isfinite(out["val_loss"])
    assert out["cfg"].grad_accum_steps(1) == (1 if kind == "xattn" else 2)
    first = {n: p.detach().clone() for n, p in gpt2.named_params(out["model"]).items()}
    out = cli.main(argv + ["--steps", "3"], overrides=SHORT, **kw)
    assert out["opt_state"]["step"] == 3
    steps = [int(r[2]) for r in _rows(str(tmp_path)) if r[1] == "train"]
    assert steps == [0, 1, 2]
    after = gpt2.named_params(out["model"])
    trainable = [n for n in first if not torch.equal(after[n], first[n])]
    assert trainable and all(("bridge." in n) or ("xattn" in n) or ("cross_gate" in n)
                             or ("vis_proj" in n) for n in trainable)


def test_qformer_resume_matches_uninterrupted(tmp_path):
    """With the Q-Former's dropout on, 3 steps straight and 2 steps + a resume
    + 1 step end at the same bridge leaves, bit for bit: micro-batch i of step
    s draws its dropout from seed base + s * accum + i, whatever ran before."""
    cli, kw = CLI_KW["qformer"]
    assert kw["bridge"].dropout > 0
    over = dict(SHORT, cider_every=0)
    argv = ["--synthetic", "--micro-batch", "8", "--device", "cpu"]
    a = cli.main(argv + ["--log-dir", str(tmp_path / "a"), "--steps", "3"], overrides=over, **kw)
    cli.main(argv + ["--log-dir", str(tmp_path / "b"), "--steps", "2"], overrides=over, **kw)
    b = cli.main(argv + ["--log-dir", str(tmp_path / "b"), "--steps", "3"], overrides=over, **kw)
    assert a["opt_state"]["step"] == b["opt_state"]["step"] == 3
    pa, pb = gpt2.named_params(a["model"]), gpt2.named_params(b["model"])
    bridge = [n for n in pa if n.startswith("bridge.")]
    assert bridge and all(pa[n].dtype == torch.float32 for n in bridge)
    for n in bridge:
        assert torch.equal(pa[n], pb[n]), n


def test_xattn_cli_takes_one_epoch_of_steps(tmp_path, monkeypatch):
    """Without --steps the cross-attention CLI runs ceil(n_images / B) steps."""
    seen = {}

    def fake_run(cfg, **kw):
        seen["cfg"], seen["kw"] = cfg, kw
        return {}

    monkeypatch.setattr(finetune, "run_finetune", fake_run)
    finetune_xattn.main(["--synthetic", "--micro-batch", "100", "--device", "cpu",
                         "--log-dir", str(tmp_path)], model=SMALL_X)
    assert seen["cfg"].schedule.max_steps == 3  # 256 synthetic images / 100
    assert seen["kw"]["device"] == "cpu" and seen["kw"]["max_steps_override"] is None
    assert seen["cfg"].bridge.kind == "xattn" and seen["cfg"].grad_accum_steps(1) == 1


def test_refusals(coco_root, tmp_path):
    """No silent CPU: the default device raises without a card; a run of
    one process refuses a data-parallel world of two (num_devices must be
    the number of processes torch.distributed.run started)."""
    cfg = _cfg(coco_root, tmp_path, "linear")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            finetune.run_finetune(cfg)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            finetune_linear.main(["--synthetic", "--steps", "1", "--log-dir", str(tmp_path)],
                                 overrides=SHORT, **CLI_KW["linear"][1])
    with pytest.raises(ValueError, match="2 devices asked for, but the world has 1"):
        finetune.run_finetune(cfg, device="cpu", num_devices=2)


def test_load_pretrained_gpt_merges_a_plain_checkpoint(tmp_path):
    """strict=False: a plain-decoder checkpoint (the port's own format or a
    reference .pt) fills the decoder leaves of the cross-attention model; the
    xattn leaves keep their init."""
    from gpt2_vision_language_tpu_torch.ckpt.checkpoint import save_checkpoint

    plain = gpt2.init(SMALL, generator=torch.Generator().manual_seed(5))
    own = str(tmp_path / "model_final.pt")
    save_checkpoint(own, {"model": plain.state_dict(), "opt_state": {"m": {}, "v": {}, "step": 0}},
                    {"next_step": 1})
    ref = str(tmp_path / "reference.pt")
    torch.save({"model": plain.state_dict(), "step": 7}, ref)
    init = gpt2.named_params(finetune.load_pretrained_gpt(SMALL_X, None, seed=3, device="cpu"))
    for path in (own, ref):
        got = gpt2.named_params(finetune.load_pretrained_gpt(SMALL_X, path, seed=3, device="cpu"))
        for n, p in gpt2.named_params(plain).items():
            assert torch.equal(got[n], p), (path, n)
        for n in got:
            if ".xattn." in n or "vis_proj" in n or "ln_x" in n or "cross_gate" in n:
                assert torch.equal(got[n], init[n]), (path, n)
