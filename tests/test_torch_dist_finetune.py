"""The port's caption fine-tunes data-parallel over two gloo processes against
the one-process run at the same global batch, for each bridge: the masked
mean counts the whole global micro-batch's caption tokens, the grads are
summed once a step, and the Q-Former's dropout masks are the global
micro-batch's, each rank keeping its rows."""

import os

import numpy as np
import pytest

from gpt2_vision_language_tpu_torch.data.coco import write_synthetic_coco
from torch_dist import run_ranks
from torch_threads import share_cores  # noqa: F401  (autouse)

SMALL = dict(block_size=64, vocab_size=50257, n_layer=2, n_head=2, n_embd=32)
SMALL_X = dict(SMALL, img_embd=24, cross_attention=True)
# the Q-Former's dropout stays at its default 0.1: the runs must draw alike
BRIDGE = dict(enc_dim=24, n_queries=8, n_layers=2, n_heads=2)
B_RANK = 2


@pytest.fixture(scope="module")
def coco_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("coco"))
    write_synthetic_coco(root, split="train", n_images=32, n_tokens=197, enc_dim=24)
    write_synthetic_coco(root, split="val", n_images=16, n_tokens=197, enc_dim=24)
    return root


def _job(coco_root, log_dir, kind, micro, tag):
    return {"kind": "finetune", "tag": tag, "policy": "fp32",
            "model": SMALL_X if kind == "xattn" else SMALL,
            "finetune": {"bridge": dict(BRIDGE, kind=kind), "micro_batch_size": micro,
                         "seq_len": 16, "total_batch_size": 2 * B_RANK * 16 * 2,
                         "grad_accum_override": 1 if kind == "xattn" else None,
                         "schedule": dict(max_lr=1e-3, min_lr=1e-4, warmup_steps=1, max_steps=3),
                         "optimizer": {"eps": 1e-6}, "val_every": 2, "val_steps": 2,
                         "cider_samples": 4, "cider_max_new_tokens": 4, "save_every": 100,
                         "coco_root": coco_root,
                         "clip_feats_dir": os.path.join(coco_root, "clip_feats"),
                         "log_dir": str(log_dir)}}


def _losses(log_dir, phase):
    out = {}
    for f in sorted(os.listdir(log_dir)):
        if f.endswith(".csv"):
            for line in open(os.path.join(log_dir, f)).read().splitlines()[1:]:
                parts = line.split(",")
                if parts[1] == phase:
                    out[int(parts[2])] = float(parts[3])
    return out


@pytest.mark.parametrize("kind", ["linear", "qformer", "xattn"])
def test_two_process_finetune_matches_one_process(coco_root, tmp_path, kind):
    """3 steps on 2 processes of B=2 against one process of B=4: the train
    and val losses within 1e-5, the trained leaves' sums within 1e-5, the
    frozen ones and the ranks' states equal, CIDEr scored on every rank."""
    two = run_ranks(dict(_job(coco_root, tmp_path / "two", kind, B_RANK, "two"), devices=2), 2,
                    tmp_path)
    one = run_ranks(_job(coco_root, tmp_path / "one", kind, 2 * B_RANK, "one"), 1, tmp_path)[0]
    assert two[0]["param_sums"] == two[1]["param_sums"]
    assert two[0]["step"] == one["step"] == 3
    assert all(np.isfinite(r["cider"]) for r in two)
    for phase in ("train", "val"):
        got, want = _losses(tmp_path / "two", phase), _losses(tmp_path / "one", phase)
        assert set(got) == set(want) and got
        for s in want:
            np.testing.assert_allclose(got[s], want[s], rtol=1e-5, err_msg=f"{phase} {s}")
    np.testing.assert_allclose(two[0]["val_loss"], one["val_loss"], rtol=1e-5)
    for n, sums in one["param_sums"].items():
        np.testing.assert_allclose(two[0]["param_sums"][n], sums, rtol=1e-5, atol=1e-6,
                                   err_msg=n)
    assert [f for f in os.listdir(tmp_path / "two") if f.endswith(".csv")]  # the master's
