"""The port's cli.extract_clip_features against the JAX package's on the
same JPEGs and the same HF weights: index.json equal, the float16 rows within
a stated tolerance; then the port alone: shards read back through
data/coco.CocoClipTokensDataset equal to ``features`` of the same crops,
and the device check."""

import json
import os

import numpy as np
import pytest
import torch

from gpt2_vision_language_tpu_torch.cli import extract_clip_features as ex
from gpt2_vision_language_tpu_torch.core.config import CLIP_TINY
from gpt2_vision_language_tpu_torch.data.coco import CocoClipTokensDataset
from gpt2_vision_language_tpu_torch.data.tokenizer import ByteFallbackTokenizer
from gpt2_vision_language_tpu_torch.models import clip_vit
from torch_threads import share_cores  # noqa: F401  (autouse)


def _make_fake_coco(root, n=10):
    """The JAX test's layout: n JPEGs of 40 x 52 from a numpy seed."""
    from PIL import Image

    os.makedirs(os.path.join(root, "annotations"), exist_ok=True)
    os.makedirs(os.path.join(root, "val2017"), exist_ok=True)
    images, anns = [], []
    rng = np.random.RandomState(0)
    for i in range(n):
        img_id = 500 + i
        fname = f"{img_id:012d}.jpg"
        Image.fromarray(rng.randint(0, 255, (40, 52, 3), dtype=np.uint8)).save(
            os.path.join(root, "val2017", fname))
        images.append({"id": img_id, "file_name": fname})
        anns.append({"image_id": img_id, "id": i, "caption": f"image number {i}"})
    with open(os.path.join(root, "annotations", "captions_val2017.json"), "w") as f:
        json.dump({"images": images, "annotations": anns}, f)
    return os.path.join(root, "annotations", "captions_val2017.json")


ARGS = ["--split", "val", "--variant", "tiny", "--batch", "4", "--rows-per-shard", "3"]


def _shards(out):
    return sorted(f for f in os.listdir(out) if f.endswith(".npy"))


def test_rows_and_index_match_the_jax_cli(tmp_path):
    """Both CLIs on the same JPEGs with the same tiny HF CLIPVisionModel
    directory (the JAX CLI reads it through transformers, the port's without):
    index.json and the shard names equal; every float16 row within 2^-6 of
    max|ref| and 2^-9 on average (both encode in bf16; an fp32 accumulation
    that ends one ulp apart flips a bf16 rounding now and then)."""
    transformers = pytest.importorskip("transformers")
    from gpt2_vision_language_tpu.cli import extract_clip_features as jex

    root = str(tmp_path / "coco")
    _make_fake_coco(root)
    hf_cfg = transformers.CLIPVisionConfig(
        hidden_size=32, num_hidden_layers=2, num_attention_heads=2, intermediate_size=128,
        image_size=32, patch_size=16, hidden_act="quick_gelu")
    torch.manual_seed(0)
    transformers.CLIPVisionModel(hf_cfg).save_pretrained(str(tmp_path / "clip"))
    hf = ["--hf-ckpt", str(tmp_path / "clip")]
    jout, pout = str(tmp_path / "jax"), str(tmp_path / "port")
    jex.main(["--coco-root", root, "--out", jout] + ARGS + hf)
    res = ex.main(["--coco-root", root, "--out", pout, "--device", "cpu"] + ARGS + hf)
    assert res == {"out": pout, "shards": 4, "rows": 10}
    with open(os.path.join(jout, "index.json")) as f, open(os.path.join(pout, "index.json")) as g:
        assert json.load(g) == json.load(f)
    assert _shards(pout) == _shards(jout) == [f"clip_tokens_{i:05d}.npy" for i in range(4)]
    want = np.concatenate([np.load(os.path.join(jout, s)) for s in _shards(jout)])
    got = np.concatenate([np.load(os.path.join(pout, s)) for s in _shards(pout)])
    assert got.dtype == want.dtype == np.float16 and got.shape == want.shape == (10, 5, 32)
    err, scale = np.abs(got.astype(np.float32) - want), np.abs(want.astype(np.float32)).max()
    assert err.max() <= 2.0 ** -6 * scale, (err.max(), scale)
    assert err.mean() <= 2.0 ** -9 * scale, (err.mean(), scale)


def test_extract_and_consume(tmp_path):
    """The JAX test's run (random init): 10 images in shards of 3 (3+3+3+1)
    that the dataset reads; each row equal to ``features`` of the same crop
    (load_batch, bf16 policy) cast to float16; without a card the default
    device raises."""
    root = str(tmp_path / "coco")
    ann = _make_fake_coco(root)
    out = str(tmp_path / "feats" / "val")
    ex.main(["--coco-root", root, "--out", out, "--device", "cpu"] + ARGS)
    with open(os.path.join(out, "index.json")) as f:
        assert len(json.load(f)) == 10
    assert len(_shards(out)) == 4
    ds = CocoClipTokensDataset(out, ann, ByteFallbackTokenizer(), max_len=16)
    x, y, m, z = ds[7]
    assert z.shape == (5, 32) and x.shape == (15,)

    paths = [os.path.join(root, "val2017", f"{500 + i:012d}.jpg") for i in range(10)]
    crops = ex.load_batch(paths, CLIP_TINY.image_size)
    model = ex.load_encoder(CLIP_TINY, None, torch.device("cpu"), warning="")
    with torch.no_grad():
        want = clip_vit.features(model, clip_vit.normalize_only(torch.from_numpy(crops)),
                                 CLIP_TINY).to(torch.float16).numpy()
    got = np.stack([ds.features(i) for i in range(10)])
    np.testing.assert_array_equal(got, want)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="--device cpu"):
            ex.main(["--coco-root", root, "--out", out] + ARGS)
