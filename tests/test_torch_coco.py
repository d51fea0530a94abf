"""The port's copy of the COCO data module against the JAX package's on one
synthetic dataset: files, caption encoding, batcher draws and the pooled
feature bank bit for bit; shards written by one package read by the other."""

import filecmp
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpt2_vision_language_tpu.data import coco as jcoco
from gpt2_vision_language_tpu.data.pipeline import HostPrefetcher as JaxPrefetcher
from gpt2_vision_language_tpu.data.tokenizer import get_tokenizer as jax_tokenizer
from gpt2_vision_language_tpu.ops.pooling import pool_clip_tokens_to_33 as jax_pool
from gpt2_vision_language_tpu_torch.data import coco
from gpt2_vision_language_tpu_torch.data.pipeline import HostPrefetcher
from gpt2_vision_language_tpu_torch.data.tokenizer import get_tokenizer
from gpt2_vision_language_tpu_torch.ops.pooling import pool_clip_tokens_to_33


@pytest.fixture(scope="module")
def roots(tmp_path_factory):
    """One synthetic dataset from each package's writer (same seed)."""
    out = {}
    for name, mod in (("jax", jcoco), ("port", coco)):
        root = str(tmp_path_factory.mktemp(f"coco_{name}"))
        mod.write_synthetic_coco(root, split="train", n_images=70, n_tokens=197, enc_dim=24)
        mod.write_synthetic_coco(root, split="val", n_images=20, n_tokens=197, enc_dim=24, seed=1)
        out[name] = root
    return out


def _ds(mod, root, split, tok, seed=0):
    return mod.CocoClipTokensDataset(
        os.path.join(root, "clip_feats", split),
        os.path.join(root, "annotations", f"captions_{split}2017.json"), tok, 16, seed=seed)


def test_synthetic_files_are_identical(roots):
    cmp = filecmp.dircmp(roots["jax"], roots["port"])

    def walk(c):
        assert not c.left_only and not c.right_only and not c.diff_files, (c.left, c.diff_files)
        for name in c.common_files:
            assert filecmp.cmp(os.path.join(c.left, name), os.path.join(c.right, name),
                               shallow=False), name
        for sub in c.subdirs.values():
            walk(sub)

    walk(cmp)
    assert len(os.listdir(os.path.join(roots["port"], "clip_feats", "train"))) == 4  # 3 shards + index


def test_encode_caption_and_index_match(roots):
    jt, pt = jax_tokenizer(), get_tokenizer()
    for text in ("a red cat sitting", "", "x " * 40):
        for a, b in zip(jcoco.encode_caption(text, jt, 16), coco.encode_caption(text, pt, 16)):
            assert a.dtype == b.dtype and np.array_equal(a, b)
    ji = jcoco.CocoCaptionsIndex(os.path.join(roots["jax"], "annotations", "captions_val2017.json"))
    pi = coco.CocoCaptionsIndex(os.path.join(roots["port"], "annotations", "captions_val2017.json"))
    assert ji.ids == pi.ids and ji.captions == pi.captions and len(pi) == 20


@pytest.mark.parametrize("split, shuffle, drop_last, rank, world", [
    ("train", True, True, 0, 1),     # the train batcher: epoch shuffles across 3 epochs
    ("val", False, False, 0, 1),     # the val batcher: the tail wraps (20 rows, B=8)
    ("train", True, True, 1, 2),     # a rank-strided batcher
])
def test_batcher_draws_are_bit_equal(roots, split, shuffle, drop_last, rank, world):
    """Each package's batcher on the OTHER package's files: same seeds, same
    caption draws, same epoch shuffles, through index and streaming modes."""
    kw = dict(shuffle=shuffle, drop_last=drop_last, seed=7, rank=rank, world=world)
    j = jcoco.CocoBatcher(_ds(jcoco, roots["port"], split, jax_tokenizer(), 3), 8, **kw)
    p = coco.CocoBatcher(_ds(coco, roots["jax"], split, get_tokenizer(), 3), 8, **kw)
    assert p.steps_per_epoch() == j.steps_per_epoch()
    for _ in range(14):
        for a, b in zip(j.next_index_batch(), p.next_index_batch()):
            assert a.dtype == b.dtype and np.array_equal(a, b)
    for a, b in zip(j.next_accum_index_batch(3), p.next_accum_index_batch(3)):
        assert a.shape == b.shape and np.array_equal(a, b)
    for a, b in zip(j.next_batch(), p.next_batch()):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    j.reset()
    p.reset()
    for a, b in zip(j.next_accum_index_batch(4), p.next_accum_index_batch(4)):
        assert np.array_equal(a, b)


def test_val_window_wraps_and_repeats(roots):
    """20 val rows, B=8, 4 micro-batches: the window wraps into the next epoch
    and a reset() gives the same window again."""
    vb = coco.CocoBatcher(_ds(coco, roots["port"], "val", get_tokenizer()), 8,
                          shuffle=False, drop_last=False, seed=1)
    first = vb.next_accum_index_batch(4)
    assert first[3].shape == (4, 8) and first[3].reshape(-1)[20] == 0  # wrapped
    vb.reset()
    for a, b in zip(first, vb.next_accum_index_batch(4)):
        assert np.array_equal(a, b)


def test_skip_batches_equals_drawing_them(roots):
    a = coco.CocoBatcher(_ds(coco, roots["port"], "train", get_tokenizer()), 8, seed=2)
    b = coco.CocoBatcher(_ds(coco, roots["port"], "train", get_tokenizer()), 8, seed=2)
    for _ in range(11):
        a.next_index_batch()
    b.skip_batches(11)
    for x, y in zip(a.next_index_batch(), b.next_index_batch()):
        assert np.array_equal(x, y)


def test_pooled_bank_is_bit_equal_and_in_dataset_order(roots):
    jds = _ds(jcoco, roots["jax"], "train", jax_tokenizer())
    pds = _ds(coco, roots["jax"], "train", get_tokenizer())
    want = np.asarray(jcoco.build_pooled_feature_bank(jds, jax_pool, chunk=16))
    got = coco.build_pooled_feature_bank(pds, pool_clip_tokens_to_33, chunk=16)
    assert isinstance(got, torch.Tensor) and tuple(got.shape) == (70, 33, 24)
    # fp32 pooling on both sides: sums in another order only (1e-6, as the
    # pooling test); the rows are the same rows
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)
    # with the pooling taken out the bank is bit-equal
    ident_j = np.asarray(jcoco.build_pooled_feature_bank(jds, lambda z: z[:, :3], chunk=16))
    ident_p = coco.build_pooled_feature_bank(pds, lambda z: z[:, :3], chunk=16)
    assert np.array_equal(ident_p.numpy(), ident_j)
    # the reorder: a reversed index must still come back in dataset order
    pds.index = list(reversed(pds.index))
    bank = coco.build_pooled_feature_bank(pds, lambda z: z[:, :5], chunk=16)
    for i in (0, 7, 33, 69):
        np.testing.assert_array_equal(bank[i].numpy(), pds.features(i)[:5])
    bf16 = coco.build_pooled_feature_bank(pds, pool_clip_tokens_to_33, dtype=torch.bfloat16)
    assert bf16.dtype == torch.bfloat16


def test_shards_written_by_one_package_read_by_the_other(tmp_path):
    feats = np.random.RandomState(0).randn(10, 5, 8).astype(np.float32)
    coco.write_clip_feature_shards(str(tmp_path / "p"), feats, rows_per_shard=4)
    jcoco.write_clip_feature_shards(str(tmp_path / "j"), feats, rows_per_shard=4)
    for name in sorted(os.listdir(tmp_path / "p")):
        assert filecmp.cmp(tmp_path / "p" / name, tmp_path / "j" / name, shallow=False), name
    assert np.array_equal(np.asarray(jcoco._load_shard(str(tmp_path / "p" / "clip_tokens_00001.npy"))),
                          np.asarray(coco._load_shard(str(tmp_path / "j" / "clip_tokens_00001.npy"))))


@pytest.mark.parametrize("cls", [HostPrefetcher, JaxPrefetcher])
def test_host_prefetcher_copy(cls):
    """The copied prefetcher: order kept, stage applied, errors surfaced."""
    it = iter(range(100))
    pf = cls(lambda: next(it), stage=lambda v: v * 2)
    assert [pf.next() for _ in range(5)] == [0, 2, 4, 6, 8]
    pf.close()

    def boom():
        raise ValueError("producer failed")

    pf = cls(boom)
    with pytest.raises(ValueError, match="producer failed"):
        pf.next()
    pf.close()
