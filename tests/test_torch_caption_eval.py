"""The port's caption evaluation: the copied CIDEr scorer against the JAX
package's on fixed strings, evaluate_captions end to end (CIDEr and METEOR)
for a prefix bridge and for the cross-attention decoder, and the KV-cached
decode with a visual memory against the uncached forward."""

import os

import numpy as np
import pytest
import torch

from gpt2_vision_language_tpu.eval import cider as jcider
from gpt2_vision_language_tpu_torch.core.config import BridgeConfig, GPTConfig
from gpt2_vision_language_tpu_torch.core.precision import FP32_POLICY
from gpt2_vision_language_tpu_torch.data.coco import CocoClipTokensDataset, write_synthetic_coco
from gpt2_vision_language_tpu_torch.data.tokenizer import get_tokenizer
from gpt2_vision_language_tpu_torch.eval import caption_eval, cider
from gpt2_vision_language_tpu_torch.infer.decode import Decoder
from gpt2_vision_language_tpu_torch.infer.sampling import greedy
from gpt2_vision_language_tpu_torch.models import bridges, caption, gpt2
from torch_threads import share_cores  # noqa: F401  (autouse)

GTS = {
    0: ["a man riding a wave on a surfboard", "a surfer rides a large wave"],
    1: ["a cat sitting on a red couch", "the cat is on the sofa", "a small cat on a couch"],
    2: ["two dogs play in the water"],
    3: ["a plate of food on a table", "food on a plate"],
}
RES = {0: ["a man riding a wave"], 1: ["a dog sitting on a red couch couch"],
       2: ["two dogs play in the water"], 3: [""]}


def test_cider_equals_the_jax_scorer():
    want, want_each = jcider.CiderScorer().compute_score(GTS, RES)
    got, got_each = cider.CiderScorer().compute_score(GTS, RES)
    assert got == want and list(got_each) == list(want_each) and got > 0
    assert cider.cider_score(GTS, RES) == jcider.cider_score(GTS, RES)
    assert (cider.N_GRAMS, cider.SIGMA) == (jcider.N_GRAMS, jcider.SIGMA)
    # a perfect candidate scores highest, an empty one 0
    assert got_each[2] == max(got_each) and got_each[3] == 0.0


SMALL = GPTConfig(block_size=64, vocab_size=50257, n_layer=2, n_head=2, n_embd=32)
SMALL_X = SMALL.replace(img_embd=24, cross_attention=True)


@pytest.fixture(scope="module")
def val_ds(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("coco"))
    write_synthetic_coco(root, split="val", n_images=12, n_tokens=197, enc_dim=24)
    return CocoClipTokensDataset(os.path.join(root, "clip_feats", "val"),
                                 os.path.join(root, "annotations", "captions_val2017.json"),
                                 get_tokenizer(), 16)


@pytest.mark.parametrize("kind", ["linear", "qformer", "xattn"])
def test_evaluate_captions_runs(val_ds, kind):
    """10 of 12 images in batches of 4 (a ragged last batch), from the shards
    and from a feature bank: one caption each, a finite score, the same
    captions from the same seed either way."""
    g = torch.Generator().manual_seed(0)
    if kind == "xattn":
        model, bcfg, cfg = gpt2.init(SMALL_X, generator=g), None, SMALL_X
    else:
        bcfg = BridgeConfig(kind=kind, enc_dim=24, n_queries=8, n_layers=2, n_heads=2)
        model = caption.CaptionModel(gpt2.init(SMALL, generator=g),
                                     bridges.bridge_init(bcfg, SMALL.n_embd, generator=g))
        cfg = SMALL
    kw = dict(max_samples=10, max_new_tokens=5, batch_size=4, policy=FP32_POLICY, seed=3)
    out = caption_eval.evaluate_captions(model, val_ds, cfg, bcfg, get_tokenizer(), **kw)
    assert set(out) == {"cider", "captions"} and np.isfinite(out["cider"])
    assert sorted(out["captions"]) == list(range(10))
    assert all(isinstance(c, str) for c in out["captions"].values())
    from gpt2_vision_language_tpu_torch.data.coco import build_pooled_feature_bank
    from gpt2_vision_language_tpu_torch.ops.pooling import pool_clip_tokens_to_33
    bank = build_pooled_feature_bank(val_ds, pool_clip_tokens_to_33)
    again = caption_eval.evaluate_captions(model, val_ds, cfg, bcfg, get_tokenizer(),
                                           feature_bank=bank, **kw)
    assert again["captions"] == out["captions"] and again["cider"] == out["cider"]
    # METEOR (eval/meteor.py) beside CIDEr, with its synonym table's provenance
    with_meteor = caption_eval.evaluate_captions(model, val_ds, cfg, bcfg, get_tokenizer(),
                                                 compute_meteor=True, **kw)
    assert with_meteor["captions"] == out["captions"]
    assert 0.0 <= with_meteor["meteor"] <= 1.0
    assert with_meteor["meteor_synonyms"] in ("builtin", "nltk-wordnet")


def test_cached_decode_with_z_equals_the_uncached_forward():
    """Greedy decode through the KV cache with the projected visual memory z
    against re-running the full forward on the growing sequence: the same
    tokens, and next-token logits within 1e-3 (fp32)."""
    cfg = SMALL_X.replace(vocab_size=300)
    model = gpt2.init(cfg, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        for layer in model.transformer.h:  # open the gates: z must matter
            layer.cross_gate.fill_(0.7)
    rng = np.random.RandomState(0)
    ids = torch.from_numpy(rng.randint(0, 300, (3, 5)))
    z = torch.from_numpy(rng.randn(3, 33, 24).astype(np.float32))
    zp = gpt2.project_visual(model, z, cfg, torch.float32, policy=FP32_POLICY)
    dec = Decoder(cfg, policy=FP32_POLICY, sample_fn=greedy)
    toks, _ = dec.generate(model, ids, 6, None, z=zp)
    seq = ids
    with torch.no_grad():
        for i in range(6):
            logits, _ = gpt2.apply(model, seq, cfg, z=z, policy=FP32_POLICY)
            nxt = logits[:, -1].argmax(-1)
            assert torch.equal(nxt, toks[:, i]), i
            seq = torch.cat([seq, nxt[:, None]], dim=1)
        # the logits themselves, cached against uncached, at the last position
        cache = gpt2.init_cache(cfg, 3, seq.shape[1], torch.float32)
        emb = gpt2.embed_tokens(model, seq, cfg)
        gpt2.forward_cached(model, emb[:, :-1], cfg, cache, 0, z=zp, policy=FP32_POLICY)
        cached, _ = gpt2.forward_cached(model, emb[:, -1:], cfg, cache, seq.shape[1] - 1, z=zp,
                                        policy=FP32_POLICY)
        full, _ = gpt2.apply(model, seq, cfg, z=z, policy=FP32_POLICY)
        no_z, _ = gpt2.apply(model, seq, cfg, policy=FP32_POLICY)
    assert float((cached[:, -1] - full[:, -1]).abs().max()) <= 1e-3
    assert float((no_z[:, -1] - full[:, -1]).abs().max()) > 1e-3


def test_generate_captions_prefix_equals_the_uncached_forward():
    """The prefix bridges: greedy tokens from the cached decoder equal those of
    caption.apply re-run on the growing text."""
    bcfg = BridgeConfig(kind="qformer", enc_dim=24, n_queries=8, n_layers=2, n_heads=2)
    cfg = SMALL.replace(vocab_size=300)
    g = torch.Generator().manual_seed(2)
    model = caption.CaptionModel(gpt2.init(cfg, generator=g),
                                 bridges.bridge_init(bcfg, cfg.n_embd, generator=g))
    rng = np.random.RandomState(1)
    ids = torch.from_numpy(rng.randint(0, 300, (2, 4)))
    z = torch.from_numpy(rng.randn(2, 33, 24).astype(np.float32))
    toks = caption.generate_captions(model, z, ids, cfg, bcfg, None, max_new_tokens=5,
                                     policy=FP32_POLICY,
                                     decoder=Decoder(cfg, policy=FP32_POLICY, sample_fn=greedy))
    seq = ids
    with torch.no_grad():
        for i in range(5):
            logits, _ = caption.apply(model, z, seq, cfg, bcfg, policy=FP32_POLICY)
            nxt = logits[:, -1].argmax(-1)
            assert torch.equal(nxt, toks[:, i]), i
            seq = torch.cat([seq, nxt[:, None]], dim=1)
