"""HellaSwag in the PyTorch port against the JAX package: the renderer, the
row scorer, and the bucketed evaluator (correct, total, skipped) on a seeded
synthetic jsonl with the JAX weights carried across by ckpt/convert."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpt2_vision_language_tpu.core import precision as jp
from gpt2_vision_language_tpu.core.config import GPTConfig as JaxGPTConfig
from gpt2_vision_language_tpu.data.tokenizer import ByteFallbackTokenizer as JaxTokenizer
from gpt2_vision_language_tpu.eval import hellaswag as jhs
from gpt2_vision_language_tpu.models import gpt2 as jgpt2
from gpt2_vision_language_tpu_torch.ckpt.convert import gpt2_from_jax_params
from gpt2_vision_language_tpu_torch.core.config import GPTConfig
from gpt2_vision_language_tpu_torch.core.precision import FP32_POLICY
from gpt2_vision_language_tpu_torch.data.tokenizer import ByteFallbackTokenizer
from gpt2_vision_language_tpu_torch.eval import hellaswag as hs
from gpt2_vision_language_tpu_torch.models import gpt2

KW = dict(block_size=160, vocab_size=300, n_layer=2, n_head=2, n_embd=64)
CFG, JCFG = GPTConfig(**KW), JaxGPTConfig(**KW)
WORDS = "the a cat dog runs sleeps quickly under over bridge river and then stops".split()


def _write_dataset(path, n, seed):
    """n seeded examples of varied length; every seventh context is longer
    than the evaluator's max_len and must be skipped."""
    rng = np.random.RandomState(seed)
    phrase = lambda k: " ".join(rng.choice(WORDS, size=k))  # noqa: E731
    with open(path, "w") as f:
        for i in range(n):
            ctx = phrase(60 if i % 7 == 6 else int(rng.randint(2, 14)))
            ex = {"ctx": ctx, "label": int(rng.randint(4)),
                  "endings": [phrase(int(rng.randint(1, 6))) for _ in range(4)]}
            f.write(json.dumps(ex) + "\n\n")  # blank lines are ignored


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    d = tmp_path_factory.mktemp("hellaswag")
    _write_dataset(d / "hellaswag_val.jsonl", 23, seed=0)
    return str(d)


@pytest.fixture(scope="module")
def models():
    params = jgpt2.init(jax.random.PRNGKey(0), JCFG)
    model = gpt2.GPT2(CFG)
    model.load_state_dict(gpt2_from_jax_params(jax.tree.map(np.asarray, params), CFG))
    return params, model.eval()


def test_iterate_and_render_match_jax(dataset):
    a = list(jhs.iterate_examples("val", dataset))
    b = list(hs.iterate_examples("val", dataset))
    assert a == b and len(b) == 23
    for ex in b:
        want = jhs.render_example(ex, JaxTokenizer())
        got = hs.render_example(ex, ByteFallbackTokenizer())
        assert got[2] == want[2]
        for x, y in zip(got[:2], want[:2]):
            assert x.dtype == y.dtype and np.array_equal(x, y)
    tokens, mask, label = hs.render_example(
        {"ctx": "ab", "endings": ["c", "de", "f", "ghi"], "label": 2}, ByteFallbackTokenizer())
    assert tokens.shape == (4, 6) and label == 2
    assert mask.sum(1).tolist() == [2, 3, 2, 4] and not mask[:, :2].any()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_most_likely_row_matches_jax(seed):
    rng = np.random.RandomState(seed)
    tokens = rng.randint(0, 50, (4, 12)).astype(np.int32)
    mask = np.zeros((4, 12), bool)
    for i, (a, b) in enumerate(((3, 9), (3, 12), (3, 5), (3, 7))):
        mask[i, a:b] = True
    logits = rng.randn(4, 12, 50).astype(np.float32)
    want = int(jhs.most_likely_row(*map(jnp.asarray, (tokens, mask, logits))))
    got = hs.most_likely_row(*map(torch.from_numpy, (tokens, mask, logits)))
    assert int(got) == want
    # batched over a leading axis, and on bf16 logits, as the evaluator calls it
    stack = lambda a: torch.from_numpy(np.stack([a, a[::-1].copy()]))  # noqa: E731
    both = hs.most_likely_row(stack(tokens), stack(mask), stack(logits))
    assert both.tolist() == [want, 3 - want]
    wb = int(jhs.most_likely_row(jnp.asarray(tokens), jnp.asarray(mask),
                                 jnp.asarray(logits).astype(jnp.bfloat16)))
    gb = hs.most_likely_row(torch.from_numpy(tokens), torch.from_numpy(mask),
                            torch.from_numpy(logits).bfloat16())
    assert int(gb) == wb


def test_most_likely_row_picks_highest_likelihood():
    tokens = np.zeros((4, 6), np.int64)
    tokens[1, :] = [1, 2, 3, 4, 5, 6]
    mask = np.zeros((4, 6), bool)
    mask[:, 2:] = True
    logits = np.full((4, 6, 16), -5.0, np.float32)
    for t in range(5):
        logits[1, t, tokens[1, t + 1]] = 10.0  # row 1 predicts itself
    assert int(hs.most_likely_row(*map(torch.from_numpy, (tokens, mask, logits)))) == 1


@pytest.mark.parametrize("rank, world, limit", [(0, 1, None), (0, 2, None), (1, 2, None),
                                                (0, 1, 10)])
def test_evaluator_matches_jax(dataset, models, rank, world, limit):
    """fp32 policy, max_len 96, 4 examples a batch: (correct, total, skipped)
    equal the JAX evaluator's, per rank and with a limit; with world_size 2
    both run their lock-step dummy flushes at the fixed width."""
    params, model = models
    kw = dict(max_len=96, batch_examples=4)
    jev = jhs.HellaSwagEvaluator(JCFG, policy=jp.FP32_POLICY, **kw)
    ev = hs.HellaSwagEvaluator(CFG, policy=FP32_POLICY, **kw)
    assert ev.buckets == jev.buckets == [64, 96]
    ekw = dict(data_dir=dataset, rank=rank, world_size=world, limit=limit)
    want = jev.evaluate(params, JaxTokenizer(), **ekw)
    widths = []
    predict = ev._predict
    ev._predict = lambda m, t, k: widths.append(t.shape) or predict(m, t, k)
    got = ev.evaluate(model, ByteFallbackTokenizer(), **ekw)
    assert got == want and ev.skipped_too_long == jev.skipped_too_long
    assert got[1] + ev.skipped_too_long == len(range(rank, limit or 23, world))
    if world == 1 and limit is None:
        assert ev.skipped_too_long == 3 and got[1] == 20
        assert {w[2] for w in widths} <= {64, 96} and all(w[:2] == (4, 4) for w in widths)
    if world == 2:
        # ceil(ceil(23 / 2) / 4) = 3 flushes on every rank, all at max_len
        assert widths == [(4, 4, 96)] * 3


def test_predictions_match_jax_per_batch(dataset, models):
    """One padded batch through both _predict paths: the same candidates."""
    params, model = models
    exs = [e for e in hs.iterate_examples("val", dataset)][:6]
    tok = ByteFallbackTokenizer()
    tokens = np.zeros((6, 4, 96), np.int32)
    mask = np.zeros((6, 4, 96), bool)
    for i, ex in enumerate(exs):
        t, m, _ = hs.render_example(ex, tok)
        tokens[i, :, : t.shape[1]] = t
        mask[i, :, : t.shape[1]] = m
    jev = jhs.HellaSwagEvaluator(JCFG, policy=jp.FP32_POLICY, batch_examples=6)
    ev = hs.HellaSwagEvaluator(CFG, policy=FP32_POLICY, batch_examples=6)
    want = np.asarray(jev._predict(params, tokens, mask))
    got = ev._predict(model, tokens, mask)
    assert got.tolist() == want.tolist()
    assert not any(p.grad is not None for p in model.parameters())
