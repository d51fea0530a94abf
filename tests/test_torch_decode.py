"""KV-cached decoding of the PyTorch port: greedy tokens against the JAX
Decoder, cached against uncached, the samplers' kept sets, the serving
cast, and the two CLIs on the CPU."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpt2_vision_language_tpu.core import precision as jp
from gpt2_vision_language_tpu.core.config import BridgeConfig as JaxBridgeConfig
from gpt2_vision_language_tpu.core.config import GPTConfig as JaxGPTConfig
from gpt2_vision_language_tpu.infer import decode as jdecode
from gpt2_vision_language_tpu.infer import sampling as jsampling
from gpt2_vision_language_tpu.models import caption as jcaption
from gpt2_vision_language_tpu.models import gpt2 as jgpt2
from gpt2_vision_language_tpu_torch.ckpt.convert import (
    caption_from_jax_params,
    gpt2_from_jax_params,
)
from gpt2_vision_language_tpu_torch.core.config import BridgeConfig, GPTConfig
from gpt2_vision_language_tpu_torch.core.precision import DEFAULT_POLICY, FP32_POLICY
from gpt2_vision_language_tpu_torch.infer import sampling
from gpt2_vision_language_tpu_torch.infer.decode import Decoder, cast_decode_params, generate
from gpt2_vision_language_tpu_torch.models import bridges, caption, gpt2

KW = dict(block_size=64, vocab_size=128, n_layer=2, n_head=2, n_embd=64)
CFG, JCFG = GPTConfig(**KW), JaxGPTConfig(**KW)


@pytest.fixture(scope="module")
def jax_params():
    # scaled up: at init scale greedy decoding only repeats the last prompt
    # token, which would pin little
    return jax.tree.map(lambda a: a * 8.0, jgpt2.init(jax.random.PRNGKey(1), JCFG))


@pytest.fixture(scope="module")
def model(jax_params):
    m = gpt2.GPT2(CFG)
    m.load_state_dict(gpt2_from_jax_params(jax.tree.map(np.asarray, jax_params), CFG))
    return m


def test_greedy_with_visual_prefix_matches_jax(jax_params, model):
    """3-token visual prefix (cache slots, no positions) + a 4-token prompt,
    10 greedy tokens at fp32: the same ids as the JAX Decoder."""
    prefix = np.random.RandomState(0).randn(2, 3, CFG.n_embd).astype(np.float32)
    prompt = np.asarray([[5, 10, 15, 20], [7, 3, 1, 99]])
    jdec = jdecode.Decoder(JCFG, policy=jp.FP32_POLICY, sample_fn=jsampling.greedy)
    want, _ = jdec.generate(jax_params, jnp.asarray(prompt, jnp.int32), 10,
                            jax.random.PRNGKey(0), prefix_embeds=jnp.asarray(prefix))
    dec = Decoder(CFG, policy=FP32_POLICY, sample_fn=sampling.greedy)
    got, cache = dec.generate(model, torch.from_numpy(prompt), 10, None,
                              prefix_embeds=torch.from_numpy(prefix))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert len(set(got.flatten().tolist())) > 5
    assert cache["k"].shape == (2, 2, 2, 3 + 4 + 10, 32)


@pytest.mark.parametrize("policy", [FP32_POLICY, DEFAULT_POLICY], ids=["fp32", "bf16"])
def test_cached_equals_uncached(model, policy):
    """Greedy decode against the reference regime, a full re-forward per
    token (train_gpt2.py:440-449)."""
    prompt = torch.tensor([[5, 10, 15], [7, 3, 1]])
    got = generate(model, CFG, prompt, 8, None, sample_fn=sampling.greedy,
                   policy=policy)
    seq = prompt
    with torch.no_grad():
        for _ in range(8):
            logits, _ = gpt2.apply(model, seq, CFG, policy=policy)
            seq = torch.cat([seq, logits[:, -1].float().argmax(-1, keepdim=True)], 1)
    assert torch.equal(got, seq[:, 3:])


def test_top_k_draws_only_from_top_k():
    logits = torch.from_numpy(np.random.RandomState(1).randn(4, 512).astype(np.float32))
    top = logits.topk(5, dim=-1).indices
    gen = torch.Generator().manual_seed(0)
    draws = torch.stack([sampling.sample_top_k(gen, logits, k=5) for _ in range(200)], 1)
    for row in range(4):
        assert set(draws[row].tolist()) <= set(top[row].tolist())
    assert len(set(draws[0].tolist())) > 1


def test_top_p_draws_only_from_kept_set():
    """Kept set by the reference rule (gpt2_linear/data.py:119-121), in
    float64, on logits whose boundary is far from p."""
    rng = np.random.RandomState(2)
    logits = np.full((3, 256), -4.0, np.float32) + rng.rand(3, 256).astype(np.float32)
    logits[:, :6] = [6.0, 5.5, 5.0, 4.6, 4.2, 3.8]
    p, temp = 0.9, 0.8
    z = logits.astype(np.float64) / temp
    probs = np.exp(z - z.max(1, keepdims=True))
    probs /= probs.sum(1, keepdims=True)
    kept = []
    for row in probs:
        order = np.argsort(-row, kind="stable")
        cum = np.cumsum(row[order])
        excl = np.concatenate([[0.0], cum[:-1]])
        assert np.min(np.abs(excl - p)) > 1e-3  # no boundary ambiguity
        kept.append(set(order[excl <= p].tolist()))
    gen = torch.Generator().manual_seed(1)
    lt = torch.from_numpy(logits)
    draws = torch.stack([sampling.sample_top_p(gen, lt, p=p, temperature=temp)
                         for _ in range(300)], 1)
    for row in range(3):
        assert set(draws[row].tolist()) <= kept[row]
        assert len(set(draws[row].tolist())) > 1
    # the JAX sampler keeps the same set
    jmask = np.asarray(jsampling.top_p_keep_mask(
        jax.nn.softmax(jnp.asarray(logits) / temp, axis=-1), p))
    assert [set(np.nonzero(m)[0].tolist()) for m in jmask] == kept


def _cast_case(kind, jax_params):
    """(JAX params, the port model built from them through ckpt/convert.py, the
    converter that maps a JAX tree of that kind to port names)."""
    if kind == "gpt2":
        return jax_params, lambda t: gpt2_from_jax_params(t, CFG), CFG, None
    if kind == "xattn":
        jcfg, cfg = JCFG.replace(cross_attention=True, img_embd=24), CFG.replace(
            cross_attention=True, img_embd=24)
        params = jgpt2.init(jax.random.PRNGKey(2), jcfg)
        return params, lambda t: gpt2_from_jax_params(t, cfg), cfg, None
    kw = dict(kind=kind, enc_dim=24, n_queries=8, n_layers=2, n_heads=2)
    bcfg = BridgeConfig(**kw)
    params = {"gpt": jax_params,
              "bridge": jcaption.init(jax.random.PRNGKey(3), JCFG, JaxBridgeConfig(**kw))}
    return params, lambda t: caption_from_jax_params(t, CFG, bcfg), CFG, bcfg


@pytest.mark.parametrize("kind", ["gpt2", "xattn", "linear", "qformer"])
def test_cast_decode_params_casts_the_jax_leaves(jax_params, kind):
    """Every parameter gets the dtype of its JAX leaf under
    infer/decode.py:50-59's rule, and the same values after the cast, bit for
    bit, over the plain and the gated cross-attention GPT-2 and both caption
    models (the Q-Former's query_tokens stay fp32); the tie holds."""
    params, convert, cfg, bcfg = _cast_case(kind, jax_params)
    np_params = jax.tree.map(np.asarray, params)
    if bcfg is None:
        model = gpt2.GPT2(cfg)
    else:
        model = caption.CaptionModel(gpt2.GPT2(cfg), bridges.bridge_init(bcfg, cfg.n_embd))
    model.load_state_dict(convert(np_params))
    jcast = jdecode.cast_decode_params(params)
    want = convert(jax.tree.map(np.asarray, jcast))
    is_bf16 = convert(jax.tree.map(
        lambda a: np.full(a.shape, float(a.dtype == jnp.bfloat16), np.float32), jcast))
    cast = cast_decode_params(model)
    got = dict(cast.named_parameters())
    assert set(got) == set(want) - {"lm_head.weight", "gpt.lm_head.weight"}
    for name, p in got.items():
        want_dtype = torch.bfloat16 if bool(is_bf16[name].all()) else torch.float32
        assert p.dtype == want_dtype and bool(is_bf16[name].any()) == (want_dtype == torch.bfloat16), name
        assert torch.equal(p.float(), want[name]), name
    gpt = cast if bcfg is None else cast.gpt
    assert gpt.lm_head.weight is gpt.transformer.wte.weight
    assert next(model.parameters()).dtype == torch.float32  # a copy


def test_sample_cli_on_cpu(capsys):
    from gpt2_vision_language_tpu_torch.cli import sample

    out = sample.main(["--num", "2", "--length", "32", "--device", "cpu"])
    assert out.shape[0] == 2 and 0 <= int(out.min()) and int(out.max()) < 50304
    assert capsys.readouterr().out.count("sample ") == 2


def test_bench_decode_cli_on_cpu(capsys):
    from gpt2_vision_language_tpu_torch.cli import bench_decode

    bench_decode.main(["--batch", "2", "--new", "3", "--iters", "1", "--device", "cpu"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["metric"] == "caption_decode_captions_per_sec_per_chip"
    assert (line["batch"], line["new_tokens"], line["device"]) == (2, 3, "cpu")
    assert line["value"] > 0


def test_bench_decode_uncached_baseline_and_topp_ways(capsys, monkeypatch):
    """--uncached-baseline --topp-ways 8 on a 2-layer config: the keys of the
    JAX tool (cli/bench_decode.py:68-112 there) plus the port's device."""
    from gpt2_vision_language_tpu_torch.cli import bench_decode
    from gpt2_vision_language_tpu_torch.core import config

    monkeypatch.setattr(config, "GPTConfig", lambda: GPTConfig(
        block_size=64, vocab_size=50257, n_layer=2, n_head=2, n_embd=64))
    calls = []
    real = sampling.sample_top_p_fast
    monkeypatch.setattr(sampling, "sample_top_p_fast",
                        lambda *a, **kw: calls.append(kw.get("ways")) or real(*a, **kw))
    out = bench_decode.main(["--device", "cpu", "--batch", "2", "--new", "3", "--iters", "1",
                             "--uncached-baseline", "--topp-ways", "8"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line == out
    assert set(line) == {"metric", "value", "unit", "batch", "new_tokens",
                         "uncached_reference_captions_per_sec", "speedup_vs_uncached", "device"}
    assert line["uncached_reference_captions_per_sec"] > 0 and line["speedup_vs_uncached"] > 0
    assert calls and set(calls) == {8}  # the cached loop samples sort-free at --topp-ways
