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
from gpt2_vision_language_tpu.core.config import GPTConfig as JaxGPTConfig
from gpt2_vision_language_tpu.infer import decode as jdecode
from gpt2_vision_language_tpu.infer import sampling as jsampling
from gpt2_vision_language_tpu.models import gpt2 as jgpt2
from gpt2_vision_language_tpu_torch.ckpt.convert import _BLOCK_LEAVES, gpt2_from_jax_params
from gpt2_vision_language_tpu_torch.core.config import GPTConfig
from gpt2_vision_language_tpu_torch.core.precision import DEFAULT_POLICY, FP32_POLICY
from gpt2_vision_language_tpu_torch.infer import sampling
from gpt2_vision_language_tpu_torch.infer.decode import Decoder, cast_decode_params, generate
from gpt2_vision_language_tpu_torch.models import gpt2

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


def test_cast_decode_params_casts_the_jax_leaves(jax_params, model):
    """The same leaves as infer/decode.py:50-59 go to bf16; the tie holds."""
    jcast = jdecode.cast_decode_params(jax_params)
    want = {"transformer.wte.weight": jcast["wte"].dtype == jnp.bfloat16,
            "transformer.wpe.weight": jcast["wpe"].dtype == jnp.bfloat16,
            "transformer.ln_f.weight": jcast["lnf"]["scale"].dtype == jnp.bfloat16,
            "transformer.ln_f.bias": jcast["lnf"]["bias"].dtype == jnp.bfloat16}
    for i in range(CFG.n_layer):
        for group, leaf, name, _ in _BLOCK_LEAVES:
            want[f"transformer.h.{i}.{name}"] = (
                jcast["blocks"][group][leaf].dtype == jnp.bfloat16)
    cast = cast_decode_params(model)
    got = {k: v.dtype == torch.bfloat16 for k, v in cast.state_dict().items()
           if k != "lm_head.weight"}
    assert got == want
    assert cast.lm_head.weight is cast.transformer.wte.weight
    assert model.transformer.wte.weight.dtype == torch.float32  # a copy


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
