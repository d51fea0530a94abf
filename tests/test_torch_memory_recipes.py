"""The big-model memory recipes of the PyTorch port's optimizer state
against the JAX package: 8-bit moments (bit-equal quantizer, the JAX leaf
grouping and eligibility, two AdamW steps from one state), bf16 moments and
bf16 params, moment conversion, checkpoints, the AdamW kernel's leaf gate,
utils/trees and the CLI's flags. Mirrors tests/test_optimizer_q8.py; the
train step's recipes are in tests/test_torch_recipe_steps.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gpt2_vision_language_tpu.train.optimizer as jopt
from gpt2_vision_language_tpu.core import config as jcfg
from gpt2_vision_language_tpu.models import gpt2 as jgpt2
from gpt2_vision_language_tpu.ops.fused_adamw import leaf_supports_fused
from gpt2_vision_language_tpu.utils import trees as jtrees
from gpt2_vision_language_tpu_torch import utils as ptrees
from gpt2_vision_language_tpu_torch.ckpt.convert import gpt2_from_jax_params, opt_state_from_jax
from gpt2_vision_language_tpu_torch.core.config import GPTConfig, OptimizerConfig
from gpt2_vision_language_tpu_torch.models import gpt2
from gpt2_vision_language_tpu_torch.train import optimizer as popt
from torch_threads import share_cores  # noqa: F401  (autouse)

ARCH = dict(block_size=32, vocab_size=128, n_layer=2, n_head=2, n_embd=64)
JCFG, PCFG = jcfg.GPTConfig(**ARCH), GPTConfig(**ARCH)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _port_model(jparams, dtype=torch.float32):
    model = gpt2.GPT2(PCFG)
    model.load_state_dict(gpt2_from_jax_params(_np(jparams), PCFG))
    return model.to(dtype)


def _port_grads(jgrads):
    g = gpt2_from_jax_params(_np(jgrads), PCFG)
    del g["lm_head.weight"]
    return g


def _small_q8(monkeypatch, min_size=64):
    """Q8_MIN_SIZE lowered on both sides, so that the stacked LayerNorm and
    bias leaves ((2, 64)) qualify as they do at 1558M; their per-layer
    tensors (64,) alone would not."""
    monkeypatch.setattr(jopt, "Q8_MIN_SIZE", min_size)
    monkeypatch.setattr(popt, "Q8_MIN_SIZE", min_size)


# ---------------------------------------------------------------------------
# 8-bit quantizer and layout
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("unsigned", [False, True], ids=["signed", "unsigned"])
@pytest.mark.parametrize("shape", [(4, 256), (7, 333), (3,)], ids=["blocks", "padded", "tiny"])
def test_q8_quantize_bit_equal_with_jax(shape, unsigned):
    """Codes and scales bit for bit, a padded tail included; the dequantized
    values too."""
    rng = np.random.RandomState(0)
    x = (rng.randn(*shape) * np.exp(rng.randn(*shape))).astype(np.float32)
    if unsigned:
        x = np.abs(x)
    x.reshape(-1)[:5] = 0.0
    want = jopt.q8_quantize(jnp.asarray(x), unsigned=unsigned)
    got = popt.q8_quantize(torch.from_numpy(x), unsigned=unsigned)
    assert got["q"].dtype == (torch.uint8 if unsigned else torch.int8)
    np.testing.assert_array_equal(got["q"].numpy(), np.asarray(want["q"]))
    np.testing.assert_array_equal(got["s"].numpy(), np.asarray(want["s"]))
    np.testing.assert_array_equal(popt.q8_dequantize(got, shape).numpy(),
                                  np.asarray(jopt.q8_dequantize(want, shape)))


def test_q8_grouped_and_eligible_by_jax_leaf(monkeypatch):
    """adamw_init(int8) gives 8-bit moments to exactly the JAX leaves that
    the JAX adamw_init quantizes, each one entry of the JAX leaf's padded
    size keyed by its path; the rest are fp32 tensors by name."""
    _small_q8(monkeypatch)
    jparams = jgpt2.init(jax.random.PRNGKey(0), JCFG)
    jstate = jopt.adamw_init(jparams, state_dtype=jnp.int8)
    want = {"/".join(str(k.key) for k in path[:-1]): leaf.shape
            for path, leaf in jax.tree_util.tree_leaves_with_path(jstate["m"])
            if path[-1].key == "q"}
    assert "blocks/ln1/scale" in want and "blocks/attn/bqkv" in want and "lnf/scale" not in want
    model = _port_model(jparams)
    params = gpt2.named_params(model)
    state = popt.adamw_init(params, state_dtype="int8")
    got = {k: tuple(v["q"].shape) for k, v in state["m"].items() if isinstance(v, dict)}
    assert got == want
    dense = {k for k, v in state["m"].items() if not isinstance(v, dict)}
    assert dense == {"transformer.ln_f.weight", "transformer.ln_f.bias"}
    assert all(state["m"][n].dtype == torch.float32 for n in dense)
    assert state["v"]["blocks/mlp/wfc"]["q"].dtype == torch.uint8


def test_adamw_kernel_leaves_follow_the_jax_gate():
    """The AdamW kernel takes the port leaves of the JAX leaves that pass
    leaf_supports_fused (fp32, a multiple of 128, at least 1024), whatever
    the size of the port's own per-layer tensor; bf16 moments take none. At
    16 layers of width 64 a LayerNorm leaf is 64 values here and (16, 64) =
    1024 there."""
    cfg16 = dict(ARCH, n_layer=16)
    jparams = jgpt2.init(jax.random.PRNGKey(0), jcfg.GPTConfig(**cfg16))
    model = gpt2.GPT2(GPTConfig(**cfg16))
    params = gpt2.named_params(model)
    fused_paths = {"/".join(str(k.key) for k in path)
                   for path, leaf in jax.tree_util.tree_leaves_with_path(jparams)
                   if leaf_supports_fused(leaf)}
    state = popt.adamw_init(params)
    got = popt.kernel_leaves(params, state)
    want = {n for n in params if popt.jax_leaf_path(n)[0] in fused_paths}
    assert len(got) == len(want) and set(got) == want
    assert "transformer.h.0.ln_1.weight" in got
    assert "transformer.ln_f.weight" not in got
    assert popt.kernel_leaves(params, popt.adamw_init(params, state_dtype="bfloat16")) == []


# ---------------------------------------------------------------------------
# adamw_update with compact storage
# ---------------------------------------------------------------------------


def _rand_grads(jparams, seed):
    rng = np.random.RandomState(seed)
    return jax.tree.map(lambda p: jnp.asarray(rng.randn(*p.shape).astype(np.float32) * 0.1),
                        jparams)


def _check_moments(got, want, shapes):
    """Port moments against the JAX ones in the port's layout: 8-bit ones
    dequantized within one quantization step of their block, bf16 within one
    bf16 rounding, fp32 within 1e-5."""
    for key in ("m", "v"):
        assert set(got[key]) == set(want[key]), key
        for n, w in want[key].items():
            a = got[key][n]
            if isinstance(w, dict):
                step = torch.maximum(a["s"], w["s"]).repeat_interleave(popt.Q8_BLOCK)
                step = step[:int(np.prod(shapes[n]))]
                da = popt.q8_dequantize(a, shapes[n]).reshape(-1)
                dw = popt.q8_dequantize(w, shapes[n]).reshape(-1)
                assert bool(((da - dw).abs() <= step * 1.0001).all()), (key, n)
            elif w.dtype == torch.bfloat16:
                assert a.dtype == torch.bfloat16, (key, n)
                torch.testing.assert_close(a.float(), w.float(), rtol=2.0 ** -7, atol=1e-30)
            else:
                assert a.dtype == torch.float32, (key, n)
                torch.testing.assert_close(a, w, rtol=1e-5, atol=1e-9)


@pytest.mark.parametrize("mode", ["bf16_moments", "int8_moments", "bf16_params"])
def test_adamw_update_compact_state_matches_jax(monkeypatch, mode):
    """A warm JAX state carried over by opt_state_from_jax, then two AdamW
    steps on each side with the same grads (the first clipped): params within
    1e-6, moments within one quantization step (bf16: one rounding; 8 bits:
    one code of the block's scale)."""
    _small_q8(monkeypatch)
    jparams = jgpt2.init(jax.random.PRNGKey(0), JCFG)
    state_dtype = {"bf16_moments": jnp.bfloat16, "int8_moments": jnp.int8}.get(mode)
    pdtype = torch.bfloat16 if mode == "bf16_params" else torch.float32
    if mode == "bf16_params":
        jparams = jax.tree.map(lambda p: p.astype(jnp.bfloat16), jparams)
    ocfg_j, ocfg_p = jcfg.OptimizerConfig(), OptimizerConfig()
    decay = jgpt2.decay_mask(jparams)
    jstate = jopt.adamw_init(jparams, state_dtype=state_dtype)
    jparams, jstate, _ = jopt.adamw_update(jparams, _rand_grads(jparams, 1), jstate,
                                           jnp.float32(1e-3), ocfg_j, decay_mask=decay)
    model = _port_model(jparams, pdtype)
    params = gpt2.named_params(model)
    state = opt_state_from_jax(_np(jstate), PCFG)
    assert state["step"] == 1
    leaves = popt.jax_leaves(params)
    shapes = {**{n: p.shape for n, p in params.items()},
              **{path: leaf.shape for path, leaf in leaves.items()}}
    for i, scale in ((0, 10.0), (1, 0.01)):
        jg = jax.tree.map(lambda g: g * scale, _rand_grads(jparams, 2 + i))
        jparams, jstate, jnorm = jopt.adamw_update(jparams, jg, jstate, jnp.float32(1e-3),
                                                   ocfg_j, decay_mask=decay)
        g = _port_grads(jg)
        norm = popt.global_norm(g)
        np.testing.assert_allclose(norm.item(), float(jnorm), rtol=1e-6)
        popt.adamw_update(params, g, state, 1e-3, ocfg_p, norm=norm,
                          decay_mask=gpt2.decay_mask(model))
    assert state["step"] == 3
    want_p = gpt2_from_jax_params(_np(jparams), PCFG)
    for n, p in params.items():
        assert p.dtype == pdtype
        np.testing.assert_allclose(p.detach().float().numpy(), want_p[n].numpy(), rtol=0,
                                   atol=1e-6, err_msg=n)
    _check_moments(state, opt_state_from_jax(_np(jstate), PCFG), shapes)


def test_q8_chunked_update_equals_whole_leaf(monkeypatch):
    """The 8-bit update walked in chunks of leading rows gives the whole-leaf
    update's params, codes and scales bit for bit (same arithmetic, blocks
    grouped the same)."""
    _small_q8(monkeypatch)
    jparams = jgpt2.init(jax.random.PRNGKey(0), JCFG)
    g = _port_grads(_rand_grads(jparams, 5))

    def run(chunked):
        monkeypatch.setattr(popt, "Q8_CHUNK_MIN", 0 if chunked else 1 << 60)
        monkeypatch.setattr(popt, "Q8_CHUNK_TARGET", 4096)
        model = _port_model(jparams)
        params = gpt2.named_params(model)
        state = popt.adamw_init(params, state_dtype="int8")
        for _ in range(2):
            popt.adamw_update(params, g, state, 1e-3, OptimizerConfig(),
                              norm=popt.global_norm(g), decay_mask=gpt2.decay_mask(model))
        return params, state

    (pc, sc), (pw, sw) = run(True), run(False)
    assert popt._q8_chunk_rows((2, 64, 256)) == 1  # wfc: one layer a chunk
    for n in pc:
        assert torch.equal(pc[n], pw[n]), n
    for key in ("m", "v"):
        for k, a in sc[key].items():
            b = sw[key][k]
            if isinstance(a, dict):
                assert torch.equal(a["q"], b["q"]) and torch.equal(a["s"], b["s"]), (key, k)
            else:
                assert torch.equal(a, b), (key, k)


@pytest.mark.parametrize("src, dst", [(a, b) for a in ("float32", "bfloat16", "int8")
                                      for b in ("float32", "bfloat16", "int8") if a != b])
def test_convert_moments_matches_jax(monkeypatch, src, dst):
    """convert_moments from each storage to each other, against the JAX
    convert_moments on the same state: the tensors equal, 8-bit codes within
    one step and scales within 1e-6 (XLA's fp32 sqrt on the CPU is not
    correctly rounded: v's 8-bit form holds sqrt(v))."""
    _small_q8(monkeypatch)
    jparams = jgpt2.init(jax.random.PRNGKey(0), JCFG)
    rng = np.random.RandomState(0)
    st = {"m": jax.tree.map(lambda p: jnp.asarray(rng.randn(*p.shape).astype(np.float32)),
                            jparams),
          "v": jax.tree.map(lambda p: jnp.asarray(rng.rand(*p.shape).astype(np.float32)),
                            jparams),
          "step": jnp.int32(7)}
    jsrc = jopt.convert_moments(jparams, st, jnp.dtype(src))
    jdst = jopt.convert_moments(jparams, jsrc, jnp.dtype(dst))
    model = _port_model(jparams)
    params = gpt2.named_params(model)
    got = popt.convert_moments(params, opt_state_from_jax(_np(jsrc), PCFG), dst)
    want = opt_state_from_jax(_np(jdst), PCFG)
    assert got["step"] == 7
    for key in ("m", "v"):
        assert set(got[key]) == set(want[key])
        for n, w in want[key].items():
            a = got[key][n]
            if isinstance(w, dict):
                assert (a["q"].int() - w["q"].int()).abs().max() <= 1, (key, n)
                torch.testing.assert_close(a["s"], w["s"], rtol=1e-6, atol=0)
            else:
                assert a.dtype == w.dtype, (key, n)
                torch.testing.assert_close(a.float(), w.float(), rtol=1e-6, atol=0)


def test_compact_states_survive_a_checkpoint(tmp_path, monkeypatch):
    """8-bit and bf16 moments and bf16 params come back from the port's
    checkpoint with their dtypes and bits (JAX
    test_int8_state_frozen_leaves_and_ckpt_roundtrip)."""
    from gpt2_vision_language_tpu_torch.ckpt.checkpoint import load_checkpoint, save_checkpoint

    _small_q8(monkeypatch)
    model = _port_model(jgpt2.init(jax.random.PRNGKey(0), JCFG), torch.bfloat16)
    params = gpt2.named_params(model)
    g = {n: torch.full_like(p, 0.01) for n, p in params.items()}
    for sdt in ("int8", "bfloat16"):
        st = popt.adamw_init(params, state_dtype=sdt)
        popt.adamw_update(params, g, st, 1e-3, OptimizerConfig(), norm=popt.global_norm(g),
                          decay_mask=gpt2.decay_mask(model))
        path = str(tmp_path / f"{sdt}.pt")
        save_checkpoint(path, {"model": model.state_dict(), "opt_state": st}, {"step": 1})
        tree, meta = load_checkpoint(path)
        assert meta["step"] == 1 and tree["opt_state"]["step"] == 1
        for n, p in model.state_dict().items():
            assert tree["model"][n].dtype == torch.bfloat16 and torch.equal(tree["model"][n], p)
        for key in ("m", "v"):
            for n, a in st[key].items():
                b = tree["opt_state"][key][n]
                pairs = [(a["q"], b["q"]), (a["s"], b["s"])] if isinstance(a, dict) else [(a, b)]
                assert isinstance(a, dict) == isinstance(b, dict), (key, n)
                for x, y in pairs:
                    assert x.dtype == y.dtype and torch.equal(x, y), (key, n)
        assert ("blocks/mlp/wfc" in st["m"]) == (sdt == "int8")


# ---------------------------------------------------------------------------
# utils/trees and the CLI
# ---------------------------------------------------------------------------


def test_trees_match_jax(monkeypatch):
    """tree_size and tree_bytes of the params (fp32 and bf16) and of int8 and
    bf16 moment states equal the JAX ones on the same model; fmt_count too."""
    _small_q8(monkeypatch)
    jparams = jgpt2.init(jax.random.PRNGKey(0), JCFG)
    for jdt, pdt in ((jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)):
        jp = jax.tree.map(lambda p: p.astype(jdt), jparams)
        params = gpt2.named_params(_port_model(jparams, pdt))
        assert ptrees.tree_size(params) == jtrees.tree_size(jp)
        assert ptrees.tree_bytes(params) == jtrees.tree_bytes(jp)
    params = gpt2.named_params(_port_model(jparams))
    for sdt in ("int8", "bfloat16"):
        jst = jopt.adamw_init(jparams, state_dtype=jnp.dtype(sdt))
        st = popt.adamw_init(params, state_dtype=sdt)
        for key in ("m", "v"):
            assert ptrees.tree_size(st[key]) == jtrees.tree_size(jst[key])
            assert ptrees.tree_bytes(st[key]) == jtrees.tree_bytes(jst[key])
    for n in (0, 999, 1000, 124_475_904, 1_557_611_200, 2 * 10**12):
        assert ptrees.fmt_count(n) == jtrees.fmt_count(n)


RECIPE_ARGV = [
    ["--opt-state-dtype", "int8"], ["--opt-state-dtype", "bfloat16"],
    ["--param-dtype", "bfloat16"], ["--grad-accum-dtype", "bfloat16"], ["--layerwise-grad"],
    ["--remat", "full"], ["--remat", "save_attn"], ["--remat", "recompute_gelu"],
    ["--remat", "recompute_mlp"], ["--remat", "none"], [],
    ["--fit-1chip", "--model", "774M"], ["--fit-1chip", "--model", "1558M"],
    ["--fit-1chip", "--model", "1558M", "--opt-state-dtype", "bfloat16", "--micro-batch", "2"],
]


@pytest.mark.parametrize("argv", RECIPE_ARGV, ids=lambda a: " ".join(a) or "defaults")
def test_recipe_flags_match_jax_cli(monkeypatch, argv):
    """The memory-recipe flags give the config fields and the remat argument
    that the JAX parse_and_build gives. For --fit-1chip the port's table is
    the H100's own, so here it is replaced by the JAX table without its
    TPU-only keys: what is compared is how the flag fills the stack in, and
    that explicit flags win."""
    from gpt2_vision_language_tpu.cli import pretrain as jcli
    from gpt2_vision_language_tpu_torch.cli import pretrain as pcli

    tpu_only = {"pin_layouts", "split_accum"}
    monkeypatch.setattr(pcli, "FIT_1CHIP", {m: {k: v for k, v in row.items() if k not in tpu_only}
                                            for m, row in jcli.FIT_1CHIP.items()})
    jc, jremat, _ = jcli.parse_and_build(argv)
    pc, args = pcli.parse_and_build(argv)
    for key in ("opt_state_dtype", "param_dtype", "grad_accum_dtype", "layerwise_grad",
                "micro_batch_size", "total_batch_size"):
        assert getattr(pc, key) == getattr(jc, key), key
    assert pcli.remat_of(args) == jremat


def test_h100_fit_table_keys():
    """The port's FIT_1CHIP: every preset, only keys the CLI has, none of the
    TPU-only mechanisms."""
    from gpt2_vision_language_tpu_torch.cli import pretrain as pcli

    assert set(pcli.FIT_1CHIP) == {"124M", "350M", "774M", "1558M"}
    known = {"opt_state_dtype", "param_dtype", "grad_accum_dtype", "remat", "layerwise_grad",
             "micro_batch"}
    for row in pcli.FIT_1CHIP.values():
        assert set(row) <= known
    args = pcli.parse_and_build(["--fit-1chip", "--model", "1558M"])[1]
    assert all(getattr(args, k) == v for k, v in pcli.FIT_1CHIP["1558M"].items())
