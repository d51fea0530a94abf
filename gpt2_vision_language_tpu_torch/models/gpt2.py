"""GPT-2 decoder: an nn.Module with the reference's names, and the forward
as plain functions over it.

Counterpart of gpt2_vision_language_tpu/models/gpt2.py.
The JAX package keeps parameters as a stacked pytree; here they live in an
``nn.Module`` whose submodule names are the reference's
(``transformer.wte/wpe/h.{i}.ln_1/attn.c_attn/attn.c_proj/ln_2/mlp.c_fc/
mlp.c_proj/ln_f`` and a tied ``lm_head``), so reference ``.pt`` files and
``ckpt/torch_export.py`` output load with ``load_state_dict``. The
functions below take that module where the JAX functions take ``params``
and keep the JAX names and arguments.

Self-attention feeds the three strided (B, T, H, hs) views of the fused
QKV output straight to ops/attention.sdpa, which routes causal T >= 512 on
CUDA to the flash kernels (forward and backward). ``loss`` runs lm_head +
CE through ops/fused_ce.fused_linear_ce, which routes a call under the
bf16 policy on CUDA to the fused CE kernel (K4) over all rows and, under
autograd, to the logits-gradient kernel (K4b) on each chunk of rows of its
recompute backward, with dx and dw as plain products; under FP32_POLICY or
on the CPU it takes the chunked plain forward and backward. Either way
``loss`` is differentiable end to end. The tied
wte / lm_head weight gets its gradient from the embedding gather and the
CE head into one fp32 ``.grad``. The parameter dicts below
(``named_params``, ``decay_mask``) are keyed by state-dict name and hold the tied weight once, as
``transformer.wte.weight``. The layer loop is always unrolled.

The remat modes of the JAX ``run_blocks`` (:260-345 there) are
``run_blocks(remat=...)``: False / "none", True / "full" (each block from
its input alone, ``torch.utils.checkpoint``), "save_attn" (the attention
output kept, the rest of the block recomputed), "recompute_mlp" (everything
kept but the MLP's (B, T, 4C) hidden and its GELU, which the backward
recomputes from the saved LayerNorm output) and "recompute_gelu" (only the
GELU recomputed, from the saved hidden). Each saves what the JAX policy of
the same name saves (the values named "attn_out", "mlp_hidden" and
"mlp_gelu" there) and recomputes what it recomputes: the two MLP modes are
autograd Functions (``_MlpRemat``) rather than ``torch.utils.checkpoint``,
whose replay would also run the MLP's output projection again.
``loss_grad_layerwise`` is the JAX function of that name (:463-560): the
loss and its gradients formed layer by layer, each layer's folded into the
train step's accumulators at once.

The gated cross-attention variant (``cfg.cross_attention``) prepends
``x += tanh(cross_gate) * xattn(ln_x(x), z)`` to every block
(gpt2_cross-att/model.py:99-104) under the reference's names
(``transformer.h.{i}.ln_x / xattn.q_proj / xattn.kv_proj / xattn.c_proj /
cross_gate`` and ``transformer.vis_proj.z_proj``, the names
ckpt/torch_import.py:92-108 reads). The gates start at 0, so the model
starts as plain GPT-2; ``z`` is the (B, N, img_embd) visual memory, projected
once through ``vis_proj`` by ``apply`` / ``loss`` (``run_blocks`` and
``forward_cached`` take it already projected). Cross-attention is non-causal
over 33 keys and always takes the plain path, as in the JAX package.

Under Megatron tensor parallelism (parallel/sharding.shard_model) the model
holds one rank's shards and carries their ``TensorParallel`` as ``model.tp``:
the functions here then compute this rank's heads and MLP slice, insert the
collectives of parallel/collectives.py around them (``_enter``, ``_row_out``),
look the embedding up by vocab rows and gather ``wte`` for the tied head;
``loss`` T-shards the residual stream between blocks when the run asked for
sequence parallelism. With ``attn_impl="ring"`` a tensor-parallel block runs
its attention as the ring over processes (``self_attention``).
"""

from __future__ import annotations

import torch
import torch.utils.checkpoint
from torch import nn

from ..core.config import GPTConfig
from ..core.precision import Policy, DEFAULT_POLICY
from ..ops.attention import sdpa
from ..ops.fused_ce import fused_linear_ce
from ..ops.layers import embed, gelu_tanh, layer_norm, linear, linear_backward, matmul_f32

REMAT_MODES = ("none", "full", "save_attn", "recompute_gelu", "recompute_mlp")

# ---------------------------------------------------------------------------
# Module and init
# ---------------------------------------------------------------------------


class CausalSelfAttention(nn.Module):
    def __init__(self, cfg: GPTConfig):
        super().__init__()
        self.c_attn = nn.Linear(cfg.n_embd, 3 * cfg.n_embd)
        self.c_proj = nn.Linear(cfg.n_embd, cfg.n_embd)


class MLP(nn.Module):
    def __init__(self, cfg: GPTConfig):
        super().__init__()
        self.c_fc = nn.Linear(cfg.n_embd, 4 * cfg.n_embd)
        self.c_proj = nn.Linear(4 * cfg.n_embd, cfg.n_embd)


class CrossAttention(nn.Module):
    def __init__(self, cfg: GPTConfig):
        super().__init__()
        self.q_proj = nn.Linear(cfg.n_embd, cfg.n_embd)
        self.kv_proj = nn.Linear(cfg.n_embd, 2 * cfg.n_embd)
        self.c_proj = nn.Linear(cfg.n_embd, cfg.n_embd)


class VisProj(nn.Module):
    def __init__(self, cfg: GPTConfig):
        super().__init__()
        self.z_proj = nn.Linear(cfg.img_embd, cfg.n_embd)


class Block(nn.Module):
    def __init__(self, cfg: GPTConfig):
        super().__init__()
        self.ln_1 = nn.LayerNorm(cfg.n_embd)
        self.attn = CausalSelfAttention(cfg)
        self.ln_2 = nn.LayerNorm(cfg.n_embd)
        self.mlp = MLP(cfg)
        if cfg.cross_attention:
            self.ln_x = nn.LayerNorm(cfg.n_embd)
            self.xattn = CrossAttention(cfg)
            # Flamingo-style scalar gate, 0 so the pretrained LM is untouched
            # at step 0 (gpt2_cross-att/model.py:97)
            self.cross_gate = nn.Parameter(torch.zeros(1))


class GPT2(nn.Module):
    """Parameter container with the reference's state-dict names; the
    forward is the functions below. ``tp``: the TensorParallel of a model
    whose parameters are one rank's shards (parallel/sharding.shard_model);
    ``stage``: the pipeline Stage of a model that holds one stage's layers
    (parallel/pipeline.cut_stage; the other layers' places hold no
    parameters)."""

    tp = None
    stage = None

    def __init__(self, cfg: GPTConfig):
        super().__init__()
        if cfg.cross_attention and cfg.img_embd <= 0:
            raise ValueError("cross_attention needs img_embd > 0")
        self.cfg = cfg
        self.transformer = nn.ModuleDict(
            dict(
                wte=nn.Embedding(cfg.padded_vocab_size, cfg.n_embd),
                wpe=nn.Embedding(cfg.block_size, cfg.n_embd),
                h=nn.ModuleList(Block(cfg) for _ in range(cfg.n_layer)),
                ln_f=nn.LayerNorm(cfg.n_embd),
            )
        )
        if cfg.cross_attention:
            self.transformer["vis_proj"] = VisProj(cfg)
        self.lm_head = nn.Linear(cfg.n_embd, cfg.padded_vocab_size, bias=False)
        self.lm_head.weight = self.transformer.wte.weight  # tied (train_gpt2.py:97)


@torch.no_grad()
def init(cfg: GPTConfig, *, generator: torch.Generator | None = None,
         device=None) -> GPT2:
    """A GPT-2 with the JAX init's distribution (models/gpt2.py:48-100):
    normal(0, 0.02) for the embeddings, QKV and MLP-in weights (and the
    cross-attention q/kv projections and vis_proj), normal(0, 0.02 *
    (2 * n_layer) ** -0.5) for the residual output projections (the
    cross-attention's too), zero biases and gates, unit LayerNorm scales; fp32. Same distribution as the JAX
    init, not the same numbers. ``generator`` must live on ``device``."""
    device = torch.device(device or "cpu")
    if generator is None:
        generator = torch.Generator(device).manual_seed(0)
    with torch.device(device):
        model = GPT2(cfg)
    proj_std = 0.02 * (2 * cfg.n_layer) ** -0.5
    for name, p in model.named_parameters():
        if name.endswith(("attn.c_proj.weight", "mlp.c_proj.weight")):
            p.normal_(0.0, proj_std, generator=generator)
        elif p.dim() == 2:
            p.normal_(0.0, 0.02, generator=generator)
        elif name.endswith(("ln_1.weight", "ln_2.weight", "ln_f.weight", "ln_x.weight")):
            p.fill_(1.0)
        else:
            p.zero_()
    return model


def named_params(model: nn.Module) -> dict:
    """name -> parameter, the tied wte / lm_head weight once (as
    ``transformer.wte.weight``): the leaves the optimizer updates."""
    return dict(model.named_parameters())


def param_count(model: nn.Module) -> int:
    return sum(p.numel() for p in named_params(model).values())


def decay_mask(model: nn.Module) -> dict:
    """name -> True where AdamW weight decay applies (models/gpt2.py:801):
    the weights of nn.Linear and nn.Embedding (wte, wpe, every projection);
    not biases or LayerNorm parameters (train_gpt2.py:130-135, torch ndim
    >= 2); the cross-attention gates do not decay."""
    decayed = {id(m.weight) for m in model.modules()
               if isinstance(m, (nn.Linear, nn.Embedding))}
    return {n: id(p) in decayed for n, p in named_params(model).items()}


def trainable_mask_xattn(model: nn.Module) -> dict:
    """name -> True for what the cross-attention fine-tune trains: vis_proj,
    every xattn projection and every cross_gate. Everything else is frozen,
    ln_x included although it sits inside the trained prologue
    (gpt2_cross-att/model.py:131-139; models/gpt2.py:786-798)."""
    return {n: (".xattn." in n or n.endswith(".cross_gate")
                or n.startswith("transformer.vis_proj."))
            for n in named_params(model)}


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------


def _ln(x, ln: nn.LayerNorm):
    return layer_norm(x, ln.weight, ln.bias)


def _enter(x, tp):
    return x if tp is None else tp.enter(x)


def _row_out(y, proj: nn.Linear, policy: Policy, tp):
    """The output projection of a branch; under tensor parallelism this
    rank's partial product, summed over ``model`` (reduce-scattered on T
    under sequence parallelism), then the replicated bias."""
    if tp is None:
        return linear(y, proj.weight, proj.bias, policy=policy)
    out = tp.leave(linear(y, proj.weight, None, policy=policy))
    return out + proj.bias.to(out.dtype)


def self_attention(attn: CausalSelfAttention, x, cfg: GPTConfig, *,
                   policy: Policy, attn_impl: str, tp=None):
    """Causal self-attention with fused QKV (train_gpt2.py:33-43). q, k and
    v stay strided (B, T, H, hs) views of the (B, T, 3C) projection. Under
    tensor parallelism (``tp``) the rank computes its own heads; with
    ``attn_impl="ring"`` there, the ring over the ``model`` group
    (``TensorParallel.ring_attention``)."""
    x = _enter(x, tp)
    b, t, _ = x.shape
    hs = cfg.head_dim
    qkv = linear(x, attn.c_attn.weight, attn.c_attn.bias, policy=policy)
    c = qkv.shape[-1] // 3
    cc = policy.cast_compute
    if tp is not None and attn_impl == "ring":
        # the ring over the model group: heads swapped for sequence chunks
        # and back around it
        y = tp.ring_attention(cc(qkv).view(b, t, 3, c // hs, hs))
    else:
        q, k, v = (a.view(b, t, c // hs, hs) for a in qkv.split(c, dim=-1))
        y = sdpa(cc(q), cc(k), cc(v), causal=True, impl=attn_impl, layout="bthd")
    y = y.to(x.dtype).reshape(b, t, c)
    return _row_out(y, attn.c_proj, policy, tp)


def mlp(m: MLP, x, *, policy: Policy, tp=None):
    """c_fc -> tanh-GELU -> c_proj (train_gpt2.py:46-59); under tensor
    parallelism over this rank's slice of the hidden."""
    h = gelu_tanh(linear(_enter(x, tp), m.c_fc.weight, m.c_fc.bias, policy=policy))
    return _row_out(h, m.c_proj, policy, tp)


class _MlpRemat(torch.autograd.Function):
    """c_proj(gelu(fc)) whose backward recomputes the GELU output instead of
    keeping it. Given fc (``x`` with wfc None: "recompute_gelu") it saves fc;
    given the c_fc input ``x`` with wfc and bfc ("recompute_mlp") it saves x
    and recomputes fc as well. The output projection is not run again."""

    @staticmethod
    def forward(ctx, x, wfc, bfc, wproj, bproj, policy):
        with torch.no_grad():
            fc = x if wfc is None else linear(x, wfc, bfc, policy=policy)
            h = gelu_tanh(fc)
            y = linear(h, wproj, bproj, policy=policy)
        ctx.policy, ctx.h_dtype = policy, h.dtype
        ctx.recompute_fc = wfc is not None
        ctx.has_bias = bproj is not None
        ctx.save_for_backward(x, wfc, bfc, wproj)
        return y

    @staticmethod
    def backward(ctx, dy):
        x, wfc, bfc, wproj = ctx.saved_tensors
        needs = ctx.needs_input_grad
        with torch.enable_grad():
            xr = x.detach().requires_grad_(needs[0])
            fc = linear(xr, wfc, bfc, policy=ctx.policy) if ctx.recompute_fc else xr
            h = gelu_tanh(fc)
        dh, dwproj, dbproj = linear_backward(dy, ctx.policy.cast_compute(h.detach()), wproj,
                                             ctx.policy, ctx.h_dtype, ctx.has_bias,
                                             (True, needs[3], needs[4]))
        wrt = [(i, a) for i, a in enumerate((xr, wfc, bfc)) if needs[i]]
        got = torch.autograd.grad(h, [a for _, a in wrt], dh) if wrt else ()
        grads = [None, None, None]
        for (i, _), g in zip(wrt, got):
            grads[i] = g
        return (*grads, dwproj, dbproj, None)


def _mlp_remat(m: MLP, x, policy: Policy, mode: str, tp=None):
    x = _enter(x, tp)
    bproj = m.c_proj.bias if tp is None else None
    if mode == "recompute_gelu":
        fc = linear(x, m.c_fc.weight, m.c_fc.bias, policy=policy)
        y = _MlpRemat.apply(fc, None, None, m.c_proj.weight, bproj, policy)
    else:
        y = _MlpRemat.apply(x, m.c_fc.weight, m.c_fc.bias, m.c_proj.weight, bproj, policy)
    if tp is None:
        return y
    y = tp.leave(y)
    return y + m.c_proj.bias.to(y.dtype)


def cross_attention(xattn: CrossAttention, x, z, cfg: GPTConfig, *, policy: Policy):
    """Non-causal text -> vision cross-attention (gpt2_cross-att/model.py:34-58)
    over the projected visual memory z (B, N, C). 33 keys: always the plain
    path."""
    b, t, c = x.shape
    hs = c // cfg.n_head
    q = linear(x, xattn.q_proj.weight, xattn.q_proj.bias, policy=policy)
    kv = linear(z, xattn.kv_proj.weight, xattn.kv_proj.bias, policy=policy)
    q = q.view(b, t, cfg.n_head, hs)
    k, v = (a.view(b, z.shape[1], cfg.n_head, hs) for a in kv.split(c, dim=-1))
    cc = policy.cast_compute
    y = sdpa(cc(q), cc(k), cc(v), causal=False, impl="xla", layout="bthd")
    y = y.to(x.dtype).reshape(b, t, c)
    return linear(y, xattn.c_proj.weight, xattn.c_proj.bias, policy=policy)


def _xblock(layer: Block, x, z, cfg: GPTConfig, policy: Policy):
    """The gated cross-attention prologue of a block; the identity without z."""
    if not cfg.cross_attention or z is None:
        return x
    xa = cross_attention(layer.xattn, _ln(x, layer.ln_x), z, cfg, policy=policy)
    # cast: the fp32 scalar gate must not promote the bf16 residual
    return x + torch.tanh(layer.cross_gate).to(x.dtype) * xa


def _attn_out(layer: Block, x, cfg: GPTConfig, policy: Policy, attn_impl: str, tp=None):
    return self_attention(layer.attn, _ln(x, layer.ln_1), cfg, policy=policy,
                          attn_impl=attn_impl, tp=tp)


def _mlp_out(layer: Block, x, policy: Policy, tp=None):
    return mlp(layer.mlp, _ln(x, layer.ln_2), policy=policy, tp=tp)


def block(layer: Block, x, cfg: GPTConfig, *, policy: Policy,
          attn_impl: str, z=None, remat="none", tp=None):
    """Pre-LN residual block (train_gpt2.py:62-74), with the gated
    cross-attention prologue when the model has one and z is given.
    ``remat``: one of REMAT_MODES, the selective ones here ("full" is
    run_blocks' checkpoint of the whole block). ``tp``: the model's
    TensorParallel view (``_tp_view``) under tensor parallelism."""
    x = _xblock(layer, x, z, cfg, policy)
    if remat == "save_attn":
        # kept: the block input and x + attn_out; the attention's inside and
        # the MLP are recomputed in the backward
        ckpt = torch.utils.checkpoint.checkpoint
        x = x + ckpt(_attn_out, layer, x, cfg, policy, attn_impl, tp, use_reentrant=False,
                     preserve_rng_state=False)
        return x + ckpt(_mlp_out, layer, x, policy, tp, use_reentrant=False,
                        preserve_rng_state=False)
    x = x + _attn_out(layer, x, cfg, policy, attn_impl, tp)
    if remat in ("recompute_gelu", "recompute_mlp"):
        return x + _mlp_remat(layer.mlp, _ln(x, layer.ln_2), policy, remat, tp)
    return x + _mlp_out(layer, x, policy, tp)


def _tp_view(model, seq_parallel: bool = False):
    """The model's TensorParallel, T-sharding the residual stream when
    ``seq_parallel`` and the run asked for it; None for a whole model."""
    tp = getattr(model, "tp", None)
    return None if tp is None else tp.view(seq_parallel)


def local_heads(model, cfg: GPTConfig) -> int:
    """The heads this rank computes: all of them unless tensor-parallel."""
    tp = getattr(model, "tp", None)
    return cfg.n_head if tp is None else tp.heads[tp.rank]


def _remat_mode(remat) -> str:
    """The JAX remat argument (False, True or a policy name) as a name of
    REMAT_MODES."""
    mode = {False: "none", True: "full", None: "none"}.get(remat, remat)
    if mode not in REMAT_MODES:
        raise ValueError(f"remat {remat!r} is not one of {REMAT_MODES} (or False / True)")
    return mode


def run_blocks(model: GPT2, x, cfg: GPTConfig, *, z=None,
               policy: Policy = DEFAULT_POLICY, attn_impl: str = "auto", remat=False,
               seq_parallel: bool = False, layers=None):
    """The blocks in order, as a Python loop (the JAX unrolled path). ``z``
    is the projected visual memory of the cross-attention variant.
    ``remat``: False / "none", True / "full", "save_attn",
    "recompute_gelu", "recompute_mlp" (the module docstring); it matters
    only where autograd records the forward. ``seq_parallel``: x is this
    rank's T-shard of the residual stream when the tensor-parallel run asked
    for sequence parallelism (``loss`` passes True). ``layers``: the indices
    of the blocks to run (a pipeline stage's), every block when None."""
    mode = _remat_mode(remat)
    if not torch.is_grad_enabled():
        mode = "none"
    tp = _tp_view(model, seq_parallel)
    h = model.transformer.h
    for i in (range(len(h)) if layers is None else layers):
        layer = h[i]
        if not isinstance(layer, Block):
            raise RuntimeError(f"layer {i} is held by another pipeline stage "
                               "(parallel/pipeline.whole_stages gathers them)")
        if mode == "full":
            x = torch.utils.checkpoint.checkpoint(
                block, layer, x, cfg, policy=policy, attn_impl=attn_impl, z=z, tp=tp,
                use_reentrant=False, preserve_rng_state=False)
        else:
            x = block(layer, x, cfg, policy=policy, attn_impl=attn_impl, z=z, remat=mode,
                      tp=tp)
    return x


def project_visual(model: GPT2, z, cfg: GPTConfig, dtype, *,
                   policy: Policy = DEFAULT_POLICY):
    """(B, N, img_embd) visual tokens -> the (B, N, C) memory the blocks
    attend to, through vis_proj, in ``dtype``; None stays None, and a model
    without cross-attention ignores z."""
    if z is None or not cfg.cross_attention:
        return None
    zp = model.transformer.vis_proj.z_proj
    return linear(z, zp.weight, zp.bias, policy=policy).to(dtype)


def embed_tokens(model: GPT2, idx, cfg: GPTConfig, *, pos_offset: int = 0,
                 seq_parallel: bool = False):
    """wte + wpe embedding sum (train_gpt2.py:114-117). Under tensor
    parallelism the vocab-parallel lookup (``TensorParallel.embed``); with
    ``seq_parallel`` this rank's T-shard of it."""
    tp = _tp_view(model, seq_parallel)
    if tp is None:
        e = embed(model.transformer.wte.weight, idx)
    else:
        e = tp.embed(model.transformer.wte.weight, idx)
        if tp.sp:
            pos_offset += tp.rank * e.shape[1]
    pos = torch.arange(pos_offset, pos_offset + e.shape[-2], device=idx.device)
    return e + embed(model.transformer.wpe.weight, pos)


def _head_weight(model: GPT2, seq_parallel: bool = False):
    """The tied head's (V, C) weight: wte, gathered whole under tensor
    parallelism (the JAX program gathers the vocab-sharded wte too)."""
    tp = _tp_view(model, seq_parallel)
    w = model.transformer.wte.weight
    return w if tp is None else tp.full_wte(w)


def lm_head(model: GPT2, x, cfg: GPTConfig, *,
            policy: Policy = DEFAULT_POLICY):
    """Tied unembedding, ln_f(x) @ wte.T, fp32 accumulation, returned in the
    compute dtype (models/gpt2.py:353-368)."""
    x = _ln(x, model.transformer.ln_f)
    logits = linear(x, _head_weight(model), policy=policy)
    return logits.to(policy.compute_dtype)


def _check_len(idx, cfg: GPTConfig):
    if idx.shape[-1] > cfg.block_size:
        raise ValueError(
            f"sequence of {idx.shape[-1]} tokens exceeds block_size {cfg.block_size}"
        )


def forward_embeds(model: GPT2, embeds, cfg: GPTConfig, *, z=None,
                   policy: Policy = DEFAULT_POLICY, attn_impl: str = "auto"):
    """Blocks + ln_f + lm_head over already-embedded inputs (z already
    projected)."""
    x = run_blocks(model, embeds, cfg, z=z, policy=policy, attn_impl=attn_impl)
    return lm_head(model, x, cfg, policy=policy)


def apply(model: GPT2, idx, cfg: GPTConfig, *, targets=None, target_mask=None,
          z=None, policy: Policy = DEFAULT_POLICY, attn_impl: str = "auto"):
    """Full forward. Returns (logits, loss); loss is None without targets
    (train_gpt2.py:111-125; the masked mean of the cross-attention variant,
    gpt2_cross-att/model.py:169-186). ``z``: (B, N, img_embd) visual tokens."""
    _check_len(idx, cfg)
    x = embed_tokens(model, idx, cfg).to(policy.compute_dtype)
    z = project_visual(model, z, cfg, x.dtype, policy=policy)
    logits = forward_embeds(model, x, cfg, z=z, policy=policy, attn_impl=attn_impl)
    loss = None
    if targets is not None:
        loss = cross_entropy(logits, targets, mask=target_mask)
    return logits, loss


def loss(model: GPT2, idx, cfg: GPTConfig, *, targets, target_mask=None, z=None,
         policy: Policy = DEFAULT_POLICY, attn_impl: str = "auto",
         ce_chunks: int = 8, ce_impl: str = "auto", remat=False, group=None):
    """CE loss without the (B, T, V) logits: apply(...)[1]'s semantics with
    lm_head + CE through fused_linear_ce. The scoring forward: called without
    autograd (train/step.py make_eval_step) under the bf16 policy on CUDA it
    runs the flash kernel in every layer and the fused CE kernel once. The
    training loss: under autograd on CUDA every layer runs the flash forward
    and, in the backward, the flash backward kernel; under the bf16 policy
    CE runs the fused CE kernel once and, in its backward, the
    logits-gradient kernel on each of its ``ce_chunks`` chunks of rows (the
    chunked plain forward and backward under FP32_POLICY). ``ce_impl`` is
    fused_linear_ce's ``impl``, ``remat`` run_blocks'.

    Parallel forms: a tensor-parallel model (``model.tp``) runs its shards,
    T-sharded between blocks when the run asked for sequence parallelism;
    then each rank scores its T-shard of the targets and the loss is their
    mean over ``model``. ``group``: the ranks of the process group hold the
    other rows (data parallelism), and the loss is the mean over all of
    them. The value returned is the whole loss on every rank; its backward
    reaches this rank's part only."""
    _check_len(idx, cfg)
    x = embed_tokens(model, idx, cfg, seq_parallel=True).to(policy.compute_dtype)
    z = project_visual(model, z, cfg, x.dtype, policy=policy)
    x = run_blocks(model, x, cfg, z=z, policy=policy, attn_impl=attn_impl, remat=remat,
                   seq_parallel=True)
    x = _ln(x, model.transformer.ln_f)
    tp = _tp_view(model, True)
    if tp is not None and tp.sp:
        targets, group = tp.seq_slice(targets), tp.group
        target_mask = None if target_mask is None else tp.seq_slice(target_mask)
    return fused_ce_loss(x, _head_weight(model, True), targets,
                         mask=target_mask, policy=policy, ce_chunks=ce_chunks,
                         impl=ce_impl, group=group)


def head_loss(model: GPT2, x, targets, *, policy: Policy = DEFAULT_POLICY,
              ce_chunks: int = 8):
    """ln_f and the fused CE of the tied head over the blocks' output x
    (B, T, C): the tail of ``loss`` with the residual stream whole (the
    pipeline's last stage takes it once over a micro-batch)."""
    return fused_ce_loss(_ln(x, model.transformer.ln_f), _head_weight(model), targets,
                         policy=policy, ce_chunks=ce_chunks)


def loss_grad_layerwise(model: GPT2, idx, cfg: GPTConfig, *, targets, acc, target_mask=None,
                        policy: Policy = DEFAULT_POLICY, attn_impl: str = "auto",
                        ce_chunks: int = 8):
    """The loss of ``loss`` and its gradients, formed layer by layer and
    folded into the train step's accumulators as they come (JAX
    loss_grad_layerwise, :463-560): no tree of every parameter's gradient
    exists at once.

    A forward without autograd keeps each block's input; the tail (ln_f and
    the CE head) is differentiated first; then, layer by layer in reverse,
    each block is recomputed from its saved input and differentiated with
    ``torch.autograd.grad``, its parameters' gradients handed to
    ``acc.add(name, grad)`` at once. The tied wte gets its head and
    embedding gradients summed in fp32 before its one accumulate (:552-556
    there). Peak gradient memory is one layer's; every block's forward runs
    twice. Returns the loss, detached. Plain decoder only, every parameter
    trainable (the pretraining workload). A tensor-parallel model runs its
    shards with the residual stream whole (no sequence parallelism, as in
    the JAX trainer), its attention the ring over processes with
    ``attn_impl="ring"``."""
    if cfg.cross_attention:
        raise ValueError("loss_grad_layerwise: plain decoder only")
    _check_len(idx, cfg)
    tr = model.transformer
    layers = list(tr.h)
    tp = _tp_view(model)
    saved = []
    with torch.no_grad():
        x = embed_tokens(model, idx, cfg).to(policy.compute_dtype)
        for layer in layers:
            saved.append(x)
            x = block(layer, x, cfg, policy=policy, attn_impl=attn_impl, tp=tp)
    with torch.enable_grad():
        xl = x.requires_grad_(True)
        loss_val = fused_ce_loss(_ln(xl, tr.ln_f), _head_weight(model), targets,
                                 mask=target_mask, policy=policy, ce_chunks=ce_chunks)
        dx, dwte_head, dlnf_w, dlnf_b = torch.autograd.grad(
            loss_val, [xl, tr.wte.weight, tr.ln_f.weight, tr.ln_f.bias])
    del xl, x
    for i in reversed(range(len(layers))):
        names, params = zip(*layers[i].named_parameters())
        with torch.enable_grad():
            x_in = saved[i].requires_grad_(True)
            y = block(layers[i], x_in, cfg, policy=policy, attn_impl=attn_impl, tp=tp)
            grads = torch.autograd.grad(y, [x_in, *params], dx)
        saved[i] = None
        dx = grads[0]
        for n, g in zip(names, grads[1:]):
            acc.add(f"transformer.h.{i}.{n}", g)
        del y, x_in, grads
    with torch.enable_grad():
        x0 = embed_tokens(model, idx, cfg).to(policy.compute_dtype)
        dwte_embed, dwpe = torch.autograd.grad(x0, [tr.wte.weight, tr.wpe.weight], dx)
    acc.add("transformer.wte.weight", dwte_head.float() + dwte_embed.float())
    acc.add("transformer.wpe.weight", dwpe)
    acc.add("transformer.ln_f.weight", dlnf_w)
    acc.add("transformer.ln_f.bias", dlnf_b)
    return loss_val.detach()


def fused_ce_loss(x, wte, targets, *, mask=None, policy: Policy = DEFAULT_POLICY,
                  ce_chunks: int = 8, impl: str = "auto", group=None):
    """Masked-mean fused CE over final hiddens x (..., T, D); targets equal
    to -100 are ignored (clipped to 0 before the kernel, then masked).
    ``group``: each rank of the process group holds part of the tokens; the
    mean is over all of them (the count summed over the group), returned on
    every rank, and its backward reaches this rank's tokens only."""
    d = x.shape[-1]
    flat_x = x.reshape(-1, d)
    flat_t = targets.reshape(-1)
    ignore = flat_t == -100
    safe_t = torch.where(ignore, torch.zeros_like(flat_t), flat_t)
    nll = fused_linear_ce(flat_x, wte, safe_t, n_chunks=ce_chunks,
                          policy=policy, impl=impl)
    valid = ~ignore
    if mask is not None:
        valid = valid & mask.reshape(-1).bool()
    nll = nll * valid
    if group is not None:
        from ..parallel import collectives as coll

        count = coll.all_reduce_(valid.sum().float(), group)
        return coll.ReduceFromGroup.apply(nll.sum(), group) / count.clamp(min=1)
    return nll.sum() / valid.sum().clamp(min=1)


def cross_entropy(logits, targets, *, mask=None):
    """Token-level CE in fp32: plain mean, or masked mean with the count
    clamped >= 1; targets equal to -100 are ignored."""
    logits = logits.float()
    ignore = targets == -100
    safe = torch.where(ignore, torch.zeros_like(targets), targets)
    logz = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, safe[..., None].long())[..., 0]
    valid = ~ignore
    if mask is not None:
        valid = valid & mask.bool()
    nll = (logz - gold) * valid
    return nll.sum() / valid.sum().clamp(min=1)


# ---------------------------------------------------------------------------
# KV-cached decode path
# ---------------------------------------------------------------------------


def init_cache(cfg: GPTConfig, batch_size: int, max_len: int,
               dtype=torch.bfloat16, device=None, n_head=None):
    """Zeroed (L, B, H, max_len, hs) K and V caches; ``n_head``: the heads
    this rank computes (``local_heads``), all of cfg's by default."""
    shape = (cfg.n_layer, batch_size, n_head or cfg.n_head, max_len, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def _cached_sdpa(q, k_cache, v_cache, slot: int, policy: Policy):
    """q rows i (at absolute positions slot + i) attend to cache[j] for
    j <= slot + i. q: (B, H, Tq, hs); caches (B, H, maxT, hs). Only the
    written prefix [0, slot + Tq) is read: the slots past it are masked in
    the JAX version and contribute exactly zero there."""
    tq = q.shape[2]
    kv_len = slot + tq
    k = k_cache[:, :, :kv_len]
    v = v_cache[:, :, :kv_len]
    cc = policy.cast_compute
    scores = matmul_f32(cc(q), cc(k).transpose(-1, -2)) * q.shape[-1] ** -0.5
    qpos = slot + torch.arange(tq, device=q.device)[:, None]
    kpos = torch.arange(kv_len, device=q.device)[None, :]
    scores = scores.masked_fill(kpos > qpos, float("-inf"))
    probs = torch.softmax(scores, dim=-1)
    out = matmul_f32(probs.to(v.dtype), v)
    return out.to(q.dtype)


def run_blocks_cached(model: GPT2, embeds, cfg: GPTConfig, cache, slot: int,
                       policy: Policy, z=None):
    x = embeds
    b, t, _ = x.shape
    hs = cfg.head_dim
    tp = _tp_view(model)
    for l, layer in enumerate(model.transformer.h):
        attn = layer.attn
        x = _xblock(layer, x, z, cfg, policy)
        qkv = linear(_enter(_ln(x, layer.ln_1), tp), attn.c_attn.weight, attn.c_attn.bias,
                     policy=policy)
        c = qkv.shape[-1] // 3
        q, k, v = (a.view(b, t, c // hs, hs).transpose(1, 2)
                   for a in qkv.split(c, dim=-1))
        # the new rows are written into the stacked cache in place
        cache["k"][l, :, :, slot:slot + t] = k.to(cache["k"].dtype)
        cache["v"][l, :, :, slot:slot + t] = v.to(cache["v"].dtype)
        y = _cached_sdpa(q, cache["k"][l], cache["v"][l], slot, policy)
        y = y.transpose(1, 2).reshape(b, t, c)
        x = x + _row_out(y, attn.c_proj, policy, tp)
        x = x + mlp(layer.mlp, _ln(x, layer.ln_2), policy=policy, tp=tp)
    return x


def forward_cached(model: GPT2, embeds, cfg: GPTConfig, cache, slot: int, *,
                   z=None, policy: Policy = DEFAULT_POLICY,
                   last_only: bool = False):
    """Blocks over already-embedded inputs, reading and writing the KV cache
    at [slot, slot + T). Returns (logits, cache): logits over all T positions,
    or over the last one with last_only=True. The cache tensors are updated
    in place. Positional embeddings are the caller's (a visual prefix gets
    none, text restarts at position 0). ``z`` is the projected visual memory
    of the cross-attention variant (models/gpt2.py:719-729)."""
    x = run_blocks_cached(model, embeds, cfg, cache, slot, policy, z=z)
    if last_only:
        x = x[:, -1:, :]
    return lm_head(model, x, cfg, policy=policy), cache
