"""Plain GPT-2 pretraining steps in PyTorch: forward, loss, backward, clip, AdamW.

The reference that decides ``correct``. It imports nothing of the program and
nothing of JAX. It follows the published GPT-2 block (pre-LayerNorm, fused
QKV, causal softmax attention, tanh GELU MLP, tied head over the padded
vocabulary) and the reference training script's step: the mean loss over the
micro-batches, the global-norm clip at ``grad_clip`` (clip / (norm + 1e-6),
``torch.nn.utils.clip_grad_norm_``), and ``torch.optim.AdamW`` with decay on
the weights of two or more dimensions only, the learning rate of the cosine
schedule with linear warmup.

Everything is fp32 with TF32 off (``precision="fp32"``). Attention runs in
blocks of query rows with a backward written out (``_Attention``), so that no
(T, T) score matrix of a whole sequence is held; the loss and its backward run
in blocks of rows of each micro-batch. Neither changes the mathematics.

``precision`` also gives the controls, the reference computed one precision
below what the configuration states: ``"tf32"`` (the tensor cores' TF32
products, for an fp32 configuration; CUDA only) and ``"fp8"`` (every
product's operands, forward and backward, rounded to float8 e4m3 with one
absmax scale a tensor, for a bf16 configuration).
"""

from __future__ import annotations

import contextlib
import math

import numpy as np
import torch
import torch.nn.functional as F

PRECISIONS = ("fp32", "tf32", "fp8")
ATTN_BLOCK = 1024  # query rows per attention block
FP8_MAX = 448.0  # largest float8 e4m3fn value


def _round_fp8(x):
    scale = x.abs().amax().clamp(min=1e-30) / FP8_MAX
    return (x / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


class Rounding:
    """What a product's operands go through under ``precision``."""

    def __init__(self, precision: str, device):
        if precision not in PRECISIONS:
            raise ValueError(f"precision {precision!r} is not one of {PRECISIONS}")
        if precision == "tf32" and torch.device(device).type != "cuda":
            raise ValueError("the TF32 control runs on the tensor cores: it needs a CUDA device")
        self.precision = precision
        self.tf32 = precision == "tf32"

    def __call__(self, x):
        return _round_fp8(x) if self.precision == "fp8" else x

    @property
    def exact(self) -> bool:
        return self.precision != "fp8"

    @contextlib.contextmanager
    def matmul_flags(self):
        """TF32 off for fp32 (and for fp8's fp32 products), on for the
        hardware TF32 control; the flags restored on exit."""
        old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = self.tf32
        torch.backends.cudnn.allow_tf32 = self.tf32
        try:
            yield
        finally:
            torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


class _Matmul(torch.autograd.Function):
    """a @ b with every product's operands rounded, forward and backward."""

    @staticmethod
    def forward(ctx, a, b, r):
        ra, rb = r(a), r(b)
        ctx.save_for_backward(ra, rb)
        ctx.r = r
        return ra @ rb

    @staticmethod
    def backward(ctx, dy):
        ra, rb = ctx.saved_tensors
        rdy = ctx.r(dy)
        return rdy @ rb.transpose(-1, -2), ra.transpose(-1, -2) @ rdy, None


def matmul(a, b, r: Rounding):
    return a @ b if r.exact else _Matmul.apply(a, b, r)


class _Attention(torch.autograd.Function):
    """Causal softmax attention over (B, H, T, hs), in blocks of query rows;
    the backward recomputes each block's probabilities from the saved
    log-sum-exp."""

    @staticmethod
    def forward(ctx, q, k, v, r):
        t, hs = q.shape[-2], q.shape[-1]
        scale = hs ** -0.5
        o = torch.empty_like(q)
        lse = q.new_empty(q.shape[:-1])
        for i0 in range(0, t, ATTN_BLOCK):
            i1 = min(t, i0 + ATTN_BLOCK)
            s = (r(q[..., i0:i1, :]) @ r(k[..., :i1, :]).transpose(-1, -2)) * scale
            s = s.masked_fill(_mask(i0, i1, q.device), float("-inf"))
            lse[..., i0:i1] = torch.logsumexp(s, dim=-1)
            p = torch.exp(s - lse[..., i0:i1, None])
            o[..., i0:i1, :] = r(p) @ r(v[..., :i1, :])
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.r = r
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        r = ctx.r
        t, hs = q.shape[-2], q.shape[-1]
        scale = hs ** -0.5
        dq, dk, dv = torch.zeros_like(q), torch.zeros_like(k), torch.zeros_like(v)
        dsum = (do * o).sum(-1)
        for i0 in range(0, t, ATTN_BLOCK):
            i1 = min(t, i0 + ATTN_BLOCK)
            qb, kb, vb, dob = q[..., i0:i1, :], k[..., :i1, :], v[..., :i1, :], do[..., i0:i1, :]
            s = (r(qb) @ r(kb).transpose(-1, -2)) * scale
            s = s.masked_fill(_mask(i0, i1, q.device), float("-inf"))
            p = torch.exp(s - lse[..., i0:i1, None])
            dv[..., :i1, :] += r(p).transpose(-1, -2) @ r(dob)
            dp = r(dob) @ r(vb).transpose(-1, -2)
            ds = p * (dp - dsum[..., i0:i1, None]) * scale
            dq[..., i0:i1, :] = r(ds) @ r(kb)
            dk[..., :i1, :] += r(ds).transpose(-1, -2) @ r(qb)
        return dq, dk, dv, None


def _mask(i0, i1, device):
    qpos = torch.arange(i0, i1, device=device)[:, None]
    return torch.arange(i1, device=device)[None, :] > qpos


def _linear(x, w, b, r):
    y = matmul(x, w.t(), r)
    return y if b is None else y + b


def nll_sum(params: dict, x, y, dims: dict, r: Rounding):
    """Summed next-token NLL of rows x (b, T) against targets y (b, T), the
    logits over the padded vocabulary."""
    bsz, t = x.shape
    c, nh = dims["n_embd"], dims["n_head"]
    eps = dims["eps"]
    h = params["transformer.wte.weight"][x] + params["transformer.wpe.weight"][:t]
    for i in range(dims["n_layer"]):
        p = lambda n: params[f"transformer.h.{i}.{n}"]  # noqa: E731
        a = F.layer_norm(h, (c,), p("ln_1.weight"), p("ln_1.bias"), eps)
        qkv = _linear(a, p("attn.c_attn.weight"), p("attn.c_attn.bias"), r)
        q, k, v = (z.view(bsz, t, nh, c // nh).transpose(1, 2) for z in qkv.split(c, dim=-1))
        att = _Attention.apply(q, k, v, r).transpose(1, 2).reshape(bsz, t, c)
        h = h + _linear(att, p("attn.c_proj.weight"), p("attn.c_proj.bias"), r)
        m = F.layer_norm(h, (c,), p("ln_2.weight"), p("ln_2.bias"), eps)
        f = F.gelu(_linear(m, p("mlp.c_fc.weight"), p("mlp.c_fc.bias"), r), approximate="tanh")
        h = h + _linear(f, p("mlp.c_proj.weight"), p("mlp.c_proj.bias"), r)
    h = F.layer_norm(h, (c,), params["transformer.ln_f.weight"], params["transformer.ln_f.bias"],
                     eps)
    logits = matmul(h.reshape(-1, c), params["transformer.wte.weight"].t(), r)
    return F.cross_entropy(logits, y.reshape(-1), reduction="sum")


def lr_at(step: int, sched: dict) -> float:
    """Cosine decay with linear warmup (the reference script's get_lr)."""
    if step < sched["warmup_steps"]:
        return sched["max_lr"] * (step + 1) / sched["warmup_steps"]
    if step > sched["max_steps"]:
        return sched["min_lr"]
    ratio = (step - sched["warmup_steps"]) / (sched["max_steps"] - sched["warmup_steps"])
    return sched["min_lr"] + 0.5 * (1.0 + math.cos(math.pi * ratio)) * (
        sched["max_lr"] - sched["min_lr"])


def train_steps(weights: dict, rows: np.ndarray, dims: dict, optim: dict, sched: dict, *,
                precision: str = "fp32", block_tokens: int = 4096,
                keep_share: float = 1e-3, kept: dict | None = None,
                keep_params: bool = False) -> dict:
    """Run len(rows) steps from ``weights`` (name -> fp32 tensor, left as
    they are) on ``rows`` (steps, accum, B, T + 1) and return the readings
    the comparison takes:

      * ``loss``: each step's mean loss (the mean over micro-batches of each
        micro-batch's mean);
      * ``grad``: name -> the norm of the first step's gradient as AdamW gets
        it (the mean over micro-batches, clipped);
      * ``raw_grad``: name -> the norm of the first step's mean gradient
        before the clip;
      * ``kept``: name -> a bool tensor, the elements held to the change: those
        whose first mean gradient is at least ``keep_share`` of the median
        leaf's root-mean-square one (the others, as a key's bias under the
        softmax, move under Adam by round-off alone);
      * ``change``: name -> the norm of the parameter's change over all the
        steps, over its kept elements.

    ``block_tokens``: the tokens of one forward and backward (whole rows,
    at least one). ``kept``: the elements to take the change over, another
    run's, in place of this run's own. ``keep_params``: also return the
    parameters after the steps (``params``)."""
    device = next(iter(weights.values())).device
    r = Rounding(precision, device)
    params = {n: w.detach().clone().requires_grad_(True) for n, w in weights.items()}
    decay = [p for p in params.values() if p.dim() >= 2]
    no_decay = [p for p in params.values() if p.dim() < 2]
    opt = torch.optim.AdamW(
        [{"params": decay, "weight_decay": optim["weight_decay"]},
         {"params": no_decay, "weight_decay": 0.0}],
        lr=sched["max_lr"], betas=(optim["beta1"], optim["beta2"]), eps=optim["eps"],
        foreach=False, fused=False)
    steps, accum, bsz, t1 = rows.shape
    t = t1 - 1
    per_block = max(1, block_tokens // t)
    out = {"loss": []}
    with r.matmul_flags():
        for s in range(steps):
            opt.zero_grad(set_to_none=True)
            loss = 0.0
            for a in range(accum):
                ids = torch.from_numpy(rows[s, a]).to(device)
                for b0 in range(0, bsz, per_block):
                    blk = ids[b0:b0 + per_block]
                    nll = nll_sum(params, blk[:, :-1], blk[:, 1:], dims, r)
                    (nll / (bsz * t * accum)).backward()
                    loss += float(nll.detach()) / (bsz * t * accum)
            out["loss"].append(loss)
            if s == 0:
                grads = {n: p.grad for n, p in params.items()}
                out["raw_grad"] = _norms(grads)
                rms = sorted(out["raw_grad"][n] / math.sqrt(g.numel()) for n, g in grads.items())
                floor = keep_share * float(np.median(rms))
                out["kept"] = kept or {n: g.abs() >= floor for n, g in grads.items()}
                out["left_out"] = {n: int(k.numel() - k.sum()) for n, k in out["kept"].items()
                                   if not bool(k.all())}
            torch.nn.utils.clip_grad_norm_(list(params.values()), optim["grad_clip"],
                                           foreach=False)
            if s == 0:
                out["grad"] = _norms({n: p.grad for n, p in params.items()})
            for group in opt.param_groups:
                group["lr"] = lr_at(s, sched)
            opt.step()
    with torch.no_grad():
        out["change"] = _norms({n: (params[n] - weights[n])[out["kept"][n]] for n in params})
    if keep_params:
        out["params"] = {n: p.detach() for n, p in params.items()}
    return out


def _norms(tensors: dict) -> dict:
    names = list(tensors)
    vals = torch.stack([tensors[n].detach().double().norm() for n in names]).tolist()
    return dict(zip(names, vals))
