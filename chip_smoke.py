"""Drive the PyTorch/H100 port once on one CUDA card and check it.

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):

  1. build the CUDA kernels from gpt2_vision_language_tpu_torch/csrc;
  2. flash-attention forward kernel vs its plain version, bf16, at the
     scoring shape (B=8, T=1024, H=12, hs=64, causal, q/k/v strided views of
     the fused QKV output) and at a ragged T=1000;
  3. fused LM-head + CE forward kernel vs its plain version at N=8192,
     D=768, V=50304 (targets include the last vocab tile) and a ragged N=1000;
  4. the scoring forward: GPT-2 124M with seeded random weights, fp32
     params, bf16 policy, train.step.make_eval_step over 2 micro-batches of
     B=8, T=1024; the launch counters must show 12 flash and 1 CE launch per
     micro-batch, and the loss must agree with the plain-path run;
  5. generation: cli.sample, cached-vs-uncached logits under the fp32
     policy, cli.bench_decode at B=50, and ops.layers.matmul_f32 on batched
     bf16 operands of the decode shape against the fp32 product;
  6. flash-attention backward kernel vs its plain version at the training
     shape (B=8, T=1024, H=12, hs=64, causal, strided q/k/v) and T=1000,
     and one attention layer's forward + backward through autograd;
  7. AdamW kernel vs its plain version over every parameter of GPT-2 124M;
  8. the train step: GPT-2 124M, fp32 params, bf16 policy,
     train.step.make_train_step with the AdamW kernel, 4 x (B=8, T=1024) per
     step, 3 steps; 12 flash forward and 12 flash backward launches per
     micro-batch and 1 AdamW launch per step; then one step at the peak LR
     on each path from one state (loss, grad norm and grads against the
     plain paths; the update against the plain AdamW on the same grads,
     with controls that must fail); K4 in the training forward timed;
  9. the trainer entry point: cli.pretrain --synthetic for 3 steps of
     64 x 1024 tokens (CSV rows, checkpoints), then --steps 4 resumes at
     step 3 and runs one step;
 10. the general (Tq != Tk, streamed K/V) flash kernels vs their plain
     versions, forward (o, lse) and backward (D, dq, dk/dv), at (B, Tq, Tk)
     = (2, 4096, 4096), (2, 1000, 1000), (2, 64, 2048) causal and not,
     (4, 1, 1500), all H=12, and at the long-context shape B=1, T=16384,
     H=12 against the plain versions run two heads at a time;
 11. the general kernels against the self-attention kernels on the same
     inputs at B=8, T=1024 and B=2, T=4096 (times only printed);
 12. library-call probes, timed only and never a route of the port:
     F.scaled_dot_product_attention forward and backward at B=8, T=1024 and
     B=1, T=16384, torch.optim.AdamW(fused=True) over the 148 leaves;
 13. the long-context train step: GPT-2 124M with block_size 16384,
     make_train_step at B=1, T=16384, 2 micro-batches a step, 3 steps; 12
     general forward, 12 D, 12 dq and 12 dk/dv launches per micro-batch, none
     of the self-attention kernels, 1 AdamW launch a step; then at 2 layers
     and T=8320 one step on the kernel path and on the plain paths from one
     state (loss, grad norm, grads, the update, with controls);
 14. the long-context trainer: cli.pretrain --synthetic --seq-len 16384
     --micro-batch 1 --total-batch 32768 --steps 3 with a synthetic
     HellaSwag file in $HELLASWAG_DIR (validation on the general forward and
     the CE kernel, 'hella' rows, checkpoints), then --steps 4 resumes.

Prints the card's name and power limit, one JSON line with each kernel's
launches (from the trainer runs of phases 9 and 14), error, times, bound and
library-call time, and last {"ok": true, "device": {...}}. Exits non-zero,
printing no result, without a CUDA device.
"""

from __future__ import annotations

import copy
import dataclasses
import glob
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time


def require(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def cuda_ms(fn, iters):
    """Mean device milliseconds of fn() over iters launches (after one
    warm-up), from CUDA events."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def interleaved(kernel_fn, plain_fn, iters_kernel, iters_plain):
    """plain, kernel, kernel, plain; returns (kernel ms, plain ms), each the
    mean of its two runs."""
    p1 = cuda_ms(plain_fn, iters_plain)
    k1 = cuda_ms(kernel_fn, iters_kernel)
    k2 = cuda_ms(kernel_fn, iters_kernel)
    p2 = cuda_ms(plain_fn, iters_plain)
    print(f"  timings ms: plain {p1:.4f}, kernel {k1:.4f}, kernel {k2:.4f}, "
          f"plain {p2:.4f}", flush=True)
    return (k1 + k2) / 2, (p1 + p2) / 2


def phase_flash(torch, fa, dev):
    print("[2] flash-attention forward vs plain (bf16)", flush=True)
    out_tol, lse_tol = 2e-2, 1e-3  # bf16 P.V rounding; fp32 softmax stats
    g = torch.Generator(dev).manual_seed(0)
    errs = {"o": 0.0, "lse": 0.0}
    timing = None
    for t in (1024, 1000):
        b, h, hs = 8, 12, 64
        qkv = torch.randn(b, t, 3 * h * hs, device=dev, generator=g).to(torch.bfloat16)
        q, k, v = (a.view(b, t, h, hs) for a in qkv.split(h * hs, dim=-1))
        o, lse = fa.flash_attention(q, k, v, causal=True, return_lse=True)
        ro, rlse = fa.flash_attention_reference(q, k, v, causal=True)
        torch.cuda.synchronize()
        eo = (o.float() - ro.float()).abs().max().item()
        el = (lse - rlse).abs().max().item()
        print(f"  B={b} T={t} H={h} hs={hs}: out max|err| {eo:.3e} (tol {out_tol}), "
              f"lse max|err| {el:.3e} (tol {lse_tol})", flush=True)
        require(eo <= out_tol and el <= lse_tol, f"flash T={t} disagrees")
        errs["o"], errs["lse"] = max(errs["o"], eo), max(errs["lse"], el)
        if t == 1024:
            timing = interleaved(
                lambda: fa.flash_attention(q, k, v, causal=True),
                lambda: fa.flash_attention_reference(q, k, v, causal=True),
                50, 5,
            )
    return errs, timing


def phase_ce(torch, fc, dev):
    print("[3] fused LM-head + CE forward vs plain", flush=True)
    tol = 2e-3  # fp32 logits both ways; only the sum order differs
    g = torch.Generator(dev).manual_seed(1)
    d, v = 768, 50304
    w = (torch.randn(v, d, device=dev, generator=g) * 0.02).to(torch.bfloat16)
    err, timing = 0.0, None
    for n in (8192, 1000):
        x = torch.randn(n, d, device=dev, generator=g).to(torch.bfloat16)
        t = torch.randint(0, v, (n,), device=dev, generator=g, dtype=torch.int32)
        t[:47] = torch.arange(50257, v, device=dev, dtype=torch.int32)  # last tile
        nll, lse = fc.ce_forward(x, w, t)
        rnll, rlse = fc.ce_forward_reference(x, w, t, n_chunks=8)
        torch.cuda.synchronize()
        en = (nll - rnll).abs().max().item()
        el = (lse - rlse).abs().max().item()
        print(f"  N={n} D={d} V={v}: nll max|err| {en:.3e}, lse max|err| {el:.3e} "
              f"(tol {tol})", flush=True)
        require(en <= tol and el <= tol, f"fused CE N={n} disagrees")
        err = max(err, en, el)
        if n == 8192:
            timing = interleaved(
                lambda: fc.ce_forward(x, w, t),
                lambda: fc.ce_forward_reference(x, w, t, n_chunks=8),
                10, 3,
            )
            bf16_route = cuda_ms(
                lambda: fc.fused_linear_ce(x, w, t, n_chunks=8, impl="xla"), 3
            )
            print(f"  the plain route of fused_linear_ce (bf16 logits, impl='xla'): "
                  f"{bf16_route:.4f} ms", flush=True)
    return err, timing


def rel_err(a, ref):
    """max |a - ref| / max |ref|, in fp32."""
    return ((a.float() - ref.float()).abs().max() / ref.float().abs().max()).item()


def phase_matmul_f32(torch, layers, dev):
    print("[5] matmul_f32 on batched bf16 operands (decode shape)", flush=True)
    tol = 1e-5  # products of bf16 values are exact in fp32; sum order only
    g = torch.Generator(dev).manual_seed(5)
    a = torch.randn(50, 12, 1, 64, device=dev, generator=g).to(torch.bfloat16)
    b = torch.randn(50, 12, 64, 60, device=dev, generator=g).to(torch.bfloat16)
    got = layers.matmul_f32(a, b)
    err = rel_err(got, torch.matmul(a.float(), b.float()))
    print(f"  (50, 12, 1, 64) @ (50, 12, 64, 60): dtype {got.dtype}, max|err| / max|ref| "
          f"{err:.3e} (tol {tol})", flush=True)
    require(got.dtype == torch.float32 and err <= tol, "batched matmul_f32 is not fp32-exact")
    return err


def phase_flash_bwd(torch, fa, attention, dev):
    print("[6] flash-attention backward vs plain (bf16)", flush=True)
    tol = 3e-2  # max|err| / max|ref|; P and dS round to bf16 in the kernel
    g = torch.Generator(dev).manual_seed(6)
    err, timing = 0.0, None
    for t in (1024, 1000):
        b, h, hs = 8, 12, 64
        qkv = torch.randn(b, t, 3 * h * hs, device=dev, generator=g).to(torch.bfloat16)
        q, k, v = (a.view(b, t, h, hs) for a in qkv.split(h * hs, dim=-1))
        o, lse = fa.flash_attention(q, k, v, causal=True, return_lse=True)
        do = torch.randn(b, t, h, hs, device=dev, generator=g).to(torch.bfloat16)
        got = fa.flash_attention_backward(q, k, v, o, lse, do, causal=True)
        want = fa.flash_attention_backward_reference(q, k, v, o, lse, do, causal=True)
        torch.cuda.synchronize()
        errs = [rel_err(x, r) for x, r in zip(got, want)]
        print(f"  B={b} T={t} H={h} hs={hs}: dq, dk, dv max|err| / max|ref| "
              + ", ".join(f"{e:.3e}" for e in errs) + f" (tol {tol})", flush=True)
        require(max(errs) <= tol, f"flash backward T={t} disagrees")
        err = max(err, *errs)
        if t == 1024:
            timing = interleaved(
                lambda: fa.flash_attention_backward(q, k, v, o, lse, do, causal=True),
                lambda: fa.flash_attention_backward_reference(q, k, v, o, lse, do,
                                                              causal=True),
                50, 3,
            )
            leaf = qkv.detach().requires_grad_(True)

            def layer(impl):
                def run():
                    qq, kk, vv = (a.view(b, t, h, hs) for a in leaf.split(h * hs, dim=-1))
                    y = attention.sdpa(qq, kk, vv, causal=True, impl=impl, layout="bthd")
                    y.backward(do)
                    leaf.grad = None
                return run

            fb = interleaved(layer("flash"), layer("xla"), 20, 3)
            print(f"  one attention layer, forward + backward through autograd: "
                  f"kernels {fb[0]:.4f} ms, plain {fb[1]:.4f} ms", flush=True)
    return err, timing


def phase_adamw(torch, gpt2, fw, schedule, cfgs, dev):
    print("[7] AdamW kernel vs plain over GPT-2 124M", flush=True)
    tol = 1e-6  # max|err| / max|ref|; fp32 both ways, FMA contraction only
    model = gpt2.init(cfgs["gpt"], generator=torch.Generator(dev).manual_seed(7), device=dev)
    params = gpt2.named_params(model)
    mask = gpt2.decay_mask(model)
    g = torch.Generator(dev).manual_seed(8)
    names = list(params)
    leaves = [(params[n].detach().clone(), torch.randn(params[n].shape, device=dev, generator=g),
               torch.randn(params[n].shape, device=dev, generator=g) * 1e-2,
               torch.rand(params[n].shape, device=dev, generator=g) * 1e-4) for n in names]
    ref = [tuple(a.clone() for a in leaf) for leaf in leaves]
    ocfg = cfgs["opt"]
    step = 10
    bc1, bc2 = 1 - ocfg.beta1 ** step, 1 - ocfg.beta2 ** step
    lr = schedule.cosine_warmup_lr(step, cfgs["sched"])
    scal = torch.tensor([lr, ocfg.beta1, ocfg.beta2, ocfg.eps, 0.5, bc1, bc2],
                        dtype=torch.float32, device=dev)
    wds = [ocfg.weight_decay if mask[n] else 0.0 for n in names]
    fw.fused_adamw(leaves, scal, wds)
    for (p, gr, m, v), wd in zip(ref, wds):
        fw.adamw_reference(p, gr, m, v, scal, wd=wd)
    torch.cuda.synchronize()
    err = max(rel_err(a, r) for leaf, rleaf in zip(leaves, ref) for a, r in zip(leaf, rleaf))
    n = sum(p.numel() for p in params.values())
    print(f"  {len(names)} leaves, {n:,} params, step {step}: p, m, v max|err| / max|ref| "
          f"{err:.3e} (tol {tol})", flush=True)
    require(err <= tol, "AdamW kernel disagrees")

    def plain():
        for (p, gr, m, v), wd in zip(ref, wds):
            fw.adamw_reference(p, gr, m, v, scal, wd=wd)

    timing = interleaved(lambda: fw.fused_adamw(leaves, scal, wds), plain, 20, 5)
    gbytes = n * 4 * 7 / 1e9  # p, g, m, v read; p, m, v written
    print(f"  {gbytes:.3f} GB moved per update: kernel {gbytes / timing[0] * 1e3:.1f} GB/s, "
          f"plain {gbytes / timing[1] * 1e3:.1f} GB/s", flush=True)
    return err, timing


def _counters(fa, fc, fw):
    return {"flash_fwd": fa.flash_attention, "flash_bwd": fa.flash_attention_backward,
            "ce_fwd": fc.ce_forward, "adamw": fw.fused_adamw,
            "flash_general_fwd": fa.flash_general_forward, "flash_rowdot": fa.flash_rowdot,
            "flash_general_dq": fa.flash_general_dq, "flash_general_dkv": fa.flash_general_dkv}


def reset_counts(fa, fc, fw):
    for fn in _counters(fa, fc, fw).values():
        fn.launches = 0


def read_counts(fa, fc, fw):
    return {name: fn.launches for name, fn in _counters(fa, fc, fw).items()}


def with_zeros(counts):
    """Expected launch counts: the named ones, every other kernel 0."""
    return {**dict.fromkeys(("flash_fwd", "flash_bwd", "ce_fwd", "adamw", "flash_general_fwd",
                             "flash_rowdot", "flash_general_dq", "flash_general_dkv"), 0),
            **counts}


def update_err(delta, ref):
    """max |delta - ref| / max |ref| over dicts of tensors."""
    num = max((delta[n] - r).abs().max().item() for n, r in ref.items())
    return num / max(r.abs().max().item() for r in ref.values())


def compare_train_steps(torch, gpt2, mods, cfgs, kernel, plain, batch):
    """One step on each path from one state (params and moments after the
    kernel path's steps) and one batch, at the schedule's peak LR.

    Gradients: the two paths' accumulated .grad, as a relative L2 error.
    Update: the kernel path's parameter change against the plain AdamW
    replayed on the same state with the kernel path's own gradients, as
    max|err| / max|ref|. Adam divides each grad by its own running
    magnitude, so a grad that is all rounding noise on one path moves its
    param by up to the LR on either path: the update is compared on one set
    of grads, the grads on their own. Controls (no update, no weight decay,
    no clipping) show the update limit sees each of those."""
    (model, state_k, step_k), (plain_model, state_p, step_p) = kernel, plain
    fa, fc, fw = mods["fa"], mods["fc"], mods["fw"]
    ocfg = cfgs["opt"]
    g_tol, upd_tol = 2e-2, 1e-3
    params_k, params_p = gpt2.named_params(model), gpt2.named_params(plain_model)
    with torch.no_grad():
        for n, p in params_k.items():
            params_p[n].copy_(p)
        for key in ("m", "v"):
            for n, a in state_k[key].items():
                state_p[key][n].copy_(a)
    state_p["step"] = state_k["step"]
    before = {n: p.detach().clone() for n, p in params_k.items()}
    saved = {"m": {n: a.clone() for n, a in state_k["m"].items()},
             "v": {n: a.clone() for n, a in state_k["v"].items()}, "step": state_k["step"]}
    idx = cfgs["sched"].warmup_steps  # the peak LR
    mk = step_k(model, state_k, batch, idx)
    counts = read_counts(fa, fc, fw)
    mp = step_p(plain_model, state_p, batch, idx)
    require(read_counts(fa, fc, fw) == counts, "the plain-path step launched a kernel")

    dl = abs(mk["loss"] - mp["loss"])
    dn = abs(mk["grad_norm"] - mp["grad_norm"]) / mp["grad_norm"]
    grads = {n: p.grad for n, p in params_k.items()}
    sq = lambda ts: sum(t.float().square().sum().item() for t in ts)  # noqa: E731
    dg = math.sqrt(sq(grads[n] - p.grad for n, p in params_p.items())
                   / sq(p.grad for p in params_p.values()))
    print(f"  kernel vs plain paths (attn 'xla', CE 'xla', AdamW plain), one step from "
          f"one state at lr {mk['lr']:.4e}: loss {mk['loss']:.6f} vs {mp['loss']:.6f} "
          f"(|diff| {dl:.3e}, tol 1e-2), grad_norm {mk['grad_norm']:.6f} vs "
          f"{mp['grad_norm']:.6f} (rel diff {dn:.3e}, tol 2e-2), grads ||err|| / ||ref|| "
          f"{dg:.3e} (tol {g_tol})", flush=True)
    require(dl <= 1e-2 and dn <= 2e-2 and dg <= g_tol, "kernel and plain train steps disagree")

    inv = 1.0 / batch.shape[0]
    norm = mods["global_norm"](grads) * inv
    mask = gpt2.decay_mask(model)

    def replay(opt_cfg, decay_mask):
        p = {n: a.clone() for n, a in before.items()}
        st = {"m": {n: a.clone() for n, a in saved["m"].items()},
              "v": {n: a.clone() for n, a in saved["v"].items()}, "step": saved["step"]}
        mods["adamw_update"](p, grads, st, mk["lr"], opt_cfg, norm=norm, decay_mask=decay_mask,
                             use_fused=False, grad_scale=inv)
        return {n: p[n] - before[n] for n in p}

    with torch.no_grad():
        ref = replay(ocfg, mask)
        delta = {n: p.detach() - before[n] for n, p in params_k.items()}
        err = update_err(delta, ref)
        controls = {
            "no update": update_err({n: torch.zeros_like(r) for n, r in ref.items()}, ref),
            "no weight decay": update_err(replay(ocfg, {n: False for n in mask}), ref),
        }
        clip_on = norm.item() > ocfg.grad_clip
        if clip_on:
            controls["no clipping"] = update_err(
                replay(dataclasses.replace(ocfg, grad_clip=math.inf), mask), ref)
    print(f"  update: kernel path vs plain AdamW on its grads, max|err| / max|ref| "
          f"{err:.3e} (tol {upd_tol}; max|ref| {max(r.abs().max().item() for r in ref.values()):.4e}); "
          f"controls " + ", ".join(f"{k} {v:.3e}" for k, v in controls.items())
          + ("" if clip_on else " (the clip was inactive)"), flush=True)
    require(err <= upd_tol, "the kernel path's update differs from the plain AdamW's")
    require(all(v > upd_tol for v in controls.values()),
            "a control update passed the update check: the check cannot see it")


def phase_train_step(torch, np, gpt2, mods, cfgs, dev):
    print("[8] train step: GPT-2 124M, bf16 policy, 4 x (B=8, T=1024) per step", flush=True)
    fa, fc, fw = mods["fa"], mods["fc"], mods["fw"]
    cfg = cfgs["gpt"]
    accum, b, t = 4, 8, 1024
    model = gpt2.init(cfg, generator=torch.Generator(dev).manual_seed(1337), device=dev)
    plain_model = copy.deepcopy(model)
    rows = np.random.RandomState(2).randint(0, cfg.vocab_size, (accum, b, t + 1))
    batch = torch.from_numpy(rows.astype(np.int32)).to(dev)

    def loss_fn(attn_impl, ce_impl):
        return lambda m, r: gpt2.loss(m, r[:, :-1], cfg, targets=r[:, 1:],
                                      policy=mods["policy"], attn_impl=attn_impl,
                                      ce_chunks=1, ce_impl=ce_impl)

    def make(model, attn_impl, ce_impl, fused):
        step = mods["make_train_step"](loss_fn(attn_impl, ce_impl), cfgs["opt"], cfgs["sched"],
                                       decay_mask=gpt2.decay_mask(model),
                                       use_fused_adamw=fused)
        return step, mods["adamw_init"](gpt2.named_params(model))

    step_k, state_k = make(model, "auto", "auto", True)
    step_p, state_p = make(plain_model, "xla", "xla", False)
    n_tok = accum * b * t
    reset_counts(fa, fc, fw)
    per_step = with_zeros({"flash_fwd": accum * cfg.n_layer,
                           "flash_bwd": accum * cfg.n_layer, "adamw": 1})
    metrics, times = [], []
    for i in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        metrics.append(step_k(model, state_k, batch, i))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        counts = read_counts(fa, fc, fw)
        print(f"  step {i}: loss {metrics[-1]['loss']:.6f}, grad_norm "
              f"{metrics[-1]['grad_norm']:.6f}, lr {metrics[-1]['lr']:.4e}, "
              f"{n_tok / times[-1]:.1f} tokens/s; launches {counts}", flush=True)
        require(counts == {k: (i + 1) * v for k, v in per_step.items()},
                f"expected {per_step} launches per step, got {counts} after {i + 1}")
        require(math.isfinite(metrics[-1]["loss"]) and math.isfinite(metrics[-1]["grad_norm"]),
                "train loss or grad norm is not finite")
        if i == 0:
            ln_v = math.log(cfg.padded_vocab_size)
            require(abs(metrics[0]["loss"] - ln_v) < 0.5, "first loss is not near ln(V)")
    main_counts = read_counts(fa, fc, fw)
    compare_train_steps(torch, gpt2, mods, cfgs, (model, state_k, step_k),
                        (plain_model, state_p, step_p), batch)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    step_p(plain_model, state_p, batch, 1)
    torch.cuda.synchronize()
    plain_tps = n_tok / (time.perf_counter() - t0)
    kernel_tps = n_tok / (sum(times[1:]) / 2)
    print(f"  tokens/s: kernel path {kernel_tps:.1f} (steps 1-2), plain paths "
          f"{plain_tps:.1f} (step 1)", flush=True)
    del plain_model, state_p

    # K4 in the training forward: one micro-batch forward + backward
    micro = batch[0]

    def fwd_bwd(ce_impl):
        def run():
            loss_fn("auto", ce_impl)(model, micro).backward()
            for p in model.parameters():
                p.grad = None
        return run

    saved = fc.ce_forward.launches
    k4 = interleaved(fwd_bwd("kernel"), fwd_bwd("auto"), 3, 3)
    require(fc.ce_forward.launches > saved, "ce_impl='kernel' did not launch K4")
    print(f"  one micro-batch forward + backward: CE 'kernel' (K4 forward) {k4[0]:.4f} ms, "
          f"CE 'auto' (plain chunked forward) {k4[1]:.4f} ms", flush=True)
    return {"kernel_tps": kernel_tps, "plain_tps": plain_tps, "counts": main_counts}


def phase_trainer(torch, mods, cfgs):
    print("[9] trainer: cli.pretrain --synthetic, 3 steps of 65,536 tokens, then resume",
          flush=True)
    fa, fc, fw = mods["fa"], mods["fc"], mods["fw"]
    cfg = cfgs["gpt"]
    log_dir = tempfile.mkdtemp(prefix="chip_smoke_pretrain_")
    old_tmp = tempfile.tempdir
    tempfile.tempdir = log_dir  # the synthetic shards go under it too
    try:
        argv = ["--synthetic", "--total-batch", "65536", "--no-hellaswag",
                "--log-dir", os.path.join(log_dir, "log")]
        reset_counts(fa, fc, fw)
        t0 = time.perf_counter()
        out = mods["pretrain"].main(argv + ["--steps", "3"])
        dt = time.perf_counter() - t0
        counts = read_counts(fa, fc, fw)
        accum, val_steps = 8, 20
        want = with_zeros({"flash_fwd": cfg.n_layer * (3 * accum + 2 * val_steps),
                           "flash_bwd": cfg.n_layer * 3 * accum, "ce_fwd": 2 * val_steps,
                           "adamw": 3})
        print(f"  3 steps in {dt:.1f} s (val at steps 0 and 2, samples, checkpoints); "
              f"launches {counts}", flush=True)
        require(counts == want, f"expected launches {want}, got {counts}")
        require(out["opt_state"]["step"] == 3 and math.isfinite(out["val_loss"]),
                "the trainer did not take 3 finite steps")
        rows = [line.split(",") for f in sorted(glob.glob(os.path.join(log_dir, "log", "*.csv")))
                for line in open(f).read().splitlines()[1:]]
        phases = [r[1] for r in rows]
        print(f"  CSV: {phases.count('train')} train rows, {phases.count('val')} val rows",
              flush=True)
        require(phases.count("train") == 3 and phases.count("val") >= 1,
                "the CSV does not hold 3 train rows and a val row")
        ckpts = sorted(os.listdir(os.path.join(log_dir, "log", "ckpts")))
        print(f"  checkpoints: {ckpts}", flush=True)
        require("model_final.pt" in ckpts, "model_final was not written")

        reset_counts(fa, fc, fw)
        out = mods["pretrain"].main(argv + ["--steps", "4"])
        rows = [line.split(",") for f in sorted(glob.glob(os.path.join(log_dir, "log", "*.csv")))
                for line in open(f).read().splitlines()[1:]]
        steps = [int(r[2]) for r in rows if r[1] == "train"]
        print(f"  resumed: train steps logged {steps}, AdamW launches "
              f"{fw.fused_adamw.launches}, optimizer step {out['opt_state']['step']}",
              flush=True)
        require(steps == [0, 1, 2, 3] and fw.fused_adamw.launches == 1
                and out["opt_state"]["step"] == 4,
                "the second call did not resume at step 3 and run one step")
        return counts, phases.count("train")
    finally:
        tempfile.tempdir = old_tmp
        shutil.rmtree(log_dir, ignore_errors=True)


# Published peaks of one H100 SXM (NVIDIA's data sheet): bf16 dense tensor-core
# rate and HBM3 rate. A kernel's bound is the larger of its operations over the
# first and its bytes (each input read once, each output written once) over the
# second.
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_PER_S = 3.35e12


def bound_ms(flops, nbytes):
    """(least milliseconds the card could take, "operations" or "bytes")."""
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS * 1e3, nbytes / PEAK_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def attention_bound(kind, b, tq, tk, h, hs, causal):
    """Bound of one attention kernel on bf16 operands. Operations count the
    (query, key) pairs the mask leaves visible: two products in the forward
    (S, PV), five in the whole backward (S, dP, dV, dQ, dK), three of them for
    dq alone (S, dP, dQ) and four for dk/dv alone (S, dP, dV, dK)."""
    pairs = b * h * (tq * (tk - tq) + tq * (tq + 1) // 2 if causal else tq * tk)
    n_q, n_k, stats = b * tq * h * hs, b * tk * h * hs, b * h * tq * 4
    products, q_like, k_like, n_stats = {
        "fwd": (2, 2, 2, 1),   # q, o; k, v; lse
        "bwd": (5, 4, 4, 1),   # q, o, dO, dq; k, v, dk, dv; lse
        "dq": (3, 3, 2, 2),    # q, dO, dq; k, v; lse, D
        "dkv": (4, 2, 4, 2),   # q, dO; k, v, dk, dv; lse, D
    }[kind]
    return bound_ms(2 * products * hs * pairs, 2 * (q_like * n_q + k_like * n_k)
                    + n_stats * stats)


def qkv_inputs(torch, b, tq, tk, h, dev, g):
    """bf16 q (B, Tq, H, 64) and k, v (B, Tk, H, 64), strided views of fused
    projections as the model makes them (one QKV tensor when Tq == Tk), and
    an output cotangent."""
    hs = 64
    if tq == tk:
        qkv = torch.randn(b, tq, 3 * h * hs, device=dev, generator=g).to(torch.bfloat16)
        q, k, v = (a.view(b, tq, h, hs) for a in qkv.split(h * hs, dim=-1))
    else:
        q = torch.randn(b, tq, h, hs, device=dev, generator=g).to(torch.bfloat16)
        kv = torch.randn(b, tk, 2 * h * hs, device=dev, generator=g).to(torch.bfloat16)
        k, v = (a.view(b, tk, h, hs) for a in kv.split(h * hs, dim=-1))
    do = torch.randn(b, tq, h, hs, device=dev, generator=g).to(torch.bfloat16)
    return q, k, v, do


def out_excess(o, ref):
    """(max|err|, the largest amount by which |err| passes max(2e-2, one bf16
    ulp of |ref|)): the kernel and the plain version both round o to bf16, so
    where |ref| > 2.56 one ulp (2^-7 |ref|) is more than 2e-2."""
    err = (o.float() - ref.float()).abs()
    allowed = (ref.float().abs() * 2.0 ** -7).clamp(min=2e-2)
    return err.max().item(), (err - allowed).max().item()


def plain_by_heads(torch, fa, q, k, v, do, o, lse, dd, causal, heads=2):
    """The plain forward and backward, `heads` heads at a time (their (B, H,
    Tq, Tk) fp32 score matrices do not fit at once at T=16384, H=12). Each
    plain version gets its kernel's inputs: the forward q, k, v; D the
    kernel's o; the backward the kernels' lse and D. Returns (o, lse, D, dq,
    dk, dv)."""
    parts = []
    for i in range(0, q.shape[2], heads):
        c = slice(i, i + heads)
        parts.append((
            *fa.flash_attention_reference(q[:, :, c], k[:, :, c], v[:, :, c], causal=causal),
            fa.rowdot_reference(do[:, :, c], o[:, :, c]),
            *fa.flash_attention_backward_reference(
                q[:, :, c], k[:, :, c], v[:, :, c], None, lse[:, c], do[:, :, c],
                causal=causal, dd=dd[:, c])))
    dims = (2, 1, 1, 2, 2, 2)  # the head axis of each
    return [torch.cat([p[j] for p in parts], dim=d) for j, d in enumerate(dims)]


def phase_general(torch, fa, dev):
    print("[10] general flash kernels (Tq != Tk, streamed K/V) vs plain (bf16)", flush=True)
    lse_tol, bwd_tol = 1e-3, 3e-2  # as the self-attention kernels
    dd_tol = 1e-5  # fp32 sums of the same 64 products in another order
    g = torch.Generator(dev).manual_seed(10)
    errs = {"o": 0.0, "lse": 0.0, "dd": 0.0, "dq": 0.0, "dkv": 0.0}
    shapes = [(2, 4096, 4096, 12, True), (2, 1000, 1000, 12, True), (2, 64, 2048, 12, True),
              (2, 64, 2048, 12, False), (4, 1, 1500, 12, True), (1, 16384, 16384, 12, True)]
    for b, tq, tk, h, causal in shapes:
        q, k, v, do = qkv_inputs(torch, b, tq, tk, h, dev, g)
        o, lse = fa.flash_attention(q, k, v, causal=causal, return_lse=True, stream_kv=True)
        dd = fa.flash_rowdot(do, o)
        dq = fa.flash_general_dq(q, k, v, do, lse, dd, causal=causal)
        dk, dv = fa.flash_general_dkv(q, k, v, do, lse, dd, causal=causal)
        ro, rlse, rdd, rdq, rdk, rdv = plain_by_heads(torch, fa, q, k, v, do, o, lse, dd,
                                                       causal)
        torch.cuda.synchronize()
        eo, excess = out_excess(o, ro)
        el = (lse - rlse).abs().max().item()
        ed = rel_err(dd, rdd)
        eq, ek, ev = rel_err(dq, rdq), rel_err(dk, rdk), rel_err(dv, rdv)
        finite = all(torch.isfinite(a.float()).all().item() for a in (o, lse, dd, dq, dk, dv))
        print(f"  B={b} Tq={tq} Tk={tk} H={h} causal={causal}: out max|err| {eo:.3e} (tol "
              f"2e-2 or one bf16 ulp), lse max|err| {el:.3e} (tol {lse_tol}), D "
              f"{ed:.3e} (tol {dd_tol}), dq, dk, dv max|err| / max|ref| {eq:.3e}, "
              f"{ek:.3e}, {ev:.3e} (tol {bwd_tol})", flush=True)
        require(finite, f"general kernels gave a non-finite value at Tq={tq} Tk={tk}")
        require(excess <= 0 and el <= lse_tol, f"general forward Tq={tq} Tk={tk} disagrees")
        require(ed <= dd_tol and max(eq, ek, ev) <= bwd_tol,
                f"general backward Tq={tq} Tk={tk} disagrees")
        for key, e in (("o", eo), ("lse", el), ("dd", ed), ("dq", eq), ("dkv", max(ek, ev))):
            errs[key] = max(errs[key], e)
    # times at the long-context shape (the last one above); the backward's
    # plain version computes dq, dk and dv together
    print(f"  times at B={b} T={tq} H={h} causal, plain two heads at a time:", flush=True)

    def plain_fwd():
        for i in range(0, h, 2):
            fa.flash_attention_reference(q[:, :, i:i + 2], k[:, :, i:i + 2], v[:, :, i:i + 2],
                                         causal=True)

    def plain_bwd():
        for i in range(0, h, 2):
            c = slice(i, i + 2)
            fa.flash_attention_backward_reference(q[:, :, c], k[:, :, c], v[:, :, c], None,
                                                  lse[:, c], do[:, :, c], causal=True,
                                                  dd=dd[:, c])

    times = {
        "fwd": interleaved(lambda: fa.flash_general_forward(q, k, v, causal=True),
                           plain_fwd, 5, 1),
        "dq": interleaved(lambda: fa.flash_general_dq(q, k, v, do, lse, dd, causal=True),
                          plain_bwd, 5, 1),
        "dkv": interleaved(lambda: fa.flash_general_dkv(q, k, v, do, lse, dd, causal=True),
                           plain_bwd, 5, 1),
        "rowdot": interleaved(lambda: fa.flash_rowdot(do, o),
                              lambda: fa.rowdot_reference(do, o), 20, 5),
    }
    return errs, times


def phase_general_vs_self(torch, fa, dev):
    print("[11] general kernels vs self-attention kernels on the same inputs", flush=True)
    g = torch.Generator(dev).manual_seed(11)
    out = {}
    for b, t in ((8, 1024), (2, 4096)):
        q, k, v, do = qkv_inputs(torch, b, t, t, 12, dev, g)
        o, lse = fa.flash_attention(q, k, v, causal=True, return_lse=True)
        og, lseg = fa.flash_attention(q, k, v, causal=True, return_lse=True, stream_kv=True)
        bs = fa.flash_attention_backward(q, k, v, o, lse, do, causal=True)
        bg = fa.flash_general_backward(q, k, v, o, lse, do, causal=True)
        torch.cuda.synchronize()
        same = (torch.equal(o, og) and torch.equal(lse, lseg)
                and all(torch.equal(x, y) for x, y in zip(bs, bg)))
        fwd = interleaved(lambda: fa.flash_attention(q, k, v, causal=True, stream_kv=True),
                          lambda: fa.flash_attention(q, k, v, causal=True), 20, 20)
        bwd = interleaved(lambda: fa.flash_general_backward(q, k, v, o, lse, do, causal=True),
                          lambda: fa.flash_attention_backward(q, k, v, o, lse, do, causal=True),
                          20, 20)
        print(f"  B={b} T={t} H=12 causal: forward general {fwd[0]:.4f} ms, self {fwd[1]:.4f} "
              f"ms; backward general (D + dq + dk/dv) {bwd[0]:.4f} ms, self {bwd[1]:.4f} ms; "
              f"results bit-identical: {same}", flush=True)
        require(max(rel_err(og, o), *(rel_err(x, y) for x, y in zip(bg, bs))) <= 1e-2,
                f"the two kernel families disagree at T={t}")
        out[f"B{b}_T{t}"] = {"general_fwd_ms": fwd[0], "self_fwd_ms": fwd[1],
                             "general_bwd_ms": bwd[0], "self_bwd_ms": bwd[1]}
    return out


def phase_library_probes(torch, gpt2, cfgs, dev):
    """One PyTorch call computing the same function as a kernel, timed beside
    it. Nothing in the port calls these."""
    import torch.nn.functional as F

    print("[12] library-call probes (timed only; never a route of the port)", flush=True)
    g = torch.Generator(dev).manual_seed(12)
    out = {}
    for b, t, iters in ((8, 1024, 20), (1, 16384, 5)):
        # (B, H, T, hs) contiguous, the layout the library call is built for
        q, k, v, do = (a.transpose(1, 2).contiguous()
                       for a in qkv_inputs(torch, b, t, t, 12, dev, g))
        for a in (q, k, v):
            a.requires_grad_(True)

        def fwd():
            with torch.no_grad():
                F.scaled_dot_product_attention(q, k, v, is_causal=True)

        o = F.scaled_dot_product_attention(q, k, v, is_causal=True)
        grad = lambda wrt: lambda: torch.autograd.grad(o, wrt, do, retain_graph=True)  # noqa: E731
        r = {"fwd": cuda_ms(fwd, iters), "bwd": cuda_ms(grad((q, k, v)), iters),
             "dq": cuda_ms(grad((q,)), iters), "dkv": cuda_ms(grad((k, v)), iters)}
        print(f"  F.scaled_dot_product_attention B={b} T={t} H=12 hs=64 bf16 causal: forward "
              f"{r['fwd']:.4f} ms, backward (autograd.grad of q, k, v) {r['bwd']:.4f} ms, "
              f"forward + backward {r['fwd'] + r['bwd']:.4f} ms; grad of q alone "
              f"{r['dq']:.4f} ms, of k and v {r['dkv']:.4f} ms", flush=True)
        out[f"B{b}_T{t}"] = r
        del o

    model = gpt2.init(cfgs["gpt"], generator=torch.Generator(dev).manual_seed(7), device=dev)
    params = [p.detach().clone().requires_grad_(True) for p in gpt2.named_params(model).values()]
    for p in params:
        p.grad = torch.randn(p.shape, device=dev, generator=g)
    ocfg = cfgs["opt"]
    opt = torch.optim.AdamW(params, lr=6e-4, betas=(ocfg.beta1, ocfg.beta2), eps=ocfg.eps,
                            weight_decay=ocfg.weight_decay, fused=True)
    out["adamw_fused"] = cuda_ms(opt.step, 20)
    print(f"  torch.optim.AdamW(fused=True).step() over {len(params)} leaves: "
          f"{out['adamw_fused']:.4f} ms", flush=True)
    return out


def phase_long_train_step(torch, np, gpt2, mods, cfgs, dev):
    accum, b, t = 2, 1, 16384
    print(f"[13] long-context train step: GPT-2 124M, block_size {t}, bf16 policy, "
          f"{accum} x (B={b}, T={t}) per step", flush=True)
    fa, fc, fw = mods["fa"], mods["fc"], mods["fw"]
    cfg = cfgs["gpt"].replace(block_size=t)

    def loss_fn(cfg, attn_impl, ce_impl):
        return lambda m, r: gpt2.loss(m, r[:, :-1], cfg, targets=r[:, 1:],
                                      policy=mods["policy"], attn_impl=attn_impl,
                                      ce_chunks=1, ce_impl=ce_impl)

    def make(model, cfg, attn_impl, ce_impl, fused):
        step = mods["make_train_step"](loss_fn(cfg, attn_impl, ce_impl), cfgs["opt"],
                                       cfgs["sched"], decay_mask=gpt2.decay_mask(model),
                                       use_fused_adamw=fused)
        return step, mods["adamw_init"](gpt2.named_params(model))

    model = gpt2.init(cfg, generator=torch.Generator(dev).manual_seed(1337), device=dev)
    rows = np.random.RandomState(13).randint(0, cfg.vocab_size, (accum, b, t + 1))
    batch = torch.from_numpy(rows.astype(np.int32)).to(dev)
    step_k, state_k = make(model, cfg, "auto", "auto", True)
    n = accum * cfg.n_layer
    per_step = with_zeros({"flash_general_fwd": n, "flash_rowdot": n, "flash_general_dq": n,
                           "flash_general_dkv": n, "adamw": 1})
    n_tok = accum * b * t
    torch.cuda.reset_peak_memory_stats()
    reset_counts(fa, fc, fw)
    times = []
    for i in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m = step_k(model, state_k, batch, i)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        counts = read_counts(fa, fc, fw)
        print(f"  step {i}: loss {m['loss']:.6f}, grad_norm {m['grad_norm']:.6f}, lr "
              f"{m['lr']:.4e}, {n_tok / times[-1]:.1f} tokens/s; launches {counts}", flush=True)
        require(counts == {k: (i + 1) * v for k, v in per_step.items()},
                f"expected {per_step} launches per step, got {counts} after {i + 1}")
        require(math.isfinite(m["loss"]) and math.isfinite(m["grad_norm"]),
                "long-context train loss or grad norm is not finite")
        if i == 0:
            require(abs(m["loss"] - math.log(cfg.padded_vocab_size)) < 0.5,
                    "first long-context loss is not near ln(V)")
    main_counts = read_counts(fa, fc, fw)
    tps = n_tok / (sum(times[1:]) / 2)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"  tokens/s {tps:.1f} (steps 1-2), peak device memory {peak:.2f} GiB", flush=True)
    del model, state_k, step_k, batch
    torch.cuda.empty_cache()

    # against the plain paths where einsum attention fits: full width, 2
    # layers, T just above the self-attention kernels' longest
    t2 = 8320
    cfg2 = cfgs["gpt"].replace(block_size=t2, n_layer=2)
    print(f"  kernel path vs plain paths at {cfg2.n_layer} layers, B=1, T={t2}:", flush=True)
    model = gpt2.init(cfg2, generator=torch.Generator(dev).manual_seed(1338), device=dev)
    plain_model = copy.deepcopy(model)
    rows = np.random.RandomState(14).randint(0, cfg2.vocab_size, (1, 1, t2 + 1))
    batch = torch.from_numpy(rows.astype(np.int32)).to(dev)
    kernel = (model, *reversed(make(model, cfg2, "auto", "auto", True)))
    plain = (plain_model, *reversed(make(plain_model, cfg2, "xla", "xla", False)))
    kernel[2](model, kernel[1], batch, 0)  # one step first, so the moments are not zero
    reset_counts(fa, fc, fw)
    compare_train_steps(torch, gpt2, mods, cfgs, kernel, plain, batch)
    counts = read_counts(fa, fc, fw)
    require(counts == with_zeros({"flash_general_fwd": 2, "flash_rowdot": 2,
                                  "flash_general_dq": 2, "flash_general_dkv": 2, "adamw": 1}),
            f"the T={t2} kernel-path step did not run on the general kernels: {counts}")
    return {"tps": tps, "peak_gib": peak, "counts": main_counts}


def write_synthetic_hellaswag(np, path, n=16, seed=0):
    """A small seeded HellaSwag-format file (no such data ships with the
    repository and none can be fetched)."""
    rng = np.random.RandomState(seed)
    words = "the a cat dog runs sleeps quickly under over bridge river and then stops".split()
    with open(path, "w") as f:
        for _ in range(n):
            phrase = lambda k: " ".join(rng.choice(words, size=k))  # noqa: E731
            f.write(json.dumps({"ctx": phrase(int(rng.randint(3, 9))),
                                "label": int(rng.randint(4)),
                                "endings": [phrase(int(rng.randint(1, 5))) for _ in range(4)]})
                    + "\n")


def phase_long_trainer(torch, np, mods, cfgs):
    print("[14] long-context trainer: cli.pretrain --synthetic --seq-len 16384 --micro-batch 1, "
          "3 steps of 32,768 tokens with HellaSwag, then resume", flush=True)
    fa, fc, fw = mods["fa"], mods["fc"], mods["fw"]
    n_layer = cfgs["gpt"].n_layer
    log_dir = tempfile.mkdtemp(prefix="chip_smoke_long_")
    old_tmp, old_hs = tempfile.tempdir, os.environ.get("HELLASWAG_DIR")
    tempfile.tempdir = log_dir  # the synthetic shards go under it too
    try:
        hs_dir = os.path.join(log_dir, "hellaswag")
        os.makedirs(hs_dir)
        write_synthetic_hellaswag(np, os.path.join(hs_dir, "hellaswag_val.jsonl"))
        os.environ["HELLASWAG_DIR"] = hs_dir
        argv = ["--synthetic", "--seq-len", "16384", "--micro-batch", "1", "--total-batch",
                "32768", "--log-dir", os.path.join(log_dir, "log")]
        reset_counts(fa, fc, fw)
        t0 = time.perf_counter()
        out = mods["pretrain"].main(argv + ["--steps", "3"])
        dt = time.perf_counter() - t0
        counts = read_counts(fa, fc, fw)
        accum, val_steps = 2, 20
        bwd = n_layer * 3 * accum
        want = with_zeros({"flash_general_fwd": n_layer * (3 * accum + 2 * val_steps),
                           "flash_rowdot": bwd, "flash_general_dq": bwd,
                           "flash_general_dkv": bwd, "ce_fwd": 2 * val_steps, "adamw": 3})
        print(f"  3 steps in {dt:.1f} s (val and HellaSwag at steps 0 and 2, samples, "
              f"checkpoints); launches {counts}", flush=True)
        require(counts == want, f"expected launches {want}, got {counts}")
        require(out["opt_state"]["step"] == 3 and math.isfinite(out["val_loss"])
                and out["model"].transformer.wpe.weight.shape[0] == 16384,
                "the long-context trainer did not take 3 finite steps at block_size 16384")

        def csv_rows():
            return [line.split(",")
                    for f in sorted(glob.glob(os.path.join(log_dir, "log", "*.csv")))
                    for line in open(f).read().splitlines()[1:]]

        rows = csv_rows()
        phases = [r[1] for r in rows]
        hella = [(int(r[2]), float(r[8])) for r in rows if r[1] == "hella"]
        tps = [float(r[7]) for r in rows if r[1] == "train"]
        print(f"  CSV: {phases.count('train')} train rows (tokens/s {tps}), "
              f"{phases.count('val')} val rows, hella rows {hella}", flush=True)
        require(phases.count("train") == 3 and phases.count("val") == 2
                and [s for s, _ in hella] == [0, 2] and all(0 <= a <= 1 for _, a in hella),
                "the CSV does not hold 3 train, 2 val and 2 hella rows")
        ckpts = sorted(os.listdir(os.path.join(log_dir, "log", "ckpts")))
        print(f"  checkpoints: {ckpts}", flush=True)
        require("model_final.pt" in ckpts, "model_final was not written")

        reset_counts(fa, fc, fw)
        out = mods["pretrain"].main(argv + ["--steps", "4"])
        rows = csv_rows()
        steps = [int(r[2]) for r in rows if r[1] == "train"]
        resumed = read_counts(fa, fc, fw)
        print(f"  resumed: train steps logged {steps}, launches {resumed}, optimizer step "
              f"{out['opt_state']['step']}", flush=True)
        require(steps == [0, 1, 2, 3] and resumed["adamw"] == 1
                and resumed["flash_general_dq"] == n_layer * accum
                and resumed["flash_fwd"] == 0 and out["opt_state"]["step"] == 4,
                "the second call did not resume at step 3 and run one step")
        return counts, tps
    finally:
        tempfile.tempdir = old_tmp
        if old_hs is None:
            os.environ.pop("HELLASWAG_DIR", None)
        else:
            os.environ["HELLASWAG_DIR"] = old_hs
        shutil.rmtree(log_dir, ignore_errors=True)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 2

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    require(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    print(f"card: {card}", flush=True)
    print(f"torch.cuda.get_device_name: {kind}; torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)

    import numpy as np

    from gpt2_vision_language_tpu_torch import _build
    from gpt2_vision_language_tpu_torch.cli import bench_decode, pretrain, sample
    from gpt2_vision_language_tpu_torch.core.config import (
        GPTConfig, OptimizerConfig, ScheduleConfig,
    )
    from gpt2_vision_language_tpu_torch.core.precision import (
        DEFAULT_POLICY, FP32_POLICY,
    )
    from gpt2_vision_language_tpu_torch.models import gpt2
    from gpt2_vision_language_tpu_torch.ops import attention, layers
    from gpt2_vision_language_tpu_torch.ops import flash_attention as fa
    from gpt2_vision_language_tpu_torch.ops import fused_adamw as fw
    from gpt2_vision_language_tpu_torch.ops import fused_ce as fc
    from gpt2_vision_language_tpu_torch.train import schedule
    from gpt2_vision_language_tpu_torch.train.optimizer import (
        adamw_init, adamw_update, global_norm,
    )
    from gpt2_vision_language_tpu_torch.train.step import make_eval_step, make_train_step

    print("[1] build", flush=True)
    so, build_s = _build.build()
    _build.load()
    print(f"  {so.name}: nvcc {build_s:.2f} s", flush=True)
    # registers and spills of every kernel, from the compiler's report
    report = so.with_suffix(".log").read_text()
    for name, regs in re.findall(
            r"Compiling entry function '\S*?\d([a-z_]+_kernel)\w*' for 'sm_90a'"
            r".*?Used (\d+) registers",
            report, flags=re.S):
        print(f"    {name}: {regs} registers", flush=True)
    spills = [int(n) for n in re.findall(r"(\d+) bytes spill stores", report)]
    print(f"    spill stores: {sum(spills)} bytes over {len(spills)} functions", flush=True)

    flash_errs, flash_t = phase_flash(torch, fa, dev)
    ce_err, ce_t = phase_ce(torch, fc, dev)

    print("[4] scoring forward: GPT-2 124M, bf16 policy, 2 x (B=8, T=1024)", flush=True)
    cfg = GPTConfig()
    model = gpt2.init(cfg, generator=torch.Generator(dev).manual_seed(1337), device=dev)
    toks = np.random.RandomState(0).randint(0, cfg.vocab_size, (2, 8, 1025))
    toks = torch.from_numpy(toks).to(dev)
    batch = {"idx": toks[..., :-1], "targets": toks[..., 1:]}

    def make(attn_impl, ce_impl):
        return make_eval_step(lambda m, mb: gpt2.loss(
            m, mb["idx"], cfg, targets=mb["targets"], policy=DEFAULT_POLICY,
            attn_impl=attn_impl, ce_impl=ce_impl,
        ))

    eval_step, eval_plain = make("auto", "auto"), make("xla", "xla")
    eval_step(model, batch)  # warm-up
    torch.cuda.synchronize()
    fa.flash_attention.launches = 0
    fc.ce_forward.launches = 0
    t0 = time.perf_counter()
    loss = eval_step(model, batch).item()
    dt = time.perf_counter() - t0
    launches = {"flash": fa.flash_attention.launches, "ce": fc.ce_forward.launches}
    n_tok = batch["idx"].numel()
    print(f"  loss {loss:.6f} (ln V = {math.log(cfg.padded_vocab_size):.4f}); "
          f"{n_tok / dt:.1f} tokens/s ({dt * 1e3:.1f} ms); launches {launches}",
          flush=True)
    require(math.isfinite(loss), "scoring loss is not finite")
    require(abs(loss - math.log(cfg.padded_vocab_size)) < 0.5,
            "scoring loss is not near ln(V) for random weights")
    require(launches == {"flash": 2 * cfg.n_layer, "ce": 2},
            f"expected 12 flash and 1 CE launch per micro-batch, got {launches}")
    eval_plain(model, batch)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loss_plain = eval_plain(model, batch).item()
    dt_plain = time.perf_counter() - t0
    print(f"  plain paths (attn 'xla', CE 'xla'): loss {loss_plain:.6f}, "
          f"{n_tok / dt_plain:.1f} tokens/s; |diff| {abs(loss - loss_plain):.3e} "
          f"(tol 1e-2)", flush=True)
    require(abs(loss - loss_plain) <= 1e-2, "kernel and plain scoring losses disagree")
    require(fa.flash_attention.launches == launches["flash"]
            and fc.ce_forward.launches == launches["ce"],
            "the plain-path run launched a kernel")

    print("[5] generation", flush=True)
    out = sample.main(["--num", "4", "--length", "32"])
    require(out.shape[0] == 4 and int(out.min()) >= 0
            and int(out.max()) < cfg.padded_vocab_size, "sampled ids out of range")
    ids = torch.from_numpy(np.random.RandomState(1).randint(0, cfg.vocab_size, (2, 16))).to(dev)
    with torch.no_grad():
        cache = gpt2.init_cache(cfg, 2, 16, torch.float32, device=dev)
        emb = gpt2.embed_tokens(model, ids, cfg)
        gpt2.forward_cached(model, emb[:, :15], cfg, cache, 0, policy=FP32_POLICY)
        cached, _ = gpt2.forward_cached(model, emb[:, 15:], cfg, cache, 15,
                                        policy=FP32_POLICY)
        full, _ = gpt2.apply(model, ids, cfg, policy=FP32_POLICY)
    e = (cached[:, -1] - full[:, -1]).abs().max().item()
    print(f"  cached vs uncached next-token logits (fp32): max|err| {e:.3e} (tol 1e-3)",
          flush=True)
    require(e <= 1e-3, "cached and uncached logits disagree")
    result = bench_decode.main(["--batch", "50", "--new", "24", "--iters", "3"])
    require(result["value"] > 0 and result["batch"] == 50, "bench_decode failed")
    phase_matmul_f32(torch, layers, dev)
    del model

    cfgs = {"gpt": cfg, "opt": OptimizerConfig(), "sched": ScheduleConfig()}
    mods = {"fa": fa, "fc": fc, "fw": fw, "policy": DEFAULT_POLICY,
            "make_train_step": make_train_step, "adamw_init": adamw_init,
            "adamw_update": adamw_update, "global_norm": global_norm, "pretrain": pretrain}
    bwd_err, bwd_t = phase_flash_bwd(torch, fa, attention, dev)
    adamw_err, adamw_t = phase_adamw(torch, gpt2, fw, schedule, cfgs, dev)
    train = phase_train_step(torch, np, gpt2, mods, cfgs, dev)
    torch.cuda.empty_cache()
    trainer_counts, _ = phase_trainer(torch, mods, cfgs)

    gen_errs, gen_t = phase_general(torch, fa, dev)
    torch.cuda.empty_cache()
    families = phase_general_vs_self(torch, fa, dev)
    library = phase_library_probes(torch, gpt2, cfgs, dev)
    torch.cuda.empty_cache()
    long_train = phase_long_train_step(torch, np, gpt2, mods, cfgs, dev)
    torch.cuda.empty_cache()
    long_counts, long_tps = phase_long_trainer(torch, np, mods, cfgs)

    by_path = {"scoring": {"flash_fwd": launches["flash"], "ce_fwd": launches["ce"]},
               "train_step": train["counts"], "trainer": trainer_counts,
               "long_train_step": long_train["counts"], "long_trainer": long_counts}
    csrc = "gpt2_vision_language_tpu_torch/csrc/"
    jfa = "gpt2_vision_language_tpu/ops/flash_attention.py"
    n_params = 124_475_904
    self_shape, long_shape = (8, 1024, 1024, 12, 64, True), (1, 16384, 16384, 12, 64, True)
    lib_self, lib_long = library["B8_T1024"], library["B1_T16384"]
    # name, source, the TPU kernel it replaces, the path whose run gives `launches`,
    # max error, (kernel ms, plain ms), bound, the library call's ms
    table = [
        ("flash_fwd", "flash_fwd.cu", f"{jfa}:841", "trainer", flash_errs["o"], flash_t,
         attention_bound("fwd", *self_shape), lib_self["fwd"]),
        ("flash_bwd", "flash_bwd.cu", f"{jfa}:887", "trainer", bwd_err, bwd_t,
         attention_bound("bwd", *self_shape), lib_self["bwd"]),
        ("ce_fwd", "ce_fwd.cu", "gpt2_vision_language_tpu/ops/fused_ce.py:93", "trainer",
         ce_err, ce_t, bound_ms(2 * 8192 * 768 * 50304,
                                2 * (8192 * 768 + 50304 * 768) + 3 * 4 * 8192), None),
        ("adamw", "adamw.cu", "gpt2_vision_language_tpu/ops/fused_adamw.py:36", "trainer",
         adamw_err, adamw_t, bound_ms(0, 7 * 4 * n_params), library["adamw_fused"]),
        ("flash_general_fwd", "flash_general_fwd.cu", f"{jfa}:221", "long_trainer",
         gen_errs["o"], gen_t["fwd"], attention_bound("fwd", *long_shape), lib_long["fwd"]),
        ("flash_general_dq", "flash_general_bwd.cu", f"{jfa}:369", "long_trainer",
         gen_errs["dq"], gen_t["dq"], attention_bound("dq", *long_shape), lib_long["dq"]),
        ("flash_general_dkv", "flash_general_bwd.cu", f"{jfa}:509", "long_trainer",
         gen_errs["dkv"], gen_t["dkv"], attention_bound("dkv", *long_shape), lib_long["dkv"]),
        # the D pre-kernel of the general backward: XLA code in the JAX package
        ("flash_rowdot", "flash_general_bwd.cu", f"{jfa}:573", "long_trainer",
         gen_errs["dd"], gen_t["rowdot"],
         bound_ms(2 * 16384 * 768, 2 * 2 * 16384 * 768 + 4 * 16384 * 12), None),
    ]
    kernels = []
    for name, src, replaces, path, err, (ms, plain_ms), (b_ms, b_by), lib_ms in table:
        count = by_path[path][name]
        require(count > 0, f"{name} was not launched by the {path} run")
        kernels.append({
            "name": name, "route": "cuda", "source": csrc + src, "replaces": replaces,
            "launches": count, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms,
            "launches_by_path": {p: c[name] for p, c in by_path.items() if name in c},
        })
    notes = {
        "flash_fwd": {"lse_max_abs_err": flash_errs["lse"], "shape": "B=8 T=1024 H=12 causal",
                      "library_is": "F.scaled_dot_product_attention"},
        "flash_bwd": {"err_is": "max|err| / max|ref|", "shape": "B=8 T=1024 H=12 causal",
                      "library_is": "autograd.grad of q, k and v through SDPA"},
        "ce_fwd": {"shape": "N=8192 D=768 V=50304"},
        "adamw": {"err_is": "max|err| / max|ref|", "shape": "148 leaves, 124,475,904 params",
                  "library_is": "torch.optim.AdamW(fused=True).step()"},
        "flash_general_fwd": {"lse_max_abs_err": gen_errs["lse"],
                              "library_is": "F.scaled_dot_product_attention"},
        "flash_general_dq": {"err_is": "max|err| / max|ref|",
                             "plain_is": "the plain backward computes dq, dk and dv together",
                             "library_is": "autograd.grad of q through SDPA"},
        "flash_general_dkv": {"err_is": "max|err| / max|ref|",
                              "plain_is": "the plain backward computes dq, dk and dv together",
                              "library_is": "autograd.grad of k and v through SDPA"},
        "flash_rowdot": {"err_is": "max|err| / max|ref|"},
    }
    for k in kernels:
        k.update(notes[k["name"]])
        if k["name"].startswith("flash_general") or k["name"] == "flash_rowdot":
            k["shape"] = "B=1 T=16384 H=12 causal"
    print(json.dumps({"long_context": {"train_step_tokens_per_s": long_train["tps"],
                                       "peak_gib": long_train["peak_gib"],
                                       "trainer_tokens_per_s": long_tps,
                                       "general_vs_self": families,
                                       "sdpa_ms": {"B8_T1024": lib_self, "B1_T16384": lib_long}}}))
    print(json.dumps({"train_step_tokens_per_s": {"kernel": train["kernel_tps"],
                                                  "plain": train["plain_tps"]}}))
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
