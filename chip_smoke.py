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
     policy, and cli.bench_decode at B=50.

Prints the card's name and power limit, one JSON line with each kernel's
launches, error and times, and last {"ok": true, "device": {...}}. Exits
non-zero, printing no result, without a CUDA device.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
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
    from gpt2_vision_language_tpu_torch.cli import bench_decode, sample
    from gpt2_vision_language_tpu_torch.core.config import GPTConfig
    from gpt2_vision_language_tpu_torch.core.precision import (
        DEFAULT_POLICY, FP32_POLICY,
    )
    from gpt2_vision_language_tpu_torch.models import gpt2
    from gpt2_vision_language_tpu_torch.ops import flash_attention as fa
    from gpt2_vision_language_tpu_torch.ops import fused_ce as fc
    from gpt2_vision_language_tpu_torch.train.step import make_eval_step

    print("[1] build", flush=True)
    so, build_s = _build.build()
    _build.load()
    print(f"  {so.name}: nvcc {build_s:.2f} s", flush=True)

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

    kernels = [
        {"name": "flash_fwd", "route": "cuda",
         "source": "gpt2_vision_language_tpu_torch/csrc/flash_fwd.cu",
         "replaces": "gpt2_vision_language_tpu/ops/flash_attention.py:841",
         "launches": launches["flash"], "max_abs_err": flash_errs["o"],
         "lse_max_abs_err": flash_errs["lse"],
         "ms": flash_t[0], "plain_ms": flash_t[1]},
        {"name": "ce_fwd", "route": "cuda",
         "source": "gpt2_vision_language_tpu_torch/csrc/ce_fwd.cu",
         "replaces": "gpt2_vision_language_tpu/ops/fused_ce.py:93",
         "launches": launches["ce"], "max_abs_err": ce_err,
         "ms": ce_t[0], "plain_ms": ce_t[1]},
    ]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
