"""CLI: caption-decode throughput (captions/s), KV-cached against the
reference's full re-forward loop.

    python -m gpt2_vision_language_tpu_torch.cli.bench_decode [--batch 50] [--new 24]
        [--topp-ways 2] [--uncached-baseline]

The evaluate_cider workload shape (gpt2_linear/data.py:95-127): a 33-token
visual prefix + the "A photo of" prompt + 24 nucleus-sampled tokens, B
captions at once through the KV-cached decoder, weights stored bf16 by
default, each token drawn by the sort-free ``sample_top_p_fast`` at
``--topp-ways``. ``--uncached-baseline`` also times the reference regime:
batch 1, one full re-forward per token, the sorted ``sample_top_p``.
The port's caption paths (eval/caption_eval.py, models/caption.py,
train/finetune.py) sample with ``sample_top_p``, which the H100 runs many
times faster than the sort-free sampler (PERF.md), so the captions/s here
is not theirs, and ``speedup_vs_uncached`` compares the two samplers as well
as the two loops.
Counterpart of gpt2_vision_language_tpu/cli/bench_decode.py; prints the
same JSON keys plus the device it ran on. Random weights from a seed.
"""

from __future__ import annotations

import argparse
import json
import time


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--batch", type=int, default=50)
    p.add_argument("--new", type=int, default=24)
    p.add_argument("--iters", type=int, default=5)
    p.add_argument("--param-dtype", default="bfloat16",
                   choices=["bfloat16", "float32"],
                   help="serving weight storage (bfloat16 halves the bytes "
                        "each decode step reads)")
    p.add_argument("--uncached-baseline", action="store_true",
                   help="also measure the reference regime (batch 1, a full "
                        "re-forward per token; slow)")
    p.add_argument("--topp-ways", type=int, default=2,
                   help="bisection arity of the sort-free top-p sampler")
    p.add_argument("--device", type=str, default="cuda")
    args = p.parse_args(argv)

    import torch

    from ..core.config import GPTConfig
    from ..infer.decode import Decoder, cast_decode_params
    from ..infer.sampling import sample_top_p, sample_top_p_fast
    from ..models import gpt2

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("bench_decode: no CUDA device (torch.cuda.is_available() is "
                           "False); pass --device cpu to run on the CPU")
    cfg = GPTConfig()
    model = gpt2.init(cfg, device=device)
    if args.param_dtype == "bfloat16":
        model = cast_decode_params(model)
    b, m = args.batch, 33
    prefix = torch.randn(
        (b, m, cfg.n_embd), generator=torch.Generator(device).manual_seed(1),
        device=device,
    ).to(torch.bfloat16)
    prompt_ids = [32, 4590, 286]  # "A photo of"
    prompt = torch.tensor([prompt_ids] * b, device=device)
    ways = args.topp_ways
    dec = Decoder(cfg, sample_fn=lambda g, logits: sample_top_p_fast(g, logits, ways=ways))

    def sync(out=None):
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        return out

    gen = torch.Generator(device).manual_seed(2)
    sync(dec.generate(model, prompt, args.new, gen, prefix_embeds=prefix))
    t0 = time.perf_counter()
    for _ in range(args.iters):
        out, _ = dec.generate(model, prompt, args.new, gen, prefix_embeds=prefix)
    sync(out)
    dt = (time.perf_counter() - t0) / args.iters
    cached_cps = b / dt

    result = {
        "metric": "caption_decode_captions_per_sec_per_chip",
        "value": round(cached_cps, 2),
        "unit": "captions/s/chip",
        "batch": b,
        "new_tokens": args.new,
    }

    if args.uncached_baseline:
        # the reference regime: batch 1, a full re-forward per token
        wte, wpe = model.transformer.wte.weight, model.transformer.wpe.weight

        @torch.no_grad()
        def uncached_one(generator):
            ids = list(prompt_ids)
            for _ in range(args.new):
                t = len(ids)
                txt = wte[torch.tensor([ids], device=device)] + wpe[:t]
                full = torch.cat([prefix[:1].float(), txt.float()], dim=1).to(torch.bfloat16)
                logits = gpt2.forward_embeds(model, full, cfg)[:, -1, :]
                ids.append(int(sample_top_p(generator, logits)[0]))
            return ids

        uncached_one(torch.Generator(device).manual_seed(0))  # warm-up
        sync()
        t0 = time.perf_counter()
        uncached_one(torch.Generator(device).manual_seed(1))
        dt_uncached = time.perf_counter() - t0
        result["uncached_reference_captions_per_sec"] = round(1.0 / dt_uncached, 3)
        result["speedup_vs_uncached"] = round(cached_cps * dt_uncached, 1)

    result["device"] = (torch.cuda.get_device_name(device) if device.type == "cuda"
                        else str(device))
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
