"""CLI: caption-decode throughput (captions/s) on the KV-cached path.

    python -m gpt2_vision_language_tpu_torch.cli.bench_decode [--batch 50] [--new 24]

The evaluate_cider workload shape (gpt2_linear/data.py:95-127): a 33-token
visual prefix + the "A photo of" prompt + 24 nucleus-sampled tokens, B
captions at once, weights stored bf16 by default. Counterpart of
gpt2_vision_language_tpu/cli/bench_decode.py:20-80; prints the same JSON
keys plus the device it ran on. The uncached reference regime
(``--uncached-baseline``) and the sort-free sampler's ``--topp-ways`` are
not ported yet. Random weights from a seed.
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
    p.add_argument("--device", type=str, default="cuda")
    args = p.parse_args(argv)

    import torch

    from ..core.config import GPTConfig
    from ..infer.decode import Decoder, cast_decode_params
    from ..infer.sampling import sample_top_p
    from ..models import gpt2

    device = torch.device(args.device)
    cfg = GPTConfig()
    model = gpt2.init(cfg, device=device)
    if args.param_dtype == "bfloat16":
        model = cast_decode_params(model)
    b, m = args.batch, 33
    prefix = torch.randn(
        (b, m, cfg.n_embd), generator=torch.Generator(device).manual_seed(1),
        device=device,
    ).to(torch.bfloat16)
    prompt = torch.tensor([[32, 4590, 286]] * b, device=device)  # "A photo of"
    dec = Decoder(cfg, sample_fn=sample_top_p)

    def sync(out):
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

    result = {
        "metric": "caption_decode_captions_per_sec_per_chip",
        "value": round(b / dt, 2),
        "unit": "captions/s/chip",
        "batch": b,
        "new_tokens": args.new,
        "device": (torch.cuda.get_device_name(device) if device.type == "cuda"
                   else str(device)),
    }
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
