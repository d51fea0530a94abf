"""CLI: sample text from a GPT-2 with the KV-cached decoder.

    python -m gpt2_vision_language_tpu_torch.cli.sample --ckpt model.pt \\
        --prompt "Hello, I'm a language model," --num 4 --length 32

``--ckpt`` takes any checkpoint ckpt/torch_import.load_gpt_checkpoint reads
(a reference or port ``.pt``, an HF directory or weights file, a JAX
``.npz``); without one the model is a seeded random init. Counterpart of
gpt2_vision_language_tpu/cli/sample.py, with the same flags plus ``--device``.
"""

from __future__ import annotations

import argparse


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--ckpt", type=str, default=None)
    p.add_argument("--prompt", type=str, default="Hello, I'm a language model,")
    p.add_argument("--num", type=int, default=4)
    p.add_argument("--length", type=int, default=32)
    p.add_argument("--top-k", type=int, default=50)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--device", type=str, default="cuda")
    args = p.parse_args(argv)

    import functools

    import torch

    from ..core.config import GPTConfig
    from ..data.tokenizer import get_tokenizer
    from ..infer.decode import Decoder
    from ..infer.sampling import sample_top_k
    from ..models import gpt2

    device = torch.device(args.device)
    cfg = GPTConfig()
    if args.ckpt:
        from ..ckpt.torch_import import load_gpt_checkpoint

        sd, _ = load_gpt_checkpoint(args.ckpt, cfg)
        model = gpt2.GPT2(cfg)
        model.load_state_dict(sd)
        model = model.to(device)
    else:
        print("[sample] no --ckpt: using random init")
        model = gpt2.init(cfg, device=device)

    tok = get_tokenizer()
    prompt = tok.encode(args.prompt)
    if args.length <= len(prompt):
        p.error(
            f"--length {args.length} must exceed the prompt length "
            f"({len(prompt)} tokens with tokenizer {tok.name!r})"
        )
    ids = torch.tensor([prompt] * args.num, dtype=torch.long, device=device)
    dec = Decoder(cfg, sample_fn=functools.partial(sample_top_k, k=args.top_k))
    gen = torch.Generator(device).manual_seed(args.seed)
    out, _ = dec.generate(model, ids, args.length - len(prompt), gen)
    out = out.cpu()
    for i in range(args.num):
        print(f"sample {i}: {tok.decode(prompt + out[i].tolist())}")
    return out


if __name__ == "__main__":
    main()
