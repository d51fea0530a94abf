"""CLI: caption images end to end: JPEG -> CLIP -> bridge -> GPT-2 decode.

    python -m gpt2_vision_language_tpu_torch.cli.caption IMG [IMG...] \\
        --gpt-ckpt log/ckpts/model_best.pt --bridge-ckpt ft/ckpts/model_best.pt \\
        [--clip-hf-ckpt /path/to/clip] [--bridge linear|qformer] [--variant vit-l-14]

Counterpart of gpt2_vision_language_tpu/cli/caption.py: the same flags and
output lines (``{basename}: {prompt}{caption}``), plus ``--device`` (default
``cuda``; ``cpu`` to ask for the CPU). The host decodes each image and does
CLIP's resize of the shorter side and centre crop with PIL
(cli/extract_clip_features.load_batch), so images of any size batch
together; normalisation, the CLIP ViT, the pooling to 33 tokens, the bridge
and the KV-cached nucleus decode run on the device (``caption_crops``).

Weights: ``--gpt-ckpt`` takes every decoder format that
ckpt/torch_import.load_gpt_checkpoint reads (a reference, port or
GPT_Caption ``.pt``, an HF directory or file, a JAX ``.npz``);
``--bridge-ckpt`` every format bridge_from_checkpoint reads (a GPT_Caption
or bridge-only ``.pt``, the port's own fine-tune checkpoints, a JAX
fine-tune ``.npz``); ``--clip-hf-ckpt`` an HF CLIP directory or weights
file, read without ``transformers``. Each that is not given is a seeded
random init, with a warning.
"""

from __future__ import annotations

import argparse
import os

from .extract_clip_features import VARIANTS, load_batch, load_encoder, resolve_device


def caption_crops(clip_model, model, crops_u8, clip_cfg, cfg, bridge_cfg, prompt_ids, *,
                  generator, new_tokens: int):
    """The device step: (B, S, S, 3) uint8 crops -> (B, new_tokens) caption
    ids: normalise, encode (bf16 policy), pool to 33 tokens, then the
    bridge's prefix and the KV-cached nucleus decode of
    models/caption.generate_captions."""
    import torch

    from ..models import caption, clip_vit
    from ..ops.pooling import pool_clip_tokens_to_33

    device = next(clip_model.parameters()).device
    with torch.no_grad():
        x = torch.as_tensor(crops_u8).to(device)
        feats = clip_vit.features(clip_model, clip_vit.normalize_only(x), clip_cfg)
        z = pool_clip_tokens_to_33(feats)
        ids = torch.tensor([prompt_ids] * len(crops_u8), device=device)
        return caption.generate_captions(model, z, ids, cfg, bridge_cfg, generator,
                                         max_new_tokens=new_tokens)


def load_models(variant: str, kind: str, device, *, gpt_ckpt=None, bridge_ckpt=None,
                clip_hf_ckpt=None):
    """(CLIP config, CLIP encoder, GPT config, bridge config, CaptionModel)
    on ``device``: each from its checkpoint, or its seeded random init with
    the JAX CLI's warning."""
    import torch

    from ..core import config as C
    from ..core.config import BridgeConfig, GPTConfig
    from ..models import bridges, caption, gpt2

    clip_cfg = getattr(C, VARIANTS[variant])
    cfg = GPTConfig()
    bridge_cfg = BridgeConfig(kind=kind, enc_dim=clip_cfg.width)
    clip_model = load_encoder(clip_cfg, clip_hf_ckpt, device,
                              warning="[caption] WARNING: random CLIP weights "
                                      "(no --clip-hf-ckpt)")
    if gpt_ckpt:
        from ..ckpt.torch_import import load_gpt_checkpoint

        with torch.device(device):
            gpt = gpt2.GPT2(cfg)
        gpt.load_state_dict(load_gpt_checkpoint(gpt_ckpt, cfg)[0])
    else:
        print("[caption] WARNING: random GPT-2 weights (no --gpt-ckpt)")
        gpt = gpt2.init(cfg, generator=torch.Generator(device).manual_seed(1), device=device)
    if bridge_ckpt:
        from ..ckpt.torch_import import bridge_from_checkpoint, read_checkpoint

        bridge = bridges.bridge_init(bridge_cfg, cfg.n_embd, device=device)
        bridge.load_state_dict(bridge_from_checkpoint(read_checkpoint(bridge_ckpt), kind))
    else:
        print("[caption] WARNING: random bridge weights (no --bridge-ckpt)")
        bridge = caption.init(cfg, bridge_cfg, generator=torch.Generator(device).manual_seed(2),
                              device=device)
    return clip_cfg, clip_model, cfg, bridge_cfg, caption.CaptionModel(gpt, bridge)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("images", nargs="+", help="image files")
    p.add_argument("--gpt-ckpt", default=None,
                   help="any decoder checkpoint (.pt, HF, .npz)")
    p.add_argument("--bridge-ckpt", default=None,
                   help="fine-tune checkpoint (.pt of the port or GPT_Caption, .npz)")
    p.add_argument("--clip-hf-ckpt", default=None)
    p.add_argument("--bridge", default="linear", choices=["linear", "qformer"])
    p.add_argument("--variant", default="vit-l-14", choices=list(VARIANTS))
    p.add_argument("--prompt", default="A photo of")
    p.add_argument("--new-tokens", type=int, default=24)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu; a missing CUDA device raises")
    args = p.parse_args(argv)

    import torch

    from ..data.tokenizer import get_tokenizer

    device = resolve_device(args.device, "caption")
    clip_cfg, clip_model, cfg, bridge_cfg, model = load_models(
        args.variant, args.bridge, device, gpt_ckpt=args.gpt_ckpt,
        bridge_ckpt=args.bridge_ckpt, clip_hf_ckpt=args.clip_hf_ckpt)
    crops = load_batch(args.images, clip_cfg.image_size)
    tok = get_tokenizer()
    toks = caption_crops(clip_model, model, crops, clip_cfg, cfg, bridge_cfg,
                         tok.encode(args.prompt),
                         generator=torch.Generator(device).manual_seed(args.seed),
                         new_tokens=args.new_tokens).cpu().numpy()
    lines = []
    for i, path in enumerate(args.images):
        lines.append(f"{os.path.basename(path)}: {args.prompt}{tok.decode(toks[i].tolist())}")
        print(lines[-1])
    return lines


if __name__ == "__main__":
    main()
