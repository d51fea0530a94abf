"""CLI: one-command quality reproduction — checkpoint in, metrics out.

    # HellaSwag accuracy of a reference pretrain checkpoint
    python -m gpt2_vision_language_tpu_torch.cli.eval_quality \\
        --gpt-ckpt model_best.pt --hellaswag --hellaswag-dir hellaswag

    # HellaSwag of an original-OpenAI HF GPT2LMHeadModel checkpoint
    python -m gpt2_vision_language_tpu_torch.cli.eval_quality \\
        --hf-ckpt /path/to/gpt2 --hellaswag

    # CIDEr / METEOR of a captioning bridge over COCO val features
    python -m gpt2_vision_language_tpu_torch.cli.eval_quality \\
        --gpt-ckpt model_best.pt --bridge linear --bridge-ckpt bridge.pt \\
        --coco-tokens val_tokens/ --coco-ann captions_val2017.json --meteor

Counterpart of gpt2_vision_language_tpu/cli/eval_quality.py: the same flags,
the same checkpoint formats and one JSON line with the same keys, plus
``--device`` (default ``cuda``; ``cpu`` to ask for the CPU). The reference's
published numbers are HellaSwag ≈30% (README.md:26,40,59; eval loop
train_gpt2.py:393-426) and CIDEr 0.32–0.60 / METEOR 0.33–0.41
(README.md:194-196; evaluate_cider gpt2_linear/data.py:68-135). Checkpoint
formats (ckpt/torch_import.py, ckpt/checkpoint.load_jax_checkpoint):

  * the JAX package's ``.npz`` — pretrain ({params: gpt tree}) and fine-tune
    ({params: {gpt, bridge}} or the cross-attention full tree) layouts;
  * a torch ``.pt`` — the reference's pretrain (transformer.* keys,
    train_gpt2.py:363-391) and GPT_Caption fine-tunes (gpt.* + bridge.*,
    gpt2_linear/train.py:170-216), the cross-attention GPT
    (transformer.h.N.xattn.*, gpt2_cross-att/model.py:116-129), and the port's
    own checkpoints, which have the same layout;
  * HuggingFace GPT2LMHeadModel (a directory with pytorch_model.bin /
    model.safetensors, or either file).

The GPT architecture comes from the checkpoint itself (n_layer from the h.N
keys, n_embd and vocab from wte, block_size from wpe, n_head from the GPT-2
family map). On the card the HellaSwag forward's self-attention runs on
the K1 forward kernels wherever a batch pads to 512 positions or more
(ops/attention.AUTO_FLASH_MIN_T): the fp32 kernel under ``--policy fp32``
(the default, as in JAX, whose flash kernel takes fp32 operands there), the
bf16 one under ``--policy bf16``. Caption eval's attention is below that
threshold, on the plain path in both packages.
"""

from __future__ import annotations

import argparse
import json

# n_embd -> n_head for the published GPT-2 family (train_gpt2.py:76-83
# parameterizes but only ships 124M; the rest follow the GPT-2 paper)
_FAMILY_HEADS = {768: 12, 1024: 16, 1280: 20, 1600: 25}


def _derive_cfg(raw, *, cross_attention: bool, n_head):
    """GPTConfig from the checkpoint's own shapes (``read_checkpoint``'s
    result): a torch/HF state dict, or a JAX tree, whose cross-attention
    blocks decide ``cross_attention`` themselves."""
    from ..core.config import GPTConfig

    if raw.fmt == "npz":
        tree = raw.gpt
        wte, wpe = tree["wte"], tree["wpe"]
        n_layer = int(tree["blocks"]["ln1"]["scale"].shape[0])
        cross_attention = "xattn" in tree["blocks"]
        img_embd = int(tree["vis_proj"]["w"].shape[0]) if cross_attention else 0
    else:
        sd = raw.gpt
        keys = {k.removeprefix("transformer.") for k in sd}
        layers = {int(k.split(".")[1]) for k in keys
                  if k.startswith("h.") and k.split(".")[1].isdigit()}
        wte = sd.get("transformer.wte.weight", sd.get("wte.weight"))
        wpe = sd.get("transformer.wpe.weight", sd.get("wpe.weight"))
        if wte is None or wpe is None or not layers:
            raise KeyError("checkpoint lacks wte, wpe or any h.N layer")
        n_layer = max(layers) + 1
        z = sd.get("transformer.vis_proj.z_proj.weight")
        if cross_attention and z is None:
            raise SystemExit("--bridge xattn needs a cross-attention GPT checkpoint "
                             "(transformer.h.N.xattn.* keys)")
        img_embd = int(z.shape[1]) if cross_attention else 0
    n_embd, vocab = int(wte.shape[1]), int(wte.shape[0])
    if vocab == 50304:
        # padded-vocab checkpoint (train_gpt2.py:260 pads 50257 -> 50304);
        # keep the logical vocab at 50257 so padded_vocab_size matches
        vocab = 50257
    return GPTConfig(block_size=int(wpe.shape[0]), vocab_size=vocab, n_layer=n_layer,
                     n_head=n_head or _FAMILY_HEADS.get(n_embd, max(1, n_embd // 64)),
                     n_embd=n_embd, cross_attention=cross_attention,
                     img_embd=img_embd)


def load_gpt(args):
    """-> (the decoder's state dict, cfg, the checkpoint as read, whose
    bridge half the caption eval converts, its format).
    ckpt/torch_import.read_checkpoint tells the formats apart."""
    from ..ckpt.torch_import import gpt2_from_checkpoint, read_checkpoint

    if args.hf_ckpt:
        raw = read_checkpoint(args.hf_ckpt, fmt="hf")
    elif args.gpt_ckpt:
        raw = read_checkpoint(args.gpt_ckpt)
    else:
        raise SystemExit("one of --gpt-ckpt / --hf-ckpt is required")
    cfg = _derive_cfg(raw, cross_attention=args.bridge == "xattn" and raw.fmt != "hf",
                      n_head=args.n_head)
    return gpt2_from_checkpoint(raw, cfg), cfg, raw, raw.fmt


def main(argv=None):
    p = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter
    )
    src = p.add_argument_group("checkpoint")
    src.add_argument("--gpt-ckpt", default=None, help=".npz (JAX package) or .pt (reference)")
    src.add_argument("--hf-ckpt", default=None,
                     help="HF GPT2LMHeadModel dir or weights file")
    src.add_argument("--bridge-ckpt", default=None,
                     help="bridge weights: .npz (JAX package) or reference GPT_Caption .pt")
    src.add_argument("--bridge", default=None,
                     choices=["linear", "xattn", "qformer"],
                     help="bridge kind for caption eval (xattn: weights live "
                     "inside --gpt-ckpt)")
    src.add_argument("--n-head", type=int, default=None,
                     help="override the family-derived head count")

    hs = p.add_argument_group("hellaswag")
    hs.add_argument("--hellaswag", action="store_true",
                    help="compute HellaSwag accuracy (README.md:26 ≈30%%)")
    hs.add_argument("--hellaswag-dir", default=None,
                    help="dir with hellaswag_{split}.jsonl (default $HELLASWAG_DIR)")
    hs.add_argument("--hellaswag-split", default="val")
    hs.add_argument("--hellaswag-limit", type=int, default=None)

    cc = p.add_argument_group("captioning")
    cc.add_argument("--coco-tokens", default=None,
                    help="CLIP feature shards dir (with index.json) for COCO val")
    cc.add_argument("--coco-ann", default=None,
                    help="COCO captions annotation json (val split)")
    cc.add_argument("--meteor", action="store_true")
    cc.add_argument("--cider-samples", type=int, default=500,
                    help="images to caption (reference: first 500, "
                    "gpt2_linear/data.py:95)")
    cc.add_argument("--new-tokens", type=int, default=24)
    cc.add_argument("--batch-size", type=int, default=50)
    cc.add_argument("--prompt", default="A photo of")
    cc.add_argument("--seed", type=int, default=0)

    p.add_argument("--policy", default="fp32", choices=["fp32", "bf16"],
                   help="fp32 for score comparability; bf16 for speed")
    p.add_argument("--out", default=None, help="also write the JSON line here")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu; a missing CUDA device raises")
    args = p.parse_args(argv)

    import torch

    from ..core.precision import DEFAULT_POLICY, FP32_POLICY
    from ..data.tokenizer import get_tokenizer
    from ..models import gpt2

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("eval_quality: no CUDA device (torch.cuda.is_available() is "
                           "False); pass --device cpu to run on the CPU")
    policy = FP32_POLICY if args.policy == "fp32" else DEFAULT_POLICY
    tokenizer = get_tokenizer()
    gpt_sd, cfg, raw, source = load_gpt(args)
    with torch.device(device):
        gpt = gpt2.GPT2(cfg)
    gpt.load_state_dict(gpt_sd)

    result = {
        "ckpt": args.gpt_ckpt or args.hf_ckpt,
        "ckpt_format": source,
        "model": {
            "n_layer": cfg.n_layer,
            "n_head": cfg.n_head,
            "n_embd": cfg.n_embd,
            "block_size": cfg.block_size,
        },
        "tokenizer": tokenizer.name,
        "policy": args.policy,
    }
    if tokenizer.name == "byte-fallback":
        # still runs (plumbing tests use it) but scores are not comparable
        # to the reference's tiktoken-tokenized published numbers
        result["tokenizer_warning"] = (
            "byte-fallback tokenizer: scores NOT comparable to published "
            "numbers; provision GPT2_BPE_DIR or tiktoken data"
        )

    if args.hellaswag:
        from ..eval.hellaswag import HellaSwagEvaluator

        ev = HellaSwagEvaluator(cfg, policy=policy)
        correct, total = ev.evaluate(gpt, tokenizer, split=args.hellaswag_split,
                                     data_dir=args.hellaswag_dir, limit=args.hellaswag_limit)
        result["hellaswag_correct"] = correct
        result["hellaswag_total"] = total
        result["hellaswag_acc"] = correct / max(total, 1)
        if ev.skipped_too_long:
            result["hellaswag_skipped_too_long"] = ev.skipped_too_long

    if args.coco_tokens or args.coco_ann:
        if not (args.coco_tokens and args.coco_ann):
            raise SystemExit("--coco-tokens and --coco-ann go together")
        if not args.bridge:
            raise SystemExit("--bridge is required for caption eval")
        from ..ckpt.torch_import import bridge_from_checkpoint, read_checkpoint
        from ..core.config import BridgeConfig
        from ..data.coco import CocoClipTokensDataset
        from ..eval.caption_eval import evaluate_captions
        from ..models import bridges, caption

        ds = CocoClipTokensDataset(args.coco_tokens, args.coco_ann, tokenizer,
                                   max_len=args.new_tokens + 8)
        enc_dim = int(ds.features(0).shape[-1])
        bridge_sd = None
        if args.bridge != "xattn":
            if args.bridge_ckpt:
                bridge_sd = bridge_from_checkpoint(read_checkpoint(args.bridge_ckpt),
                                                   args.bridge)
            elif raw.bridge is not None:
                bridge_sd = bridge_from_checkpoint(raw, args.bridge)
        if args.bridge == "xattn":
            if not cfg.cross_attention:
                raise SystemExit("--bridge xattn needs a cross-attention GPT checkpoint "
                                 "(transformer.h.N.xattn.* keys)")
            bridge_cfg, model = None, gpt
        else:
            if bridge_sd is None:
                raise SystemExit(
                    f"--bridge {args.bridge} needs --bridge-ckpt (or a "
                    "GPT_Caption .pt as --gpt-ckpt)"
                )
            qformer = args.bridge == "qformer"
            bridge_cfg = BridgeConfig(
                kind=args.bridge, enc_dim=enc_dim,
                n_queries=int(bridge_sd["query_tokens"].shape[0]) if qformer else 32,
                n_layers=(1 + max(int(k.split(".")[1]) for k in bridge_sd
                                  if k.startswith("layers."))) if qformer else 2,
            )
            bridge = bridges.bridge_init(bridge_cfg, cfg.n_embd, device=device)
            bridge.load_state_dict(bridge_sd)
            model = caption.CaptionModel(gpt, bridge)
        out = evaluate_captions(
            model, ds, cfg, bridge_cfg, tokenizer, max_samples=args.cider_samples,
            max_new_tokens=args.new_tokens, batch_size=args.batch_size,
            prompt=args.prompt, policy=policy, seed=args.seed,
            compute_meteor=args.meteor,
        )
        result["cider"] = out["cider"]
        result["cider_samples"] = min(args.cider_samples, len(ds))
        if args.meteor:
            result["meteor"] = out["meteor"]
            result["meteor_synonyms"] = out["meteor_synonyms"]

    line = json.dumps(result)
    print(line)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return result


if __name__ == "__main__":
    main()
