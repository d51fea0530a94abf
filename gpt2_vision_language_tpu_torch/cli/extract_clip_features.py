"""CLI: precompute CLIP patch-token shards for COCO (the tool absent from
the reference repo: its bridges consume shards whose extraction script was
never checked in; SURVEY.md §6 defect c).

    python -m gpt2_vision_language_tpu_torch.cli.extract_clip_features \\
        --coco-root coco2017 --split train --out clip_feats_full/train \\
        --hf-ckpt /path/to/clip-vit-large-patch14  [--variant vit-l-14]

Counterpart of gpt2_vision_language_tpu/cli/extract_clip_features.py: the
same flags and output, plus ``--device`` (default ``cuda``; ``cpu`` to ask
for the CPU). The host decodes each JPEG and does CLIP's aspect-preserving
resize of the shorter side (bicubic) and the centre crop with PIL
(``load_batch``); the device normalises and runs the ViT (``encode``,
bf16 compute as in JAX); ``ShardWriter`` stores float16 (B, 1 + N, width)
rows as ``clip_tokens_NNNNN.npy`` shards plus ``index.json``, which
data/coco.CocoClipTokensDataset reads. ``--hf-ckpt`` takes an HF
CLIPVisionModel or CLIPModel directory or weights file
(ckpt/torch_import.load_hf_state_dict: ``pytorch_model.bin`` or
``model.safetensors``), read without ``transformers``.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np

VARIANTS = {"vit-l-14": "CLIP_VIT_L14", "vit-b-16": "CLIP_VIT_B16", "tiny": "CLIP_TINY"}


def resolve_device(name: str, who: str):
    """torch.device(name); a CUDA device that is not there raises."""
    import torch

    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"{who}: no CUDA device (torch.cuda.is_available() is False); "
                           "pass --device cpu to run on the CPU")
    return device


def load_encoder(cfg, hf_ckpt, device, *, warning: str):
    """The CLIP encoder on ``device``: HF weights from ``hf_ckpt``, else the
    seeded random init (seed 0), printing ``warning``."""
    import torch

    from ..models import clip_vit

    if hf_ckpt:
        from ..ckpt.torch_import import clip_from_hf_state_dict, load_hf_state_dict

        with torch.device(device):
            model = clip_vit.CLIPVisionTower(cfg)
        model.load_state_dict(clip_from_hf_state_dict(load_hf_state_dict(hf_ckpt), cfg))
        return model
    print(warning)
    return clip_vit.init(cfg, generator=torch.Generator(device).manual_seed(0), device=device)


def center_crop(img, size: int):
    """A PIL image -> (size, size, 3) uint8: the shorter side resized to
    ``size`` (bicubic, CLIP-canonical), then the centre crop."""
    from PIL import Image

    img = img.convert("RGB")
    w, h = img.size
    if w < h:
        nw, nh = size, max(size, round(h * size / w))
    else:
        nw, nh = max(size, round(w * size / h)), size
    img = img.resize((nw, nh), Image.BICUBIC)
    left, top = (nw - size) // 2, (nh - size) // 2
    return np.asarray(img.crop((left, top, left + size, top + size)))


def load_batch(paths, size: int) -> np.ndarray:
    """Image files -> (B, size, size, 3) uint8 crops (host side, PIL)."""
    from PIL import Image

    out = np.zeros((len(paths), size, size, 3), np.uint8)
    for i, path in enumerate(paths):
        with Image.open(path) as img:
            out[i] = center_crop(img, size)
    return out


def encode(model, crops_u8, cfg, device):
    """The device step: (B, S, S, 3) uint8 crops -> (B, 1 + N, width) CLIP
    tokens, normalised and encoded on ``device`` under the bf16 policy, as
    float16 numpy rows."""
    import torch

    from ..models import clip_vit

    with torch.no_grad():
        x = torch.as_tensor(crops_u8).to(device)
        feats = clip_vit.features(model, clip_vit.normalize_only(x), cfg)
        return feats.to(torch.float16).cpu().numpy()


class ShardWriter:
    """float16 ``clip_tokens_NNNNN.npy`` shards of ``rows_per_shard`` rows
    (the last one partial) and ``index.json``, one {"shard", "row"} entry an
    image in the order added."""

    def __init__(self, out: str, rows_per_shard: int):
        os.makedirs(out, exist_ok=True)
        self.out, self.rows_per_shard = out, rows_per_shard
        self.index, self.buffer, self.buffered = [], [], 0
        self.shards = self.total = 0

    def _write(self, rows):
        name = f"clip_tokens_{self.shards:05d}.npy"
        np.save(os.path.join(self.out, name), rows.astype(np.float16))
        self.shards += 1

    def add(self, feats: np.ndarray) -> None:
        rps = self.rows_per_shard
        for _ in range(len(feats)):
            self.index.append({"shard": f"clip_tokens_{self.total // rps:05d}.npy",
                               "row": self.total % rps})
            self.total += 1
        self.buffer.append(feats)
        self.buffered += len(feats)
        while self.buffered >= rps:
            rows = np.concatenate(self.buffer)
            self._write(rows[:rps])
            self.buffer = [rows[rps:]]
            self.buffered = len(self.buffer[0])

    def close(self) -> dict:
        if self.buffered:
            self._write(np.concatenate(self.buffer))
        with open(os.path.join(self.out, "index.json"), "w") as f:
            json.dump(self.index, f)
        return {"out": self.out, "shards": self.shards, "rows": self.total}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--coco-root", required=True)
    p.add_argument("--split", default="train", choices=["train", "val"])
    p.add_argument("--out", required=True)
    p.add_argument("--variant", default="vit-l-14", choices=list(VARIANTS))
    p.add_argument("--hf-ckpt", default=None,
                   help="local HF CLIPVisionModel dir (offline); random init if absent")
    p.add_argument("--batch", type=int, default=64)
    p.add_argument("--rows-per-shard", type=int, default=512)
    p.add_argument("--limit", type=int, default=None)
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu; a missing CUDA device raises")
    args = p.parse_args(argv)

    from ..core import config as C

    device = resolve_device(args.device, "extract_clip_features")
    cfg = getattr(C, VARIANTS[args.variant])
    ann = os.path.join(args.coco_root, "annotations", f"captions_{args.split}2017.json")
    with open(ann) as f:
        images = sorted(json.load(f)["images"], key=lambda im: im["id"])
    if args.limit:
        images = images[: args.limit]
    img_dir = os.path.join(args.coco_root, f"{args.split}2017")
    model = load_encoder(cfg, args.hf_ckpt, device,
                         warning="[extract] WARNING: no --hf-ckpt, using random CLIP init")

    writer = ShardWriter(args.out, args.rows_per_shard)
    for s in range(0, len(images), args.batch):
        metas = images[s: s + args.batch]
        paths = [os.path.join(img_dir, m.get("file_name", f"{m['id']:012d}.jpg"))
                 for m in metas]
        writer.add(encode(model, load_batch(paths, cfg.image_size), cfg, device))
        print(f"[extract] {min(s + args.batch, len(images))}/{len(images)}")
    out = writer.close()
    print(f"[extract] wrote {out['shards']} shards + index.json to {args.out}")
    return out


if __name__ == "__main__":
    main()
