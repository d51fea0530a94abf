"""Seeded GPT-2 weights, made on the device in one call of the generator.

The benchmark makes the weights itself and hands the same values to the
program and to the plain reference. The distribution is GPT-2's
(``initializer_range`` 0.02; the residual output projections scaled by
(2 * n_layer) ** -0.5; LayerNorm scales 1, biases 0): one ``torch.randn`` over
a flat fp32 buffer from a ``torch.Generator`` on the device, each leaf a view
of it. Names and shapes are the GPT-2 state dict's (nn.Linear weights
(out, in); the head tied to ``transformer.wte.weight``).
"""

from __future__ import annotations

import torch


def dims(config: dict, seq_len: int) -> dict:
    """The sizes the model is run at: the padded vocabulary, and the
    position table grown to the cell's sequence length where that is longer
    than ``n_positions``."""
    pad = int(config["assumed"]["padded_vocab_size"])
    if pad < config["vocab_size"] or pad % 128:
        raise ValueError(f"padded_vocab_size {pad} for vocab {config['vocab_size']}")
    return {"n_layer": config["n_layer"], "n_head": config["n_head"],
            "n_embd": config["n_embd"], "vocab": config["vocab_size"], "vocab_pad": pad,
            "block": max(config["n_positions"], seq_len),
            "eps": config["layer_norm_epsilon"]}


def shapes(d: dict) -> list:
    """[(name, shape)] in the state dict's order (the tied head once)."""
    c = d["n_embd"]
    out = [("transformer.wte.weight", (d["vocab_pad"], c)),
           ("transformer.wpe.weight", (d["block"], c))]
    for i in range(d["n_layer"]):
        p = f"transformer.h.{i}."
        out += [(p + "ln_1.weight", (c,)), (p + "ln_1.bias", (c,)),
                (p + "attn.c_attn.weight", (3 * c, c)), (p + "attn.c_attn.bias", (3 * c,)),
                (p + "attn.c_proj.weight", (c, c)), (p + "attn.c_proj.bias", (c,)),
                (p + "ln_2.weight", (c,)), (p + "ln_2.bias", (c,)),
                (p + "mlp.c_fc.weight", (4 * c, c)), (p + "mlp.c_fc.bias", (4 * c,)),
                (p + "mlp.c_proj.weight", (c, 4 * c)), (p + "mlp.c_proj.bias", (c,))]
    out += [("transformer.ln_f.weight", (c,)), ("transformer.ln_f.bias", (c,))]
    return out


def make(config: dict, seq_len: int, seed: int, device) -> tuple:
    """(flat fp32 buffer, {name: view}) of the seeded weights on ``device``.
    The same seed gives the same values on the same device."""
    d = dims(config, seq_len)
    std = float(config["initializer_range"])
    proj_std = std * (2 * d["n_layer"]) ** -0.5
    leaves = shapes(d)
    total = sum(torch.Size(s).numel() for _, s in leaves)
    gen = torch.Generator(device).manual_seed(int(seed))
    flat = torch.randn(total, generator=gen, device=device, dtype=torch.float32)
    views, off = {}, 0
    with torch.no_grad():
        for name, shape in leaves:
            n = torch.Size(shape).numel()
            v = flat[off:off + n].view(shape)
            off += n
            if len(shape) == 2:
                v.mul_(proj_std if name.endswith("c_proj.weight") else std)
            elif name.endswith(("ln_1.weight", "ln_2.weight", "ln_f.weight")):
                v.fill_(1.0)
            else:
                v.zero_()
            views[name] = v
    return flat, views
