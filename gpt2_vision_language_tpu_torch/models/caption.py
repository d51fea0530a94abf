"""Prefix-conditioning caption model: frozen GPT-2 + trainable bridge.

Counterpart of gpt2_vision_language_tpu/models/caption.py (GPT_Caption,
gpt2_linear/model.py:134-211 and its q_former twin): bridge(pooled CLIP
tokens) -> M visual embeddings that are concatenated BEFORE the text
embeddings. The subtleties it reproduces:

  * the visual prefix gets NO positional embeddings; text positions restart
    at 0 (gpt2_linear/model.py:197-200);
  * the loss reads positions [M, M+T) against labels with ignore_index=-100
    (gpt2_linear/model.py:205-210);
  * the LM is frozen (requires_grad_(False), :161-164): here by the
    trainable mask of the train step, which turns requires_grad off so the
    frozen weights get no gradient work;
  * text must fit: M + T <= block_size raises otherwise.

``CaptionModel`` holds both halves under the reference's names (``gpt.*``,
``bridge.*``), so one ``named_parameters`` walk gives the train step, the
optimizer and the checkpoint their leaves. The functions take it where the
JAX functions take ``gpt_params, bridge_params``.

``loss`` goes through ``gpt2.fused_ce_loss``: on CUDA under the bf16 policy
the fused CE kernel, and under autograd the logits-gradient kernel in its
backward (the frozen head gets no dw); the chunked plain forward and
backward otherwise. Generation uses the KV-cached Decoder with
``prefix_embeds``.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..core.config import BridgeConfig, GPTConfig
from ..core.precision import Policy, DEFAULT_POLICY
from . import gpt2
from .bridges import bridge_apply, bridge_init


class CaptionModel(nn.Module):
    """Parameter container: ``gpt`` (a gpt2.GPT2) and ``bridge``."""

    def __init__(self, gpt: gpt2.GPT2, bridge: nn.Module):
        super().__init__()
        self.gpt = gpt
        self.bridge = bridge


def init(cfg: GPTConfig, bridge_cfg: BridgeConfig, *,
         generator: Optional[torch.Generator] = None, device=None) -> nn.Module:
    """Bridge parameters only: the LM comes from the pretrain checkpoint
    (gpt2_linear/train.py:100-104)."""
    return bridge_init(bridge_cfg, cfg.n_embd, generator=generator, device=device)


def embed_visual(bridge: nn.Module, patch_tokens, bridge_cfg: BridgeConfig, *,
                 policy: Policy = DEFAULT_POLICY, generator=None, train: bool = False):
    """(B, N, enc_dim) pooled CLIP tokens -> (B, M, d) visual prefix."""
    if patch_tokens.dim() == 2:
        patch_tokens = patch_tokens[:, None, :]
    if bridge_cfg.use_cls_only:
        patch_tokens = patch_tokens[:, 0:1, :]
    return bridge_apply(bridge, patch_tokens, bridge_cfg, policy=policy,
                        generator=generator, train=train)


def _embed_full(model: CaptionModel, patch_tokens, input_ids, cfg, bridge_cfg, policy,
                generator, train):
    """[visual prefix, text] embeddings in the compute dtype, and M."""
    img = embed_visual(model.bridge, patch_tokens, bridge_cfg, policy=policy,
                       generator=generator, train=train)
    m, t_txt = img.shape[1], input_ids.shape[1]
    if m + t_txt > cfg.block_size:
        raise ValueError(
            f"visual prefix {m} + text {t_txt} exceeds block_size {cfg.block_size}"
        )
    txt = gpt2.embed_tokens(model.gpt, input_ids, cfg, pos_offset=0)
    cd = policy.compute_dtype
    return torch.cat([img.to(cd), txt.to(cd)], dim=1), m


def apply(model: CaptionModel, patch_tokens, input_ids, cfg: GPTConfig,
          bridge_cfg: BridgeConfig, *, labels=None, policy: Policy = DEFAULT_POLICY,
          generator=None, train: bool = False):
    """Forward. Returns (logits over [img, txt] positions, loss or None)."""
    full, m = _embed_full(model, patch_tokens, input_ids, cfg, bridge_cfg, policy,
                          generator, train)
    logits = gpt2.forward_embeds(model.gpt, full, cfg, policy=policy)
    loss = None
    if labels is not None:
        loss = gpt2.cross_entropy(logits[:, m:m + input_ids.shape[1], :], labels)
    return logits, loss


def loss(model: CaptionModel, patch_tokens, input_ids, cfg: GPTConfig,
         bridge_cfg: BridgeConfig, *, labels, policy: Policy = DEFAULT_POLICY,
         generator=None, train: bool = False, ce_chunks: int = 8, group=None):
    """apply(...)[1]'s semantics, CE over the text positions against
    ignore_index=-100 labels, without the (B, M+T, V) logits: lm_head + CE run
    through gpt2.fused_ce_loss. ``group``: the data-parallel process group
    whose ranks hold the other rows of the batch (the masked mean over all
    of them, gpt2.fused_ce_loss)."""
    full, m = _embed_full(model, patch_tokens, input_ids, cfg, bridge_cfg, policy,
                          generator, train)
    x = gpt2.run_blocks(model.gpt, full, cfg, policy=policy)
    x = gpt2._ln(x, model.gpt.transformer.ln_f)
    x_txt = x[:, m:m + input_ids.shape[1], :]
    return gpt2.fused_ce_loss(x_txt, model.gpt.transformer.wte.weight, labels,
                              policy=policy, ce_chunks=ce_chunks, group=group)


def loss_fn_factory(cfg: GPTConfig, bridge_cfg: BridgeConfig, *,
                    policy: Policy = DEFAULT_POLICY, train: bool = True,
                    fused_ce: bool = True, group=None):
    """loss_fn(model, micro={'x','y','mask','z','generator'?}) for
    train/step.py. labels = y masked to -100 outside the caption
    (gpt2_linear/train.py:305-306). Dropout (the Q-Former's sites) is active
    when ``train`` and the micro-batch carries a ``generator``: validation
    batches carry none. ``group``: ``loss``'s, with the fused CE."""

    def loss_fn(model, micro):
        labels = torch.where(micro["mask"].bool(), micro["y"],
                             torch.full_like(micro["y"], -100))
        generator = micro.get("generator")
        kwargs = dict(labels=labels, policy=policy, generator=generator,
                      train=train and generator is not None)
        if fused_ce:
            return loss(model, micro["z"], micro["x"], cfg, bridge_cfg, group=group, **kwargs)
        return apply(model, micro["z"], micro["x"], cfg, bridge_cfg, **kwargs)[1]

    return loss_fn


@torch.no_grad()
def generate_captions(model: CaptionModel, patch_tokens, prompt_ids, cfg: GPTConfig,
                      bridge_cfg: BridgeConfig, generator, *, max_new_tokens: int = 24,
                      policy: Policy = DEFAULT_POLICY, decoder=None):
    """KV-cached nucleus-sampled caption generation (temperature 0.8, top-p
    0.9, gpt2_linear/data.py:108-127), by the sorted ``sample_top_p``: the
    sort-free sampler keeps the same set and took 13.1-19.9 ms a call on the
    H100 against 0.57-0.90 ms (infer/sampling.py)."""
    # local import: infer.decode itself imports models.gpt2
    from ..infer.decode import Decoder
    from ..infer.sampling import sample_top_p

    dec = decoder or Decoder(cfg, policy=policy, sample_fn=sample_top_p)
    img = embed_visual(model.bridge, patch_tokens, bridge_cfg, policy=policy)
    toks, _ = dec.generate(model.gpt, prompt_ids, max_new_tokens, generator,
                           prefix_embeds=img)
    return toks
