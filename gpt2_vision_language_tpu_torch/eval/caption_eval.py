"""Caption-generation evaluation (CIDEr / METEOR) over COCO val.

Counterpart of gpt2_vision_language_tpu/eval/caption_eval.py. Reference:
evaluate_cider (gpt2_linear/data.py:68-135): the first 500 val images, prompt
"A photo of", 24 new tokens, temperature 0.8 + top-p 0.9, scored by CIDEr
against the raw reference captions. As in the JAX package the images go in
batches of 50 through the KV-cached Decoder (one prefill and 23 cached steps
a batch) instead of one full re-forward per token and image.

The sampler is the port's sorted ``sample_top_p``: it keeps the set of the
JAX package's sort-free ``sample_top_p_fast`` and took 0.57-0.90 ms a call
at (50, 50304) on the H100 against 13.1-19.9 ms (infer/sampling.py). ``compute_meteor=True`` adds METEOR and the
provenance of its synonym table (eval/meteor.py), as in the JAX package.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from ..core.config import BridgeConfig, GPTConfig
from ..core.precision import Policy, DEFAULT_POLICY
from ..data.coco import CocoClipTokensDataset
from ..infer.decode import Decoder, cast_decode_params
from ..infer.sampling import sample_top_p
from ..models import caption, gpt2
from ..ops.pooling import pool_clip_tokens_to_33
from .cider import CiderScorer
from .meteor import meteor_score, synonym_provenance


@torch.no_grad()
def evaluate_captions(
    model,
    dataset: CocoClipTokensDataset,
    cfg: GPTConfig,
    bridge_cfg: Optional[BridgeConfig],
    tokenizer,
    *,
    max_samples: int = 500,
    max_new_tokens: int = 24,
    batch_size: int = 50,
    prompt: str = "A photo of",
    policy: Policy = DEFAULT_POLICY,
    seed: int = 0,
    compute_meteor: bool = False,
    feature_bank=None,
    decoder: Optional[Decoder] = None,
) -> Dict[str, object]:
    """-> {"cider": float, "meteor": float?, "meteor_synonyms": str?,
    "captions": {idx: str}}.

    ``model`` is a models/caption.CaptionModel with ``bridge_cfg``, or, with
    bridge_cfg None, a gated cross-attention gpt2.GPT2 (z memory instead of a
    prefix; gpt2_cross-att/data.py eval path). It runs on the model's device;
    ``feature_bank`` (N, 33, D) on that device saves re-pooling the shards.
    """
    device = next(model.parameters()).device
    n_eval = min(max_samples, len(dataset))
    decoder = decoder or Decoder(cfg, policy=policy, sample_fn=sample_top_p)
    # serve from compute-dtype weight storage (a copy; no-op at fp32 policy)
    model = cast_decode_params(model, policy)
    prompt_ids = tokenizer.encode(prompt)
    generator = torch.Generator(device).manual_seed(seed)

    gts: Dict[int, List[str]] = {}
    res: Dict[int, List[str]] = {}
    for start in range(0, n_eval, batch_size):
        idxs = list(range(start, min(start + batch_size, n_eval)))
        if feature_bank is not None:
            z = feature_bank[torch.tensor(idxs, device=feature_bank.device)]
        else:
            feats = np.stack([dataset.features(i) for i in idxs])
            z = pool_clip_tokens_to_33(torch.from_numpy(feats).to(device))
        ids = torch.tensor([prompt_ids] * len(idxs), device=device)
        if bridge_cfg is not None:
            toks = caption.generate_captions(
                model, z, ids, cfg, bridge_cfg, generator,
                max_new_tokens=max_new_tokens, policy=policy, decoder=decoder,
            )
        else:
            # xattn variant: project the visual tokens once (gpt2.apply does it
            # for training; forward_cached expects the projected memory)
            zp = gpt2.project_visual(model, z, cfg, policy.compute_dtype, policy=policy)
            toks, _ = decoder.generate(model, ids, max_new_tokens, generator, z=zp)
        toks = toks.cpu().numpy()
        for row, i in enumerate(idxs):
            gts[i] = list(dataset.coco[i])
            res[i] = [tokenizer.decode(toks[row].tolist())]

    out: Dict[str, object] = {}
    out["cider"], _ = CiderScorer().compute_score(gts, res)
    if compute_meteor:
        out["meteor"], _ = meteor_score(gts, res)
        # scores are only comparable across machines at the same synonym
        # provenance (file:<path> / nltk-wordnet / builtin)
        out["meteor_synonyms"] = synonym_provenance()
    out["captions"] = {i: res[i][0] for i in res}
    return out
