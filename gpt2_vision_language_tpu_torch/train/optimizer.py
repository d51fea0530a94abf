"""AdamW with decay/no-decay groups, global-norm clipping, freezing, and
moments stored in fp32, bf16 or 8 bits.

Counterpart of gpt2_vision_language_tpu/train/optimizer.py: weight decay 0.1
on the weights only (the decay mask), betas (0.9, 0.95), eps 1e-8, decoupled
decay applied before the Adam step (torch AdamW order), bias corrections from
``step + 1``, and grads scaled by min(1, clip / (norm + 1e-6)) with the global
norm over all trainable grads. Frozen params are left out of the update and
of the norm by a trainable mask.

Parameters, grads, moments and masks are dicts keyed by state-dict name
(``models.gpt2.named_params``: the tied weight once). Unlike the JAX
version, ``adamw_update`` updates params and moments in place, which keeps
one copy of each in device memory, and takes the global norm from its
caller (the train step computes it once for its NaN guard).

Which update a leaf takes is the JAX gate (train/optimizer.py:356-362),
decided on the JAX leaf: the leaves of fp32 params with fp32 moments whose
JAX leaf has a size that is a multiple of 128 and at least 1024
(ops/fused_adamw.py:98 there) go to ``ops/fused_adamw.fused_adamw``, one
launch of the CUDA kernel over all of them for CUDA tensors, the plain
version leaf by leaf for CPU tensors. Every other leaf (bf16 params, bf16
moments, the small fp32 leaves) takes the same arithmetic in fp32 leaf by
leaf, with one rounding per step at store (:363-406 there).
``use_fused=False`` runs the plain per-leaf version for every leaf, the path
the kernel is compared with.

Moments are stored as ``state_dtype`` asks (``adamw_init``): fp32 (the
reference's), bf16, or int8, the block-wise absmax scheme of Dettmers et al.
(blocks of Q8_BLOCK values, m signed, v as sqrt(v) unsigned). How the 8-bit
state is laid out decides which values share a block, so it follows the JAX
package's: the JAX parameter tree stacks the layers on a leading axis and
stores Linear weights (in, out), and its blocks of 256 run through that
stacked leaf in its element order. Here the moments of one JAX leaf are ONE
entry ``{"q": codes, "s": scales}`` keyed by the JAX leaf's path
(``ckpt/convert.jax_leaf_path``: "blocks/mlp/wfc", "wte"), whose codes run
layer by layer through each layer's weight in (in, out) order; eligibility
(``_q8_eligible``: ndim >= 2 and Q8_MIN_SIZE elements) is decided on that
stacked shape too, so at 1558M the stacked LayerNorm and bias leaves
((48, 1600) and up) get 8-bit moments, as in JAX. Every other moment is a
tensor keyed by the parameter's name. The 8-bit update walks a leaf in
chunks of leading rows (``_q8_chunk_rows``), the JAX chunked update's
grouping, so its fp32 temporaries stay one chunk.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from ..ckpt.convert import jax_leaf_path
from ..core.config import OptimizerConfig
from ..obs.spans import annotate, span
from ..ops.fused_adamw import adamw_reference, fused_adamw

# ---------------------------------------------------------------------------
# Block-wise 8-bit moment quantization (JAX train/optimizer.py:42-162)
# ---------------------------------------------------------------------------

Q8_BLOCK = 256
Q8_MIN_SIZE = 1 << 16  # smaller JAX leaves keep fp32 moments
Q8_CHUNK_TARGET = 1 << 22  # elements of a chunk's fp32 temporaries
Q8_CHUNK_MIN = 1 << 22  # leaves below this update whole
# the JAX gate of the fused AdamW kernel (ops/fused_adamw.py:98 there)
FUSED_LANES = 128


def _numel(shape) -> int:
    n = 1
    for d in shape:
        n *= int(d)
    return n


def _q8_eligible(shape) -> bool:
    """8-bit moments for a JAX leaf of this (stacked) shape."""
    return len(shape) >= 2 and _numel(shape) >= Q8_MIN_SIZE


def _q8_padded(n: int) -> int:
    return -(-n // Q8_BLOCK) * Q8_BLOCK


def q8_quantize(x: torch.Tensor, *, unsigned: bool = False) -> dict:
    """Flatten, pad to Q8_BLOCK, and absmax-quantize per block:
    {"q": (npad,) int8 (uint8 with unsigned=True, for non-negative inputs on
    the full [0, 255] range), "s": (npad / Q8_BLOCK,) fp32 scales}."""
    flat = x.float().reshape(-1)
    n = flat.numel()
    npad = _q8_padded(n)
    if npad != n:
        flat = torch.cat([flat, flat.new_zeros(npad - n)])
    blocks = flat.view(-1, Q8_BLOCK)
    absmax = blocks.abs().amax(dim=1)
    cap = 255.0 if unsigned else 127.0
    s = torch.where(absmax > 0, absmax, torch.ones_like(absmax)) / cap
    q = torch.round(blocks / s[:, None])
    q = q.clamp(0, 255).to(torch.uint8) if unsigned else q.clamp(-127, 127).to(torch.int8)
    return {"q": q.reshape(-1), "s": s}


def q8_dequantize(mq: dict, shape) -> torch.Tensor:
    """Inverse of q8_quantize back to fp32 of ``shape`` (the padding cut)."""
    blocks = mq["q"].view(-1, Q8_BLOCK).float()
    return (blocks * mq["s"][:, None]).reshape(-1)[:_numel(shape)].reshape(tuple(shape))


def _q8_chunk_rows(shape) -> int:
    """Rows of the leading axis per update chunk: the largest divisor G of
    shape[0] with (G * rest) % Q8_BLOCK == 0 and G * rest <= the target (or
    the smallest block-aligned G if even that exceeds it); 0 when no
    block-aligned split exists."""
    d0, rest = int(shape[0]), _numel(shape[1:])
    best = 0
    for g in range(1, d0 + 1):
        if d0 % g or (g * rest) % Q8_BLOCK:
            continue
        if best and g * rest > Q8_CHUNK_TARGET:
            break
        best = g
    return best


# ---------------------------------------------------------------------------
# JAX leaves over the port's parameters
# ---------------------------------------------------------------------------


class JaxLeaf:
    """One leaf of the JAX parameter tree over the port tensors it holds:
    ``names`` in layer order (one name for a leaf that is not stacked).
    ``shape`` is the JAX leaf's (stacked) shape; ``gather`` and ``scatter``
    move its rows [i0, i1) between the port's tensors and one flat fp32
    vector in the JAX leaf's element order."""

    def __init__(self, path, names, layered, transposed, layer_shape):
        self.path, self.names = path, names
        self.layered, self.transposed = layered, transposed
        self.layer_shape = layer_shape  # one layer's JAX shape (the whole leaf's if not layered)
        self.shape = ((len(names),) + layer_shape) if layered else layer_shape
        self.size = _numel(self.shape)

    def _jax_view(self, t):
        if self.transposed:
            return t.t()
        return t.reshape(self.layer_shape) if self.layered else t

    def gather(self, tensors: dict, i0: int, i1: int) -> torch.Tensor:
        if self.layered:
            return torch.cat([self._jax_view(tensors[n]).reshape(-1).float()
                              for n in self.names[i0:i1]])
        return self._jax_view(tensors[self.names[0]])[i0:i1].reshape(-1).float()

    def scatter(self, tensors: dict, i0: int, i1: int, flat: torch.Tensor) -> None:
        if self.layered:
            n = _numel(self.layer_shape)
            for j, name in enumerate(self.names[i0:i1]):
                self._jax_view(tensors[name]).copy_(flat[j * n:(j + 1) * n].view(self.layer_shape))
        else:
            dst = self._jax_view(tensors[self.names[0]])[i0:i1]
            dst.copy_(flat.view(dst.shape))


def jax_leaves(params: Dict[str, torch.Tensor]) -> Dict[str, JaxLeaf]:
    """JAX leaf path -> JaxLeaf over ``params`` (name -> tensor), in the
    order of the parameters' first names."""
    found: Dict[str, dict] = {}
    for name, p in params.items():
        path, layer, transposed = jax_leaf_path(name)
        e = found.setdefault(path, {"layers": {}, "transposed": transposed, "shape": p.shape,
                                    "stacked": layer is not None})
        e["layers"][layer] = name
    out = {}
    for path, e in found.items():
        if e["stacked"]:
            names = [e["layers"][i] for i in sorted(e["layers"])]
        else:
            names = [e["layers"][None]]
        shape = tuple(e["shape"])
        if e["transposed"]:
            shape = shape[::-1]
        elif e["stacked"] and path.endswith("blocks/gate"):
            shape = ()  # the cross-attention gate: a (1,) tensor here, a scalar layer there
        out[path] = JaxLeaf(path, names, e["stacked"], e["transposed"], shape)
    return out


def _resolve_dtype(state_dtype):
    """None, a torch dtype or its name ("float32", "bfloat16", "int8")."""
    if state_dtype is None or isinstance(state_dtype, torch.dtype):
        return state_dtype
    return {"float32": torch.float32, "bfloat16": torch.bfloat16, "int8": torch.int8}[state_dtype]


def _q8_leaves(params, state_dtype, trainable_mask) -> Dict[str, JaxLeaf]:
    """The JAX leaves whose moments are 8-bit under ``state_dtype``."""
    if _resolve_dtype(state_dtype) != torch.int8:
        return {}
    return {path: leaf for path, leaf in jax_leaves(params).items()
            if _q8_eligible(leaf.shape)
            and (trainable_mask is None or all(trainable_mask[n] for n in leaf.names))}


def _q8_zeros(npad: int, unsigned: bool, device) -> dict:
    return {"q": torch.zeros(npad, dtype=torch.uint8 if unsigned else torch.int8, device=device),
            "s": torch.full((npad // Q8_BLOCK,), 1.0 / 127.0, dtype=torch.float32,
                            device=device)}


def adamw_init(params: Dict[str, torch.Tensor], state_dtype=None, trainable_mask=None,
               placement=None) -> dict:
    """Zero moments; frozen leaves get none. ``state_dtype``: None stores
    each moment in its param's dtype (fp32 for fp32 params), ``bfloat16``
    halves them, ``int8`` block-quantizes the moments of every eligible JAX
    leaf (see the module docstring) and keeps the others fp32. The update's
    arithmetic is fp32 whatever the storage. ``placement``: the
    parallel/sharding.Placement of a rank that holds part of the model
    (``params`` are its part); its 8-bit moments are those of the whole JAX
    leaves, the rank's slices of them (``Placement.q8_sizes``)."""
    dt = _resolve_dtype(state_dtype)
    dev = next(iter(params.values())).device
    if placement is not None and placement.split:
        sizes = placement.q8_sizes() if dt == torch.int8 else {}
        in_q8 = {n for path in sizes for n in placement.leaves[path].names}
    else:
        q8 = _q8_leaves(params, dt, trainable_mask)
        sizes = {path: _q8_padded(leaf.size) for path, leaf in q8.items()}
        in_q8 = {n for leaf in q8.values() for n in leaf.names}

    def moments(unsigned):
        out = {}
        for n, p in params.items():
            if (trainable_mask is None or trainable_mask[n]) and n not in in_q8:
                want = torch.float32 if dt == torch.int8 else (dt or p.dtype)
                out[n] = torch.zeros_like(p, dtype=want)
        for path, npad in sizes.items():
            out[path] = _q8_zeros(npad, unsigned, dev)
        return out

    return {"m": moments(False), "v": moments(True), "step": 0}


def convert_moments(params: Dict[str, torch.Tensor], opt_state: dict, state_dtype=None,
                    trainable_mask=None) -> dict:
    """A (restored) optimizer state re-encoded into the storage that
    ``adamw_init(state_dtype=...)`` builds, keeping the moment values: fp32
    or bf16 tensors or 8-bit blocks (v's 8-bit form is sqrt(v) on the
    unsigned grid, the tensor forms hold v). Moments already in the wanted
    format pass through as they are (no requantization on a same-format
    resume). Returns a new state dict; its tensors lie on the params'
    devices."""
    dt = _resolve_dtype(state_dtype)
    q8 = _q8_leaves(params, dt, trainable_mask)
    leaves = jax_leaves(params)

    def walk(cur: dict, is_v: bool) -> dict:
        out = {}
        for path, leaf in leaves.items():
            trainable = [n for n in leaf.names if trainable_mask is None or trainable_mask[n]]
            if not trainable:
                continue
            dev = params[leaf.names[0]].device
            stored_q8 = isinstance(cur.get(path), dict)
            if path in q8:
                if stored_q8:
                    out[path] = {k: a.to(dev) for k, a in cur[path].items()}
                else:
                    x = leaf.gather({n: cur[n].to(dev) for n in leaf.names}, 0, len(leaf.names)
                                    if leaf.layered else leaf.shape[0])
                    out[path] = q8_quantize(x.sqrt() if is_v else x, unsigned=is_v)
                continue
            if stored_q8:  # 8-bit blocks -> tensors (the sqrt(v) grid back to v)
                x = q8_dequantize({k: a.to(dev) for k, a in cur[path].items()}, leaf.shape)
                x = (x * x if is_v else x).reshape(-1)
                tmp = {n: torch.empty_like(params[n], dtype=torch.float32) for n in leaf.names}
                leaf.scatter(tmp, 0, len(leaf.names) if leaf.layered else leaf.shape[0], x)
                src = tmp
            else:
                src = cur
            for n in trainable:
                want = torch.float32 if dt == torch.int8 else (dt or params[n].dtype)
                out[n] = src[n].to(device=params[n].device, dtype=want)
        return out

    out = dict(opt_state)
    out["m"] = walk(opt_state["m"], False)
    out["v"] = walk(opt_state["v"], True)
    return out


def global_norm(grads: Dict[str, torch.Tensor], mask=None) -> torch.Tensor:
    """sqrt of the sum of squares of the (masked-in) grads, fp32, on their
    device (each grad upcast inside its own reduction: bf16 grads sum in
    fp32). One process's grads; over processes the train step takes the
    global gradient's norm from parallel/collectives.GradSync.norm (the
    sharded leaves' squares summed over ``model``, each replicated leaf
    once)."""
    sq = [g.float().square().sum() for n, g in grads.items()
          if mask is None or mask[n]]
    return torch.stack(sq).sum().sqrt()


def _adam_f32(p32, g32, m32, v32, lr, clip_scale, bc1, bc2, cfg, wd):
    """The JAX leaf update's fp32 arithmetic (train/optimizer.py:387-395),
    in its order: (p, m, v) new fp32 tensors."""
    g32 = g32 * clip_scale
    m_new = cfg.beta1 * m32 + (1.0 - cfg.beta1) * g32
    v_new = cfg.beta2 * v32 + (1.0 - cfg.beta2) * g32 * g32
    if wd:
        p32 = p32 * (1.0 - lr * wd)
    p32 = p32 - lr * (m_new / bc1) / (torch.sqrt(v_new / bc2) + cfg.eps)
    return p32, m_new, v_new


def _q8_chunk(p32, g32, mq, vq, b0, lr, clip_scale, bc1, bc2, cfg, wd):
    """The 8-bit update of n consecutive elements of a JAX leaf (p32, g32:
    fp32, flat) whose codes start at block ``b0`` of mq and vq: their codes
    and scales in place; returns the new fp32 values."""
    n = p32.numel()
    b1 = b0 + -(-n // Q8_BLOCK)
    m32 = q8_dequantize({"q": mq["q"][b0 * Q8_BLOCK:b1 * Q8_BLOCK], "s": mq["s"][b0:b1]}, (n,))
    r = q8_dequantize({"q": vq["q"][b0 * Q8_BLOCK:b1 * Q8_BLOCK], "s": vq["s"][b0:b1]}, (n,))
    p32, m_new, v_new = _adam_f32(p32, g32, m32, r * r, lr, clip_scale, bc1, bc2, cfg, wd)
    nm, nv = q8_quantize(m_new), q8_quantize(torch.sqrt(v_new), unsigned=True)
    mq["q"][b0 * Q8_BLOCK:b1 * Q8_BLOCK] = nm["q"]
    mq["s"][b0:b1] = nm["s"]
    vq["q"][b0 * Q8_BLOCK:b1 * Q8_BLOCK] = nv["q"]
    vq["s"][b0:b1] = nv["s"]
    return p32


def _q8_update(leaf: JaxLeaf, params, grads, mq, vq, lr, clip_scale, bc1, bc2, cfg, wd):
    """The 8-bit update of one JAX leaf, in place on its params and on the
    codes and scales of mq and vq, chunk by chunk of leading rows when the
    leaf is large (JAX _q8_update_leaf_chunked: the same arithmetic and
    block grouping as the whole-leaf update)."""
    rows = leaf.shape[0]
    g_rows = _q8_chunk_rows(leaf.shape) if leaf.size >= Q8_CHUNK_MIN else 0
    if not (g_rows and rows // g_rows > 1):
        g_rows = rows
    per_row = leaf.size // rows
    for i0 in range(0, rows, g_rows):
        i1 = i0 + g_rows
        p32 = _q8_chunk(leaf.gather(params, i0, i1), leaf.gather(grads, i0, i1), mq, vq,
                        i0 * per_row // Q8_BLOCK, lr, clip_scale, bc1, bc2, cfg, wd)
        leaf.scatter(params, i0, i1, p32)


def q8_update_flat(p32, g32, mq, vq, lr, clip_scale, bc1, bc2, cfg, wd) -> torch.Tensor:
    """The 8-bit update of a flat run of a JAX leaf's elements (p32, g32:
    fp32) whose codes are all of mq and vq, from a block boundary, in chunks
    of Q8_CHUNK_TARGET elements: codes and scales in place; returns the new
    fp32 values (parallel/sharding.Placement.update_q8)."""
    n = p32.numel()
    return torch.cat([_q8_chunk(p32[e0:e0 + Q8_CHUNK_TARGET], g32[e0:e0 + Q8_CHUNK_TARGET], mq, vq,
                                e0 // Q8_BLOCK, lr, clip_scale, bc1, bc2, cfg, wd)
                      for e0 in range(0, n, Q8_CHUNK_TARGET)])


def kernel_leaves(params: Dict[str, torch.Tensor], state: dict, trainable_mask=None) -> list:
    """Names of the trainable leaves the AdamW kernel takes: fp32 params with
    fp32 moments whose JAX leaf passes the JAX gate (a size that is a
    multiple of 128 and at least 1024)."""
    out = []
    for leaf in jax_leaves(params).values():
        if leaf.size % FUSED_LANES or leaf.size < 8 * FUSED_LANES:
            continue
        for n in leaf.names:
            if ((trainable_mask is None or trainable_mask[n]) and n in state["m"]
                    and params[n].dtype == torch.float32
                    and state["m"][n].dtype == torch.float32):
                out.append(n)
    return out


def adamw_update(
    params: Dict[str, torch.Tensor],
    grads: Dict[str, torch.Tensor],
    state: dict,
    lr: float,
    cfg: OptimizerConfig,
    *,
    norm: torch.Tensor,
    decay_mask,
    trainable_mask=None,
    use_fused: bool = True,
    grad_scale: Optional[float] = None,
    placement=None,
) -> None:
    """One optimizer step, in place on params and state.

    norm: the pre-clip global norm of the trainable grads, already scaled
    by grad_scale, an fp32 scalar on the params' device.
    grad_scale: a factor applied to every grad (the grad-accumulation
    1/accum mean), folded into the clip scale as the JAX version does.
    placement: the parallel/sharding.Placement of a rank that holds part of
    the model; its 8-bit leaves update through ``Placement.update_q8``
    (collective). Spans (``obs/spans.py``): ``optimizer.kernel`` around the
    kernel's launch, and the leaves each update took (``kernel``, ``plain``,
    ``q8``) added to the ``step.optimizer`` span of ``train/step.py`` where
    one is open."""
    if trainable_mask is None:
        trainable_mask = {n: True for n in params}
    step = state["step"] + 1
    t = np.float32(step)
    bc1 = np.float32(1.0) - np.float32(cfg.beta1) ** t
    bc2 = np.float32(1.0) - np.float32(cfg.beta2) ** t

    clip_scale = torch.clamp(cfg.grad_clip / (norm + 1e-6), max=1.0)
    if grad_scale is not None:
        clip_scale = clip_scale * grad_scale

    device = norm.device
    scalars = torch.tensor(
        [lr, cfg.beta1, cfg.beta2, cfg.eps, 0.0, bc1, bc2], dtype=torch.float32
    ).to(device)
    scalars[4] = clip_scale
    lr_t, bc1_t, bc2_t = scalars[0], scalars[5], scalars[6]
    fused = set(kernel_leaves(params, state, trainable_mask)) if use_fused else set()
    kernel, kernel_wds = [], []
    n_plain = n_q8 = 0
    with torch.no_grad():
        for path, leaf in jax_leaves(params).items():
            wd = cfg.weight_decay if decay_mask[leaf.names[0]] else 0.0
            if isinstance(state["m"].get(path), dict):  # 8-bit moments of the whole JAX leaf
                if trainable_mask[leaf.names[0]]:
                    mq, vq = state["m"][path], state["v"][path]
                    if placement is not None and placement.split:
                        placement.update_q8(path, params, grads, mq, vq, lr_t, clip_scale,
                                            bc1_t, bc2_t, cfg, wd)
                    else:
                        _q8_update(leaf, params, grads, mq, vq, lr_t, clip_scale, bc1_t, bc2_t,
                                   cfg, wd)
                    n_q8 += 1
                continue
            for n in leaf.names:
                if not trainable_mask[n]:
                    continue
                p, g, m, v = params[n], grads[n], state["m"][n], state["v"][n]
                if n in fused:  # the kernel reads fp32 grads (bf16 accumulators upcast)
                    kernel.append((p, g if g.dtype == torch.float32 else g.float(), m, v))
                    kernel_wds.append(wd)
                    continue
                if p.dtype == g.dtype == m.dtype == v.dtype == torch.float32:
                    adamw_reference(p, g, m, v, scalars, wd=wd)
                else:  # compact storage: fp32 arithmetic, one rounding at store
                    p32, m32, v32 = _adam_f32(p.float(), g.float(), m.float(), v.float(),
                                              lr_t, clip_scale, bc1_t, bc2_t, cfg, wd)
                    p.copy_(p32)
                    m.copy_(m32)
                    v.copy_(v32)
                n_plain += 1
        if kernel:
            with span("optimizer.kernel"):
                fused_adamw(kernel, scalars, kernel_wds)
    annotate("step.optimizer", kernel=len(kernel), plain=n_plain, q8=n_q8)
    state["step"] = step


def freeze(model: torch.nn.Module, trainable_mask) -> None:
    """requires_grad_(False) on the frozen params (the reference's freeze,
    gpt2_linear/model.py:161-164): they get no gradient and no backward
    work."""
    for n, p in model.named_parameters():
        if n in trainable_mask:
            p.requires_grad_(bool(trainable_mask[n]))
