"""Fused AdamW update: the hand-written CUDA kernel and its plain version.

Counterpart of gpt2_vision_language_tpu/ops/fused_adamw.py. The kernel in
``csrc/adamw.cu`` replaces ``_adamw_kernel`` (:36, launched per leaf by
``fused_adamw_leaf`` :62): one launch updates every leaf in place, reading
the seven scalars ``[lr, beta1, beta2, eps, clip_scale, bc1, bc2]`` from an
fp32 device tensor and each leaf's weight decay from a device table.

``fused_adamw`` launches it for CUDA tensors and runs the plain version,
``adamw_reference`` (the arithmetic of train/optimizer.py:384-406), leaf by
leaf for CPU tensors; each launch adds one to ``fused_adamw.launches``.
Unlike the JAX version, leaves of any size are taken.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import _build


def adamw_reference(p, g, m, v, scalars, *, wd: float):
    """One AdamW step of one fp32 leaf, in place on p, m and v (returned).
    scalars: fp32 [lr, beta1, beta2, eps, clip_scale, bc1, bc2]. Decoupled
    weight decay p * (1 - lr * wd) comes before the Adam step (torch order)."""
    lr, b1, b2, eps, clip_scale, bc1, bc2 = scalars.unbind()
    g = g * clip_scale
    m.copy_(b1 * m + (1.0 - b1) * g)
    v.copy_(b2 * v + (1.0 - b2) * g * g)
    mhat = m / bc1
    vhat = v / bc2
    if wd:
        p.mul_(1.0 - lr * wd)
    p.sub_(lr * mhat / (torch.sqrt(vhat) + eps))
    return p, m, v


def _leaf_table(leaves, wds, chunk: int, device):
    """The kernel's Leaf records as an int64 (n, 7) device tensor (p, g, m,
    v pointers, numel, first chunk, wd's fp32 bits) and the chunk count."""
    n = np.array([leaf[0].numel() for leaf in leaves], np.int64)
    chunks = -(-n // chunk)
    rows = np.zeros((len(leaves), 7), np.int64)
    rows[:, :4] = [[a.data_ptr() for a in leaf] for leaf in leaves]
    rows[:, 4] = n
    rows[:, 5] = np.cumsum(chunks) - chunks
    rows[:, 6] = np.array(wds, np.float32).view(np.uint32)
    return torch.from_numpy(rows).to(device), int(chunks.sum())


def fused_adamw_cuda(leaves, scalars, wds):
    """Launch the CUDA kernel over leaves [(p, g, m, v), ...], in place."""
    for leaf in leaves:
        if any(a.dtype != torch.float32 or not a.is_contiguous() or not a.is_cuda
               for a in leaf):
            raise ValueError("fused_adamw kernel takes contiguous fp32 CUDA tensors")
    if scalars.dtype != torch.float32 or scalars.numel() != 7 or not scalars.is_cuda:
        raise ValueError("fused_adamw kernel takes 7 fp32 scalars on the device")
    lib = _build.load()
    device = scalars.device
    table, n_chunks = _leaf_table(leaves, wds, lib.gpt2vl_adamw_chunk(), device)
    scalars = scalars.contiguous()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.gpt2vl_adamw(table.data_ptr(), len(leaves), n_chunks,
                               scalars.data_ptr(), stream)
    _build.check(err, "adamw")
    fused_adamw.launches += 1


def fused_adamw(leaves, scalars, wds):
    """AdamW over leaves [(p, g, m, v), ...] of fp32 tensors, in place; wds
    the per-leaf weight decay. CUDA tensors go to the kernel (one launch for
    all leaves) and anything it does not take raises; CPU tensors go to
    ``adamw_reference`` leaf by leaf."""
    if len(leaves) != len(wds):
        raise ValueError("fused_adamw: one weight decay per leaf")
    for leaf in leaves:
        if not all(a.shape == leaf[0].shape for a in leaf):
            raise ValueError("fused_adamw: p, g, m, v of one leaf differ in shape")
        if not all(a.device == scalars.device for a in leaf):
            raise ValueError("fused_adamw: leaves and scalars on different devices")
    if not leaves:
        return
    if scalars.is_cuda:
        fused_adamw_cuda(leaves, scalars, wds)
    elif scalars.device.type == "cpu":
        for (p, g, m, v), wd in zip(leaves, wds):
            adamw_reference(p, g, m, v, scalars, wd=wd)
    else:
        raise ValueError(f"fused_adamw: no kernel for device {scalars.device}")


fused_adamw.launches = 0
