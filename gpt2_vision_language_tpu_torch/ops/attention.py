"""Scaled dot-product attention with explicit routing.

Counterpart of gpt2_vision_language_tpu/ops/attention.py:

  * impl="xla"   — plain einsum attention, fp32 softmax (the name is the JAX
    package's; here it is plain PyTorch);
  * impl="flash" — ops/flash_attention.py: the CUDA kernels for CUDA tensors
    (the self-attention family for Tq == Tk up to its longest T, the general
    streamed-K/V family for every other shape, Tq != Tk included), their
    plain versions for CPU tensors;
  * impl="auto"  — flash for causal self-attention (Tq == Tk) of at least
    AUTO_FLASH_MIN_T positions on CUDA tensors, xla otherwise; a long
    self-attention (T = 16384) reaches the general kernels through it;
  * impl="ring"  — ops/ring_attention.py over the ring that its
    ``set_ring`` installed: the sequence in chunks, each visible chunk pair
    through flash_attention_with_lse (the lse-forward and one-pass backward
    kernels for CUDA tensors), the partial results merged exactly. The
    port's layout is (B, T, H, hs) end to end, so the two transposes of the
    JAX route (:78-84 there) have no counterpart.
"""

from __future__ import annotations

from .flash_attention import flash_attention, flash_attention_reference

# The JAX package's flash threshold (ops/attention.py:52-64), kept so that both
# packages route the same shapes the same way. On the H100 the kernels win
# below it too: at the fine-tune shape (B=128, T=65, H=12, hs=64, causal) the
# forward kernel took 0.0717 ms against 0.5496 ms for the plain path, forward
# + backward through autograd 0.5604 ms against 1.8693 ms (chip_smoke.py phase
# 21, NVIDIA H100 80GB HBM3, 700.00 W), and at every T from 64 up in the
# forward. Lowering the threshold is a routing change of its own.
AUTO_FLASH_MIN_T = 512

IMPLS = ("auto", "xla", "flash", "ring")


def sdpa(q, k, v, *, causal: bool, impl: str = "auto", layout: str = "bhtd"):
    """Attention over (B, H, Tq, hs) x (B, H, Tk, hs) -> (B, H, Tq, hs), or
    the same in (B, T, H, hs) order with layout="bthd". Scale 1/sqrt(hs),
    softmax in fp32, causal masking right-aligned."""
    if impl not in IMPLS:
        raise ValueError(f"sdpa: unknown impl {impl!r}; expected one of {IMPLS}")
    if layout not in ("bthd", "bhtd"):
        raise ValueError(f"sdpa: unknown layout {layout!r}")
    t_axis = 1 if layout == "bthd" else 2
    if impl == "auto":
        use_flash = (
            causal
            and q.is_cuda
            and q.shape[t_axis] == k.shape[t_axis]
            and q.shape[t_axis] >= AUTO_FLASH_MIN_T
        )
        impl = "flash" if use_flash else "xla"
    if impl == "flash":
        return flash_attention(q, k, v, causal=causal, layout=layout)
    if impl == "ring":
        # sequence-chunked long-context path: needs set_ring() to have been
        # called with the ring to run over
        from . import ring_attention as ra

        if ra.RING is None:
            raise RuntimeError(
                "attn_impl='ring' needs ops.ring_attention.set_ring(ring) first"
            )
        return ra.ring_attention(q, k, v, ra.RING, causal=causal, layout=layout)
    return xla_sdpa(q, k, v, causal=causal, layout=layout)


def xla_sdpa(q, k, v, *, causal: bool, layout: str = "bhtd"):
    """Plain einsum attention (the flash kernel's plain version): fp32 scores
    and softmax, probabilities rounded to v.dtype, P @ V accumulated in fp32,
    output in q.dtype."""
    if layout == "bhtd":
        q, k, v = (a.transpose(1, 2) for a in (q, k, v))
    o, _ = flash_attention_reference(q, k, v, causal=causal)
    return o.transpose(1, 2) if layout == "bhtd" else o
