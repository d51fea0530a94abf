"""Fused LM-head + cross-entropy forward: the CUDA kernel, its plain version,
and the routed ``fused_linear_ce``.

Counterpart of gpt2_vision_language_tpu/ops/fused_ce.py. The kernel in
``csrc/ce_fwd.cu`` replaces ``_ce_fwd_kernel`` (:93, launched by
``_ce_fwd_pallas`` :173): per-row NLL and logsumexp of x @ w.T with the
logits kept fp32 and never written to memory. ``ce_forward`` runs it for
CUDA tensors and its plain version, ``ce_forward_reference``, for CPU
tensors; each launch adds one to ``ce_forward.launches``.

``fused_linear_ce`` routes as the JAX function does (:409-428), with "on
TPU" read as "on CUDA": a call without autograd under a non-fp32 compute
policy takes the kernel; everything else takes the chunked plain path of
``_make._fwd_impl`` (:291-329), whose logits round to the compute dtype.
The custom recompute backward (:331) is not ported yet; the plain path is
differentiated by autograd, and the kernel path has no backward.
"""

from __future__ import annotations

import torch

from .. import _build
from ..core.precision import Policy, DEFAULT_POLICY
from .layers import matmul_f32

IMPLS = ("auto", "kernel", "xla")


def ce_forward_reference(x, w, targets, *, n_chunks: int = 1,
                         logits_dtype: torch.dtype = torch.float32):
    """Plain version of the kernel: per-row (nll, lse) fp32 of x @ w.T over
    one chunk of rows at a time, the logits accumulated in fp32 from x and w
    as given. targets must lie in [0, V). With a low-precision
    ``logits_dtype`` the logits are rounded to it before the fp32 logsumexp:
    the JAX package's plain route (``_make._fwd_impl``, :291-329)."""
    nll, lse = [], []
    for xc, tc in zip(x.chunk(n_chunks), targets.chunk(n_chunks)):
        logits = matmul_f32(xc, w.t()).to(logits_dtype).float()
        lz = torch.logsumexp(logits, dim=-1)
        nll.append(lz - logits.gather(1, tc.long()[:, None])[:, 0])
        lse.append(lz)
    return torch.cat(nll), torch.cat(lse)


def _split_count(n: int, v: int, lib, device) -> int:
    """Vocab splits per row tile: enough blocks for about two waves of the
    card's SMs (three blocks fit on one), at most one split per vocab tile."""
    row_tiles = -(-n // lib.gpt2vl_ce_fwd_block_rows())
    vocab_tiles = -(-v // lib.gpt2vl_ce_fwd_tile_cols())
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return max(1, min(vocab_tiles, -(-6 * sms // row_tiles)))


def ce_forward_cuda(x, w, targets):
    """Launch the CUDA kernel: (nll, lse), each (N,) fp32."""
    n, d = x.shape
    v = w.shape[0]
    if x.dtype != torch.bfloat16 or w.dtype != torch.bfloat16:
        raise ValueError(f"ce_forward kernel takes bf16 x and w, got {x.dtype}, {w.dtype}")
    if targets.dtype != torch.int32:
        raise ValueError(f"ce_forward kernel takes int32 targets, got {targets.dtype}")
    if not (x.is_contiguous() and w.is_contiguous() and targets.is_contiguous()):
        raise ValueError("ce_forward kernel takes contiguous x, w and targets")
    if d % 8:
        raise ValueError(f"ce_forward kernel needs D % 8 == 0, got D={d}")
    if x.data_ptr() % 16 or w.data_ptr() % 16:
        raise ValueError("ce_forward kernel: x and w must be 16-byte aligned")
    lib = _build.load()
    nsplit = _split_count(n, v, lib, x.device)
    nll = torch.empty(n, dtype=torch.float32, device=x.device)
    lse = torch.empty(n, dtype=torch.float32, device=x.device)
    part = torch.empty(3 * nsplit * n, dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.gpt2vl_ce_fwd(
            x.data_ptr(), w.data_ptr(), targets.data_ptr(), nll.data_ptr(),
            lse.data_ptr(), part.data_ptr(), n, d, v, nsplit, stream,
        )
    _build.check(err, "ce_fwd")
    ce_forward.launches += 1
    return nll, lse


class _CEFwd(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, targets):
        return ce_forward_cuda(x, w, targets)

    @staticmethod
    def backward(ctx, dnll, dlse):
        raise NotImplementedError(
            "fused CE backward is not ported yet (ROADMAP Queue 2, K4 backward)"
        )


def ce_forward(x, w, targets):
    """Per-row (nll, lse) of x (N, D) @ w (V, D).T over the whole vocab, fp32.
    targets (N,) int32 in [0, V). CUDA tensors go to the kernel (bf16, D % 8
    == 0, contiguous) and anything it does not take raises; CPU tensors go to
    the plain version."""
    if not (x.dim() == 2 and w.dim() == 2 and x.shape[1] == w.shape[1]
            and targets.shape == x.shape[:1]):
        raise ValueError(
            "ce_forward takes x (N, D), w (V, D), targets (N,), got "
            f"{tuple(x.shape)}, {tuple(w.shape)}, {tuple(targets.shape)}"
        )
    if not (x.device == w.device == targets.device):
        raise ValueError("ce_forward: x, w, targets on different devices")
    if x.is_cuda:
        return _CEFwd.apply(x, w, targets)
    if x.device.type == "cpu":
        return ce_forward_reference(x, w, targets)
    raise ValueError(f"ce_forward: no kernel for device {x.device}")


ce_forward.launches = 0


def fused_linear_ce(x, w, targets, *, n_chunks: int = 8,
                    policy: Policy = DEFAULT_POLICY, impl: str = "auto"):
    """Per-position NLL (N,) fp32 of a tied LM head without the full logits.

    x: (N, D) final hiddens (already layer-normed). w: (V, D) unembedding
    (tied wte). targets: (N,) class ids in [0, V); the ignore index -100 must
    be clipped by the caller, who masks those rows.

    impl: "auto" takes the kernel for a call without autograd, under a
    non-fp32 compute policy, on CUDA tensors, and the chunked plain path
    otherwise; "kernel" forces ``ce_forward`` (its plain version on CPU
    tensors); "xla" forces the chunked plain path. Anything else raises.
    """
    if impl not in IMPLS:
        raise ValueError(
            f"fused_linear_ce: unknown impl {impl!r}; expected one of {IMPLS}"
        )
    if impl == "auto":
        no_grad = not (torch.is_grad_enabled()
                       and (x.requires_grad or w.requires_grad))
        use_kernel = (no_grad and x.is_cuda
                      and policy.compute_dtype != torch.float32)
        impl = "kernel" if use_kernel else "xla"
    x, w = policy.cast_compute(x), policy.cast_compute(w)
    if impl == "kernel":
        nll, _ = ce_forward(x.contiguous(), w.contiguous(),
                            targets.to(torch.int32).contiguous())
    else:
        nll, _ = ce_forward_reference(x, w, targets, n_chunks=int(n_chunks),
                                      logits_dtype=policy.compute_dtype)
    return nll
