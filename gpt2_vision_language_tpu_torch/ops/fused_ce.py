"""Fused LM-head + cross-entropy: the CUDA kernels of its forward and of its
logits gradient, their plain versions, and the routed ``fused_linear_ce``.

Counterpart of gpt2_vision_language_tpu/ops/fused_ce.py. The kernel in
``csrc/ce_fwd.cu`` (K4) replaces ``_ce_fwd_kernel`` (:93, launched by
``_ce_fwd_pallas`` :173): per-row NLL and logsumexp of x @ w.T with the
logits kept fp32 and never written to memory. ``ce_forward`` runs it for
CUDA tensors and its plain version, ``ce_forward_reference``, for CPU
tensors; each launch adds one to ``ce_forward.launches``. The kernel in
``csrc/ce_bwd.cu`` (K4b) replaces no TPU kernel (the JAX backward is XLA):
for one chunk of rows it forms the logits gradient p = (softmax - onehot) *
g in bf16 from fp32 logits that never reach memory. ``ce_backward`` runs it
for CUDA tensors and ``ce_backward_reference`` for CPU tensors; each launch
adds one to ``ce_backward.launches``.

``fused_linear_ce`` routes as the JAX function does (:409-428), with "on
TPU" read as "on CUDA" and without its no-autograd condition (the JAX
package kept XLA's forward under autograd because XLA shares that matmul
with the backward's recompute; eager PyTorch shares nothing):
``kernel_route`` sends a call on CUDA tensors under the bf16 compute
policy, with D and V multiples of 8, to both kernels, a train step's
included; everything else takes the chunked plain path of
``_make._fwd_impl`` (:291-329), whose logits round to the compute dtype.
The backward is ``_make._bwd``'s chunked recompute (:331-372): per chunk of
rows p, cast once to the compute dtype (by K4b or by its plain version, as
the forward went), then dx = p @ w and dw += p.T @ x as plain fp32-
accumulated products, as the JAX package leaves them to XLA. w comes in its
param dtype and is cast inside, so dw accumulates in that dtype (fp32 for
fp32 masters) and not per chunk in the compute dtype.
"""

from __future__ import annotations

import torch

from .. import _build
from ..core.precision import Policy, DEFAULT_POLICY
from ..obs.spans import span
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


def split_count(row_tiles: int, vocab_tiles: int, sms: int) -> int:
    """Vocab splits per row tile, for a kernel that holds one block per SM:
    the count whose grid ends first, reckoned as waves of blocks times the
    vocab tiles of a split plus one (a block's start and merge); the fewest
    splits among equals. 124M's vocab at N=8192 (64 row tiles of 128, 197
    tiles of 256) gives 2 splits, 128 blocks in one wave on 132 SMs; N=4096
    gives 4, 128 blocks."""
    best = None
    for want in range(1, vocab_tiles + 1):
        per = -(-vocab_tiles // want)
        splits = -(-vocab_tiles // per)  # no empty split
        cost = -(-row_tiles * splits // sms) * (per + 1)
        if best is None or cost < best[0]:
            best = (cost, splits)
    return best[1]


def _split_count(n: int, v: int, lib, device) -> int:
    return split_count(-(-n // lib.gpt2vl_ce_fwd_block_rows()),
                       -(-v // lib.gpt2vl_ce_fwd_tile_cols()),
                       torch.cuda.get_device_properties(device).multi_processor_count)


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


def ce_forward(x, w, targets):
    """Per-row (nll, lse) of x (N, D) @ w (V, D).T over the whole vocab, fp32.
    targets (N,) int32 in [0, V). CUDA tensors go to the kernel (bf16, D % 8
    == 0, contiguous) and anything it does not take raises; CPU tensors go to
    the plain version. Not differentiable: ``fused_linear_ce`` is."""
    if not (x.dim() == 2 and w.dim() == 2 and x.shape[1] == w.shape[1]
            and targets.shape == x.shape[:1]):
        raise ValueError(
            "ce_forward takes x (N, D), w (V, D), targets (N,), got "
            f"{tuple(x.shape)}, {tuple(w.shape)}, {tuple(targets.shape)}"
        )
    if not (x.device == w.device == targets.device):
        raise ValueError("ce_forward: x, w, targets on different devices")
    if x.is_cuda:
        return ce_forward_cuda(x, w, targets)
    if x.device.type == "cpu":
        return ce_forward_reference(x, w, targets)
    raise ValueError(f"ce_forward: no kernel for device {x.device}")


ce_forward.launches = 0


def ce_backward_reference(x, w, targets, lse, g, *,
                          logits_dtype: torch.dtype = torch.float32):
    """Plain version of K4b: the logits gradient (N, V) in x's dtype of one
    chunk of rows, p[n, v] = (exp(x[n] . w[v] - lse[n]) - [v == t[n]]) * g[n]
    in fp32, the logits accumulated in fp32 from x and w as given, cast once.
    targets must lie in [0, V). With a low-precision ``logits_dtype`` the
    logits are rounded to it before the exp: the JAX package's plain route
    (``_make._bwd``, :331-372)."""
    logits = matmul_f32(x, w.t()).to(logits_dtype)
    p32 = torch.exp(logits.float() - lse[:, None]) * g[:, None]
    rows = torch.arange(p32.shape[0], device=p32.device)
    p32[rows, targets.long()] -= g
    return p32.to(x.dtype)


def ce_backward_cuda(x, w, targets, lse, g):
    """Launch K4b: the logits gradient (N, V) bf16."""
    n, d = x.shape
    v = w.shape[0]
    if x.dtype != torch.bfloat16 or w.dtype != torch.bfloat16:
        raise ValueError(f"ce_backward kernel takes bf16 x and w, got {x.dtype}, {w.dtype}")
    if targets.dtype != torch.int32:
        raise ValueError(f"ce_backward kernel takes int32 targets, got {targets.dtype}")
    if lse.dtype != torch.float32 or g.dtype != torch.float32:
        raise ValueError(f"ce_backward kernel takes fp32 lse and g, got {lse.dtype}, {g.dtype}")
    if not all(a.is_contiguous() for a in (x, w, targets, lse, g)):
        raise ValueError("ce_backward kernel takes contiguous x, w, targets, lse and g")
    if d % 8 or v % 8:
        raise ValueError(f"ce_backward kernel needs D % 8 == 0 and V % 8 == 0, got D={d}, V={v}")
    if x.data_ptr() % 16 or w.data_ptr() % 16:
        raise ValueError("ce_backward kernel: x and w must be 16-byte aligned")
    lib = _build.load()
    p = torch.empty(n, v, dtype=torch.bfloat16, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.gpt2vl_ce_bwd(
            x.data_ptr(), w.data_ptr(), targets.data_ptr(), lse.data_ptr(), g.data_ptr(),
            p.data_ptr(), n, d, v, _split_count(n, v, lib, x.device), stream,
        )
    _build.check(err, "ce_bwd")
    ce_backward.launches += 1
    return p


def ce_backward(x, w, targets, lse, g):
    """The logits gradient (N, V) of sum(nll * g) for x (N, D), w (V, D),
    targets (N,) int32 in [0, V), the forward's lse (N,) and the cotangent g
    (N,), both fp32. CUDA tensors go to K4b (bf16, D and V multiples of 8,
    contiguous) and anything it does not take raises; CPU tensors go to the
    plain version with fp32 logits."""
    n = x.shape[0] if x.dim() == 2 else -1
    if not (x.dim() == 2 and w.dim() == 2 and x.shape[1] == w.shape[1]
            and targets.shape == lse.shape == g.shape == (n,)):
        raise ValueError(
            "ce_backward takes x (N, D), w (V, D), targets, lse, g (N,), got "
            f"{tuple(x.shape)}, {tuple(w.shape)}, {tuple(targets.shape)}, "
            f"{tuple(lse.shape)}, {tuple(g.shape)}"
        )
    if not (x.device == w.device == targets.device == lse.device == g.device):
        raise ValueError("ce_backward: x, w, targets, lse, g on different devices")
    if x.is_cuda:
        return ce_backward_cuda(x, w, targets, lse, g)
    if x.device.type == "cpu":
        return ce_backward_reference(x, w, targets, lse, g)
    raise ValueError(f"ce_backward: no kernel for device {x.device}")


ce_backward.launches = 0


def kernel_route(impl: str, x, w, policy: Policy) -> bool:
    """Whether ``fused_linear_ce`` takes the kernels (K4 forward, K4b
    backward; their plain versions on CPU tensors) or the chunked plain path.
    "auto": the kernels for x on CUDA under the bf16 compute policy with D
    and V multiples of 8, whether or not autograd records the call; "kernel"
    always; "xla" never. Reads only ``x.is_cuda`` and the shapes. Anything
    else raises."""
    if impl not in IMPLS:
        raise ValueError(
            f"fused_linear_ce: unknown impl {impl!r}; expected one of {IMPLS}"
        )
    if impl != "auto":
        return impl == "kernel"
    return (x.is_cuda and policy.compute_dtype == torch.bfloat16
            and x.shape[-1] % 8 == 0 and w.shape[0] % 8 == 0)


class _LinearCE(torch.autograd.Function):
    """nll of x @ w.T against targets; saves (x, w, targets, logz). Spans
    ``ce.fwd`` and ``ce.bwd`` (``obs/spans.py``), attr ``impl`` "kernel" or
    "plain"."""

    @staticmethod
    def forward(ctx, x, w, targets, n_chunks, policy, use_kernel):
        with span("ce.fwd", impl="kernel" if use_kernel else "plain"):
            cc = policy.cast_compute
            if use_kernel:
                nll, logz = ce_forward(cc(x).contiguous(), cc(w).contiguous(),
                                       targets.to(torch.int32).contiguous())
            else:
                nll, logz = ce_forward_reference(cc(x), cc(w), targets, n_chunks=n_chunks,
                                                 logits_dtype=policy.compute_dtype)
            ctx.n_chunks, ctx.policy, ctx.use_kernel = n_chunks, policy, use_kernel
            ctx.save_for_backward(x, w, targets, logz)
            return nll

    @staticmethod
    def backward(ctx, g):
        with span("ce.bwd", impl="kernel" if ctx.use_kernel else "plain"):
            x, w, targets, logz = ctx.saved_tensors
            policy = ctx.policy
            cc = policy.cast_compute
            wc = cc(w).contiguous()
            if ctx.use_kernel:
                targets = targets.to(torch.int32)
            # accumulated in the param dtype across chunks; a frozen head gets none
            dw = torch.zeros_like(w) if ctx.needs_input_grad[1] else None
            dx = []
            for xc, tc, gc, lzc in zip(x.chunk(ctx.n_chunks), targets.chunk(ctx.n_chunks),
                                       g.float().chunk(ctx.n_chunks),
                                       logz.chunk(ctx.n_chunks)):
                xcc = cc(xc).contiguous()
                if ctx.use_kernel:
                    p = ce_backward(xcc, wc, tc.contiguous(), lzc.contiguous(),
                                    gc.contiguous())
                else:
                    p = ce_backward_reference(xcc, wc, tc, lzc, gc,
                                              logits_dtype=policy.compute_dtype)
                dx.append(matmul_f32(p, wc).to(x.dtype))
                if dw is not None:
                    dw += matmul_f32(p.t(), xcc).to(dw.dtype)
            return torch.cat(dx), dw, None, None, None, None


def fused_linear_ce(x, w, targets, *, n_chunks: int = 8,
                    policy: Policy = DEFAULT_POLICY, impl: str = "auto"):
    """Per-position NLL (N,) fp32 of a tied LM head without the full logits.

    x: (N, D) final hiddens (already layer-normed). w: (V, D) unembedding
    (tied wte) in its param dtype. targets: (N,) class ids in [0, V); the
    ignore index -100 must be clipped by the caller, who masks those rows.
    Differentiable in x and w through the chunked recompute backward;
    ``n_chunks`` is its number of chunks of rows (and the plain forward's).

    impl: "auto" takes the kernels (K4 over all rows, K4b a chunk) on CUDA
    tensors under the bf16 compute policy with D and V multiples of 8, with
    or without autograd, and the chunked plain path otherwise; "kernel"
    forces both kernels (their plain versions on CPU tensors); "xla" forces
    the chunked plain path (``kernel_route``). Anything else raises.
    """
    use_kernel = kernel_route(impl, x, w, policy)
    return _LinearCE.apply(x, w, targets, int(n_chunks), policy, use_kernel)
