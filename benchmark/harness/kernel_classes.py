"""Kernel-name fragments -> class, first match wins.

A copy of ``cli/profile_step.py``'s ``HAND_WRITTEN_CLASSES`` and ``CLASSES``,
with the fp32 and merge kernels that table leaves to "other" named too, so
that no hand-written kernel is ever counted as library glue.
"""

from __future__ import annotations

HAND_WRITTEN_CLASSES = (
    ("flash_lse_merge", "lse flash merge"),
    ("flash_lse_fwd", "lse flash forward"),
    ("flash_fused_bwd", "one-pass flash backward"),
    ("flash_fused_dq_cast", "one-pass flash backward dq cast"),
    ("flash_general_fwd", "general flash forward"),
    ("flash_general_bwd_f32", "general flash backward fp32"),
    ("flash_general_dq", "general flash dq"),
    ("flash_general_dkv", "general flash dk/dv"),
    ("rowdot", "flash D pre-kernel"),
    ("flash_dt_merge", "dt flash merge"),
    ("flash_dt_fwd", "dt flash forward"),
    ("flash_dt_bwd", "dt flash backward"),
    ("flash_fwd", "self-attention flash forward"),
    ("flash_bwd", "self-attention flash backward"),
    ("adamw_kernel", "AdamW kernel"),
    ("ce_fwd", "CE forward kernel"),
)
CLASSES = HAND_WRITTEN_CLASSES + (
    ("nvjet", "GEMM"), ("gemm", "GEMM"), ("cutlass", "GEMM"), ("cublas", "GEMM"),
    ("reduce", "reduction"),
    ("elementwise", "elementwise"), ("vectorized", "elementwise"),
    ("Memcpy", "memcpy/memset"), ("Memset", "memcpy/memset"),
)
GLUE = ("elementwise", "reduction", "memcpy/memset")


def classify(name: str) -> str:
    return next((cls for frag, cls in CLASSES if frag in name), "other")


def by_class(by_name: dict) -> dict:
    """{class: device time} from {kernel name: device time}."""
    out = {}
    for name, t in by_name.items():
        cls = classify(name)
        out[cls] = out.get(cls, 0.0) + t
    return out
