"""Precision policy in torch dtypes.

Counterpart of gpt2_vision_language_tpu/core/precision.py: parameters stay
fp32, matmuls take bf16 operands and accumulate in fp32, and layernorm,
softmax and the loss run in fp32. ``FP32_POLICY`` is the parity pin.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class Policy:
    param_dtype: torch.dtype = torch.float32
    compute_dtype: torch.dtype = torch.bfloat16
    accum_dtype: torch.dtype = torch.float32

    def cast_compute(self, x: torch.Tensor) -> torch.Tensor:
        return x.to(self.compute_dtype)


DEFAULT_POLICY = Policy()
FP32_POLICY = Policy(compute_dtype=torch.float32)
