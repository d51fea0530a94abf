from .config import (
    GPTConfig, GPT2_124M, GPT2_350M, GPT2_774M, GPT2_1558M,
    ScheduleConfig, OptimizerConfig, PretrainConfig,
)
from .precision import Policy, DEFAULT_POLICY, FP32_POLICY

__all__ = [
    "GPTConfig", "GPT2_124M", "GPT2_350M", "GPT2_774M", "GPT2_1558M",
    "ScheduleConfig", "OptimizerConfig", "PretrainConfig",
    "Policy", "DEFAULT_POLICY", "FP32_POLICY",
]
