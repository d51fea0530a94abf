"""Published peaks of the cards the benchmark runs on.

NVIDIA H100 SXM (80 GB HBM3), dense rates without sparsity, at the full
700 W power limit (NVIDIA's data sheet): 989 TFLOP/s bf16 and fp16, 495
TF32, 67 fp32 outside the tensor cores, 1,979 fp8, and 3.35 TB/s of HBM.
A card set below 700 W reaches less; the run prints its power limit.
"""

from __future__ import annotations

CARDS = {
    "NVIDIA H100 80GB HBM3": {
        "flops": {"bf16": 989e12, "fp16": 989e12, "tf32": 495e12, "fp32": 67e12,
                  "fp8": 1979e12},
        "bytes_per_s": 3.35e12,
    },
}


def for_device(name: str):
    """The peaks of the card named ``name`` (torch.cuda.get_device_name), or
    None for a card the table does not hold."""
    return CARDS.get(name)
