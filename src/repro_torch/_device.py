"""Device resolution for the port's entry points.

Entry points that make tensors default to ``device="cuda"``; without a
card they raise rather than quietly run on the CPU. Tests and other CPU
callers pass ``device="cpu"`` explicitly.
"""

from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch path on the CPU"
        )
    return dev
