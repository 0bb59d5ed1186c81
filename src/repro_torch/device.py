"""Device selection for the port's entry points.

Every entry point takes `device`, defaulting to "cuda". Asking for CUDA on
a machine without it raises: the port never moves to the CPU on its own.
"""
from __future__ import annotations

import torch


def resolve(device="cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU")
    return dev
