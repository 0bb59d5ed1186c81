"""Device selection for the port's entry points.

Every entry point takes `device`, defaulting to "cuda". Asking for CUDA on
a machine without it raises: the port never moves to the CPU on its own.
"""
from __future__ import annotations

import torch


TRACING = False         # set by launch/op_cost.analyze while it counts


def tracing() -> bool:
    """True while a step runs on fake tensors to be exported or counted
    (`torch.export`, `launch/op_cost.analyze`): the kernels are reached
    through their custom operators, and module caches keep nothing."""
    return TRACING or torch.compiler.is_exporting()


def resolve(device="cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU")
    return dev
