"""The benchmark's plain reference: float32 PyTorch with TF32 off.

It imports nothing of the program (`repro_torch`) and nothing of the JAX
package. It takes the parameter tree and the inputs the benchmark made
(weights.py, traffic.py) and works everything else out itself: logits,
losses, gradients, the AdamW trajectory, and what the attached eBPF
programs must leave in their maps.

Each model module (`qwen2.py`, `mamba2.py`) gives
    forward(params, tokens, m, pr=lowp.FLOAT32) -> float32 logits
                                                   [B, S, Vpad]
where `m` is the configuration file's "model" section and `pr` the
arithmetic (`lowp.PRECISIONS`: "float32", or "float8" for the
lower-precision control), and
    loss(params, tokens, labels, m, pr=lowp.FLOAT32) -> mean next-token
                                                         loss
with its activations recomputed layer by layer in the backward pass.
It also gives
    block_leaves(m, j) -> [(path, shape, kind, scale)]
the leaves of superblock position j after its first norm, each with a
row a superblock (weights.py draws them), and CHECK_BATCH, the sequences
the serving check runs through `forward` at once (0: all).
"""
from __future__ import annotations

import contextlib
import importlib

import torch


@contextlib.contextmanager
def exact_float32():
    """TF32 off for float32 products and convolutions while the block runs
    (restored after)."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def model(name: str):
    """The reference module named by a configuration's "reference" key."""
    return importlib.import_module(f"{__name__}.{name}")
