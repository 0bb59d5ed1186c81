"""Per-architecture production training presets: microbatching, optimizer
choice (Adafactor for >=50B — two fp32 Adam moments on 1T params cannot fit
a 4TB pod, see EXPERIMENTS.md memory table), and param dtype.

A copy of `src/repro/launch/presets.py` with no change in logic; it builds
this package's `TrainConfig`."""
from __future__ import annotations

from ..configs.base import TrainConfig

# arch id -> (micro_bs for train_4k, optimizer, param_dtype)
_PRESETS = {
    "qwen2-0.5b":            (0,  "adamw",     "float32"),
    "phi4-mini-3.8b":        (64, "adamw",     "float32"),
    "llama3.2-1b":           (0,  "adamw",     "float32"),
    "starcoder2-15b":        (32, "adamw",     "bfloat16"),
    "qwen2-vl-72b":          (16, "adafactor", "bfloat16"),
    "seamless-m4t-medium":   (0,  "adamw",     "float32"),
    "mamba2-780m":           (0,  "adamw",     "float32"),
    "llama4-scout-17b-a16e": (16, "adafactor", "bfloat16"),
    "kimi-k2-1t-a32b":       (16, "adafactor", "bfloat16"),
    "jamba-v0.1-52b":        (32, "adafactor", "bfloat16"),
}


def train_config(arch: str, **overrides) -> TrainConfig:
    import os
    micro, opt, pdt = _PRESETS[arch]
    if os.environ.get("REPRO_MICRO"):        # §Perf sweep override
        micro = int(os.environ["REPRO_MICRO"])
    kw = dict(microbatch=micro, optimizer=opt, param_dtype=pdt, remat=True)
    kw.update(overrides)
    return TrainConfig(**kw)
