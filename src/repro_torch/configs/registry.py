"""--arch <id> registry: maps the assigned architecture ids to configs,
plus reduced same-family smoke configs (small layers/width/experts/vocab)."""
from __future__ import annotations

import dataclasses

from .base import ModelConfig
from . import (granite_4_0_h_small, jamba_v0_1_52b, kimi_k2_1t_a32b,
               llama3_2_1b, llama4_scout_17b_a16e, mamba2_780m,
               phi4_mini_3_8b, qwen2_0_5b, qwen2_vl_72b,
               seamless_m4t_medium, starcoder2_15b)

ARCHS: dict[str, ModelConfig] = {
    "qwen2-0.5b": qwen2_0_5b.CONFIG,
    "phi4-mini-3.8b": phi4_mini_3_8b.CONFIG,
    "llama3.2-1b": llama3_2_1b.CONFIG,
    "starcoder2-15b": starcoder2_15b.CONFIG,
    "qwen2-vl-72b": qwen2_vl_72b.CONFIG,
    "seamless-m4t-medium": seamless_m4t_medium.CONFIG,
    "mamba2-780m": mamba2_780m.CONFIG,
    "llama4-scout-17b-a16e": llama4_scout_17b_a16e.CONFIG,
    "kimi-k2-1t-a32b": kimi_k2_1t_a32b.CONFIG,
    "jamba-v0.1-52b": jamba_v0_1_52b.CONFIG,
}
# presets of the port alone: the JAX package has no counterpart, so the
# tests that hold every arch of ARCHS against it leave these out
PORT_ARCHS: dict[str, ModelConfig] = {
    "granite-4.0-h-small": granite_4_0_h_small.CONFIG,
}


def get(arch: str) -> ModelConfig:
    cfg = ARCHS.get(arch) or PORT_ARCHS.get(arch)
    if cfg is None:
        raise KeyError(f"unknown arch {arch!r}; known: "
                       f"{sorted({**ARCHS, **PORT_ARCHS})}")
    return cfg


def smoke(arch: str) -> ModelConfig:
    """Reduced config of the same family: tiny widths, few layers/experts,
    small vocab — runs a forward/train step on CPU in seconds."""
    cfg = get(arch)
    r = dict(
        d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
        d_ff=128, vocab_size=256, dtype="float32",
        frontend_tokens=8 if cfg.frontend != "none" else 0,
        ssm_state=16, ssm_headdim=16, ssm_chunk=2,
    )
    if cfg.family == "ssm":
        r.update(num_heads=0, num_kv_heads=0, head_dim=0, d_ff=0)
    if cfg.rope_kind == "mrope":
        r.update(mrope_sections=(2, 3, 3))   # sums to smoke hd/2
    if cfg.num_experts:
        r.update(num_experts=4,
                 experts_per_token=min(2, cfg.experts_per_token),
                 moe_d_ff=128, moe_shared_d_ff=min(cfg.moe_shared_d_ff, 256))
    if cfg.family == "encdec":
        r.update(enc_layers=2, dec_layers=2, num_layers=0, num_kv_heads=4)
    else:
        r.update(num_layers=2 * cfg.superblock)
    return dataclasses.replace(cfg, **r)
