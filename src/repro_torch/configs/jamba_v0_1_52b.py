"""jamba-v0.1-52b [arXiv:2403.19887; hf] — hybrid Mamba+attention 1:7
interleave (attention at layer offset 4 of each 8), MoE 16e top-2 every
other layer. Attention layers carry no RoPE (positions via SSM)."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="jamba-v0.1-52b", family="hybrid",
    num_layers=32, d_model=4096, num_heads=32, num_kv_heads=8,
    d_ff=14336, vocab_size=65536, head_dim=128,
    rope_kind="none",
    num_experts=16, experts_per_token=2, moe_d_ff=14336,
    moe_every=2, moe_offset=1,
    attn_every=8, attn_offset=4, superblock=8,
    ssm_state=16, ssm_expand=2, ssm_headdim=64, ssm_ngroups=1, ssm_chunk=256,
)
