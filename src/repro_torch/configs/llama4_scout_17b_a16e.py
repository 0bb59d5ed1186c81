"""llama4-scout-17b-a16e [hf:meta-llama/Llama-4-Scout-17B-16E; unverified]
— MoE 16 routed experts top-1 + 1 shared expert, every layer (Scout's
interleave_moe_layer_step=1), early fusion."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="llama4-scout-17b-a16e", family="moe",
    num_layers=48, d_model=5120, num_heads=40, num_kv_heads=8,
    d_ff=8192, vocab_size=202048, head_dim=128,
    rope_theta=500_000.0,
    num_experts=16, experts_per_token=1, moe_d_ff=8192, moe_shared=True,
    moe_every=1, moe_offset=0, superblock=1,
)
