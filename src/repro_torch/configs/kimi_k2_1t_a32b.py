"""kimi-k2-1t-a32b [arXiv:2501.kimi2; unverified] — trillion-param MoE:
384 experts, top-8, expert d_ff=2048. All layers MoE (the assigned table's
per-layer pattern; the release's single dense first layer is noted in
DESIGN.md §Arch-applicability)."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="kimi-k2-1t-a32b", family="moe",
    num_layers=61, d_model=7168, num_heads=64, num_kv_heads=8,
    d_ff=2048, vocab_size=163840, head_dim=112,
    rope_theta=50_000.0,
    num_experts=384, experts_per_token=8, moe_d_ff=2048,
    moe_every=1, moe_offset=0, superblock=1,
    dtype="bfloat16",
)
