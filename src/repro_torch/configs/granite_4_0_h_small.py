"""granite-4.0-h-small [hf:ibm-granite/granite-4.0-h-small config.json;
granitemoehybrid] -- 40 layers, Mamba-2 mixers with a NoPE GQA layer at
offset 5 of each 10; every layer a dropless top-10 of 72 experts (width
768, the config's intermediate_size) beside a shared SwiGLU expert of
1536; embedding x12, each sublayer's output x0.22, softmax scale 1/128,
logits /16. The JAX package has no such preset."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="granite-4.0-h-small", family="hybrid",
    num_layers=40, d_model=4096, num_heads=32, num_kv_heads=8,
    d_ff=0, vocab_size=100352, head_dim=128, norm_eps=1e-5,
    rope_kind="none", tie_embeddings=True,
    num_experts=72, experts_per_token=10, moe_d_ff=768, moe_shared=True,
    moe_shared_d_ff=1536, moe_every=1, moe_offset=0, moe_dropless=True,
    attn_every=10, attn_offset=5, superblock=10,
    ssm_state=128, ssm_expand=2, ssm_headdim=64, ssm_ngroups=1,
    ssm_chunk=256, ssm_conv=4,
    embedding_multiplier=12.0, residual_multiplier=0.22,
    attention_multiplier=0.0078125, logits_scaling=16.0,
)
