"""qwen2-0.5b [arXiv:2407.10671; hf] — GQA (kv=2), QKV bias, tied embeddings."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-0.5b", family="dense",
    num_layers=24, d_model=896, num_heads=14, num_kv_heads=2,
    d_ff=4864, vocab_size=151936, head_dim=64,
    qkv_bias=True, rope_theta=1_000_000.0, tie_embeddings=True,
)
