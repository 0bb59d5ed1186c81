"""phi4-mini-3.8b [arXiv:2412.08905; hf] — RoPE, SwiGLU, GQA (kv=8)."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="phi4-mini-3.8b", family="dense",
    num_layers=32, d_model=3072, num_heads=24, num_kv_heads=8,
    d_ff=8192, vocab_size=200064,
    rope_theta=10_000.0, tie_embeddings=True,
)
