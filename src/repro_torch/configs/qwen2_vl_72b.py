"""qwen2-vl-72b [arXiv:2409.12191; hf] — M-RoPE, dynamic-resolution vision
frontend (STUB: patch embeddings provided via input_specs)."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-72b", family="vlm",
    num_layers=80, d_model=8192, num_heads=64, num_kv_heads=8,
    d_ff=29568, vocab_size=152064,
    qkv_bias=True, rope_theta=1_000_000.0,
    rope_kind="mrope", mrope_sections=(16, 24, 24),
    frontend="vision", frontend_tokens=1024,
)
