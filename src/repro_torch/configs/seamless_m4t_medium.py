"""seamless-m4t-medium [arXiv:2308.11596; hf] — enc-dec multimodal backbone
(audio frontend STUB: frame embeddings via input_specs). MHA (kv=16)."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-medium", family="encdec",
    num_layers=0, enc_layers=12, dec_layers=12,
    d_model=1024, num_heads=16, num_kv_heads=16,
    d_ff=4096, vocab_size=256206,
    frontend="audio", frontend_tokens=0,
)
