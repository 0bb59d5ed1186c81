"""mamba2-780m [arXiv:2405.21060; unverified] — SSD (state-space duality),
attention-free. d_inner = 2*1536 = 3072, 48 heads of dim 64, N=128."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-780m", family="ssm",
    num_layers=48, d_model=1536, num_heads=0, num_kv_heads=0,
    d_ff=0, vocab_size=50280, rope_kind="none",
    ssm_state=128, ssm_expand=2, ssm_headdim=64, ssm_ngroups=1,
    ssm_chunk=256, tie_embeddings=True,
)
