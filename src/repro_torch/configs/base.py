"""Config schema: model / shape / mesh / train / serve.

Every assigned architecture instantiates ModelConfig exactly once in its own
file under configs/, and is selectable via --arch <id> through
configs.registry.
"""
from __future__ import annotations

from dataclasses import dataclass, field, replace


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                 # dense | moe | ssm | hybrid | encdec | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0           # 0 -> d_model // num_heads
    qkv_bias: bool = False
    norm: str = "rmsnorm"       # rmsnorm | layernorm
    norm_eps: float = 1e-5
    rope_theta: float = 10_000.0
    rope_kind: str = "rope"     # rope | mrope | none
    mrope_sections: tuple[int, int, int] = (16, 24, 24)
    tie_embeddings: bool = False
    act: str = "swiglu"         # swiglu | gelu
    # ---- MoE
    num_experts: int = 0
    experts_per_token: int = 0
    moe_d_ff: int = 0           # expert hidden dim (d_ff used for dense ffn)
    moe_every: int = 1          # layer i uses MoE iff i % moe_every == moe_offset
    moe_offset: int = 0
    moe_shared: bool = False    # always-on shared expert alongside routed
    moe_shared_d_ff: int = 0    # shared expert hidden dim (0 -> moe_d_ff)
    capacity_factor: float = 1.25
    moe_dropless: bool = False  # capacity = tokens: no assignment drops
    # ---- SSM (mamba2 / SSD)
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_headdim: int = 64
    ssm_ngroups: int = 1
    ssm_chunk: int = 256
    ssm_conv: int = 4
    # ---- hybrid (jamba): attention layer every `attn_every`, at offset
    attn_every: int = 0         # 0 -> all attention (or all ssm if family=ssm)
    attn_offset: int = 4
    # ---- enc-dec
    enc_layers: int = 0
    dec_layers: int = 0
    # ---- modality frontend stub (vlm/audio): inputs arrive as embeddings
    frontend: str = "none"      # none | vision | audio
    frontend_tokens: int = 0    # prefix positions fed as embeddings
    # ---- scalars on the residual and attention paths (granite): 1 (0 for
    # the attention scale) changes nothing
    embedding_multiplier: float = 1.0   # the embedding's output, times
    residual_multiplier: float = 1.0    # each sublayer's output, times
    attention_multiplier: float = 0.0   # softmax scale (0 -> 1/sqrt(hd))
    logits_scaling: float = 1.0         # the logits, divided by
    # ---- numerics
    dtype: str = "bfloat16"
    # superblock: scan unit = this many consecutive layers (hetero patterns)
    superblock: int = 1

    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // max(self.num_heads, 1))

    @property
    def padded_vocab(self) -> int:
        """vocab padded to 256 for clean TP sharding (loss masks padding)."""
        return -(-self.vocab_size // 256) * 256

    def block_kind(self, i: int) -> str:
        """'attn' or 'mamba' for layer i."""
        if self.family == "ssm":
            return "mamba"
        if self.family == "hybrid" and self.attn_every:
            return "attn" if i % self.attn_every == self.attn_offset else "mamba"
        return "attn"

    def ffn_kind(self, i: int) -> str:
        """'moe' | 'dense' | 'none' for layer i."""
        if self.family == "ssm":
            return "none"
        if self.num_experts and i % self.moe_every == self.moe_offset:
            return "moe"
        return "dense"

    @property
    def shared_d_ff(self) -> int:
        return self.moe_shared_d_ff or self.moe_d_ff

    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    def ssm_heads(self) -> int:
        return self.d_inner() // self.ssm_headdim

    # ---------------- parameter counting (for roofline MODEL_FLOPS)
    def param_counts(self) -> dict:
        D, V = self.d_model, self.vocab_size
        hd, H, KH = self.hd, self.num_heads, self.num_kv_heads
        attn = D * H * hd + 2 * D * KH * hd + H * hd * D
        if self.qkv_bias:
            attn += (H + 2 * KH) * hd
        dense_ffn = 3 * D * self.d_ff if self.act == "swiglu" else 2 * D * self.d_ff
        shared = 3 * D * self.shared_d_ff if self.moe_shared else 0
        moe_ffn = (self.num_experts * 3 * D * self.moe_d_ff
                   + D * self.num_experts + shared)
        act_moe_ffn = (self.experts_per_token * 3 * D * self.moe_d_ff
                       + D * self.num_experts + shared)
        di, N = self.d_inner(), self.ssm_state
        nh, G = self.ssm_heads(), self.ssm_ngroups
        mamba = (D * (2 * di + 2 * G * N + nh)       # in_proj
                 + self.ssm_conv * (di + 2 * G * N)  # depthwise conv
                 + nh * 3                            # A_log, D, dt_bias
                 + di * D)                           # out_proj
        total = acttotal = V * D * (1 if self.tie_embeddings else 2)
        n_layers = self.num_layers or (self.enc_layers + self.dec_layers)
        for i in range(n_layers):
            blk = mamba if self.block_kind(i) == "mamba" else attn
            ffn = {"dense": dense_ffn, "moe": moe_ffn, "none": 0}[self.ffn_kind(i)]
            affn = {"dense": dense_ffn, "moe": act_moe_ffn, "none": 0}[self.ffn_kind(i)]
            total += blk + ffn + 2 * D
            acttotal += blk + affn + 2 * D
        if self.family == "encdec":  # cross-attention in decoder
            total += self.dec_layers * (attn + D)
            acttotal += self.dec_layers * (attn + D)
        return {"total": total, "active": acttotal}


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    mode: str                   # train | prefill | decode


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}

# long_500k needs sub-quadratic sequence mixing: only SSM/hybrid archs run it
SUBQUADRATIC_FAMILIES = ("ssm", "hybrid")


def shape_applicable(cfg: ModelConfig, shape: ShapeConfig) -> tuple[bool, str]:
    if shape.name == "long_500k" and cfg.family not in SUBQUADRATIC_FAMILIES:
        return False, "long_500k skipped: full-attention arch (see DESIGN.md)"
    return True, ""


@dataclass(frozen=True)
class TrainConfig:
    microbatch: int = 0          # 0 -> no grad accumulation
    remat: bool = True
    optimizer: str = "adamw"     # adamw | adafactor
    lr: float = 3e-4
    warmup: int = 100
    total_steps: int = 10_000
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    grad_compression: str = "none"   # none | int8
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"


@dataclass(frozen=True)
class MeshConfig:
    shape: tuple[int, ...] = (16, 16)
    axes: tuple[str, ...] = ("data", "model")

    @property
    def multi_pod(self) -> bool:
        return "pod" in self.axes


def scaled(cfg: ModelConfig, **overrides) -> ModelConfig:
    """Reduced-config variant of the same family (smoke tests)."""
    return replace(cfg, **overrides)
