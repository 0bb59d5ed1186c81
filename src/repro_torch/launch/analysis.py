"""Three-term roofline of a counted step on the NVIDIA H100 SXM, and the
model's useful flops.

The twin of `src/repro/launch/analysis.py` with the H100's peaks in place
of the TPU v5e's, the same as the bound column of PERF.md's kernel table.
`roofline_from_cost` reads `launch/op_cost.OpCost` (ATen operations
counted on fake tensors) where JAX's `roofline_from_hlo` reads the
optimised HLO. JAX's `parse_collectives` (HLO text) has no counterpart:
`op_cost` counts the collectives.

Wire-byte model per collective (result bytes):
    all-reduce        2x result bytes   (ring: reduce-scatter + all-gather)
    all-gather        1x result bytes   (each device receives ~result)
    reduce-scatter    1x result bytes
    all-to-all        1x result bytes
    collective-permute 1x result bytes
    broadcast         1x result bytes
"""
from __future__ import annotations

from dataclasses import dataclass

# ---- NVIDIA H100 SXM (nvidia-smi: "NVIDIA H100 80GB HBM3, 700.00 W")
CARD = "NVIDIA H100 80GB HBM3, 700.00 W"
PEAK_FLOPS = 989e12          # bf16 dense FLOP/s per card
HBM_BW = 3.35e12             # B/s per card
NVLINK_BW = 450e9            # B/s per card, each direction

_WIRE_FACTOR = {"all-reduce": 2.0, "all-gather": 1.0, "reduce-scatter": 1.0,
                "all-to-all": 1.0, "collective-permute": 1.0,
                "broadcast": 1.0}


@dataclass
class Roofline:
    compute_s: float
    memory_s: float
    collective_s: float
    hlo_flops_per_dev: float
    hlo_bytes_per_dev: float
    coll_bytes_per_dev: float
    model_flops_total: float
    chips: int

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def bound_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def useful_flops_ratio(self) -> float:
        tot = self.hlo_flops_per_dev * self.chips
        return self.model_flops_total / tot if tot else 0.0

    @property
    def roofline_fraction(self) -> float:
        """fraction of card peak the step would achieve if it ran exactly
        at the dominant-term time, counting only MODEL flops as useful."""
        if self.bound_s <= 0:
            return 0.0
        ideal = self.model_flops_total / (self.chips * PEAK_FLOPS)
        return ideal / self.bound_s

    def to_dict(self) -> dict:
        return {
            "compute_s": self.compute_s, "memory_s": self.memory_s,
            "collective_s": self.collective_s, "dominant": self.dominant,
            "hlo_flops_per_dev": self.hlo_flops_per_dev,
            "hlo_bytes_per_dev": self.hlo_bytes_per_dev,
            "coll_bytes_per_dev": self.coll_bytes_per_dev,
            "model_flops_total": self.model_flops_total,
            "useful_flops_ratio": self.useful_flops_ratio,
            "roofline_fraction": self.roofline_fraction,
            "chips": self.chips,
        }


def roofline_from_cost(cost, chips: int, model_flops_total: float,
                       fused_attention: bool = True) -> Roofline:
    """Roofline from `op_cost.OpCost`, whose counts are for the whole step
    (global shapes, traced once): each per-device term divides them by
    `chips`, assuming even sharding. fused_attention=True leaves out the
    score-matrix bytes the flash kernels keep on chip
    (kernels/flash_attention.py); False adds them, as unfused attention
    would move them."""
    n = max(int(chips), 1)
    byts = (cost.bytes_fused if fused_attention else cost.bytes) / n
    flops = cost.flops / n
    wire = cost.coll_wire / n
    return Roofline(
        compute_s=flops / PEAK_FLOPS,
        memory_s=byts / HBM_BW,
        collective_s=wire / NVLINK_BW,
        hlo_flops_per_dev=flops,
        hlo_bytes_per_dev=byts,
        coll_bytes_per_dev=wire,
        model_flops_total=model_flops_total,
        chips=chips,
    )


def model_flops(cfg, shape) -> float:
    """Useful step flops: 6*N*D train / 2*N*D inference (N = active params,
    embedding lookup table excluded per the Chinchilla convention) PLUS the
    causal-attention quadratic term (2*B*S^2*H*hd fwd; x3 train for bwd) —
    without it, attention-heavy cells (small d_model, long S) would show
    absurd "waste"."""
    pc = cfg.param_counts()
    n = pc["active"] - cfg.vocab_size * cfg.d_model
    B, S = shape.global_batch, shape.seq_len
    n_attn = sum(1 for i in range(cfg.num_layers or
                                  (cfg.enc_layers + cfg.dec_layers))
                 if cfg.block_kind(i) == "attn")
    attn_fwd = 2.0 * B * S * S * cfg.num_heads * cfg.hd * n_attn
    if shape.mode == "train":
        return 6.0 * n * B * S + 3.0 * attn_fwd
    if shape.mode == "prefill":
        return 2.0 * n * B * S + attn_fwd
    # decode: one token attends the full cache (linear, not quadratic)
    attn_dec = 4.0 * B * S * cfg.num_heads * cfg.hd * n_attn
    return 2.0 * n * B + attn_dec
