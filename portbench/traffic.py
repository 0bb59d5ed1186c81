"""The generic traffic generators: one per mode, each reading a mix's
parameters from `traffic/<mix>.json`.

Serving: requests in blocks of `block`. Every block holds the same
prompt and output lengths, the lognormal quantiles at (i + 0.5) / block,
clipped to [min, max], paired and ordered by a schedule that is the same
for every seed (drawn once from `schedule_seed`); the seed draws the
tokens. So every seed offers the same work in the same order, and runs
of different seeds differ only in the weights and the tokens. A
configuration's `program_limits.prefill_multiple_above` cuts longer
prompts down to a multiple of it.

Training: sequences of seq_len + 1 uniform random tokens per step, drawn
on the device from (seed, step); tokens are all but the last, labels all
but the first.
"""
from __future__ import annotations

import math
from statistics import NormalDist

import numpy as np
import torch


def quantile_sizes(spec: dict, n: int) -> list[int]:
    """The `n` lognormal quantiles of `spec` {median, sigma, min, max}."""
    if spec.get("dist", "lognormal") != "lognormal":
        raise ValueError(f"unknown length distribution {spec['dist']!r}")
    nd = NormalDist()
    out = []
    for i in range(n):
        v = spec["median"] * math.exp(spec["sigma"] * nd.inv_cdf((i + .5) / n))
        out.append(int(min(max(round(v), spec["min"]), spec["max"])))
    return out


def prompt_cut(length: int, config: dict) -> int:
    mult = config.get("program_limits", {}).get("prefill_multiple_above")
    if mult and length > mult:
        return length // mult * mult
    return length


def serve_requests(traffic: dict, config: dict, seed: int) -> list[dict]:
    """[{"rid", "prompt": [int], "max_new"}] of the whole pool."""
    block, pool = traffic["block"], traffic["pool"]
    if pool % block:
        raise ValueError("the pool must hold whole blocks")
    vocab = config["model"]["vocab_size"]
    plen = [prompt_cut(x, config)
            for x in quantile_sizes(traffic["prompt_tokens"], block)]
    olen = quantile_sizes(traffic["output_tokens"], block)
    sched = np.random.default_rng(traffic["schedule_seed"])
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(pool // block):
        for i, j in zip(sched.permutation(block), sched.permutation(block)):
            out.append({"rid": len(out),
                        "prompt": rng.integers(0, vocab, plen[i]).tolist(),
                        "max_new": olen[j]})
    return out


def step_seed(seed: int, step: int) -> int:
    return (seed * 2_654_435_761 + step * 40_503 + 17) % (1 << 63)


def train_batch(traffic: dict, config: dict, seed: int, step: int,
                device) -> dict:
    """Step `step`'s batch: {"tokens", "labels"} int64 on `device`, shaped
    [microbatches, micro, seq] when the configuration accumulates
    microbatches, else [batch, seq]."""
    B, S = traffic["batch"], traffic["seq_len"]
    gen = torch.Generator(device=device)
    gen.manual_seed(step_seed(seed, step))
    seq = torch.randint(0, config["model"]["vocab_size"], (B, S + 1),
                        generator=gen, device=device)
    toks, labels = seq[:, :-1], seq[:, 1:]
    micro = config["train"].get("microbatch", 0)
    if micro:
        toks = toks.reshape(B // micro, micro, S)
        labels = labels.reshape(B // micro, micro, S)
    return {"tokens": toks.contiguous(), "labels": labels.contiguous()}


def as_microbatches(batch: dict):
    """(tokens, labels) shaped [microbatches, micro, seq]."""
    t, lab = batch["tokens"], batch["labels"]
    if t.dim() == 2:
        t, lab = t[None], lab[None]
    return t, lab
