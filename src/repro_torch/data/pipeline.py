"""Deterministic synthetic data pipeline.

Production-shaped: seeded and shardable (each data shard derives its rows
from (seed, step, global row index) — no coordination needed), checkpointable
(the cursor IS the step), and instrumented: every batch fetch goes through
the sys_data_fetch framework syscall, so eBPF filter programs can skip or
veto batches (the opensnoop/filter analogue for the input path).
"""
from __future__ import annotations

import numpy as np

from ..configs.base import ModelConfig, ShapeConfig, TrainConfig


def _philox_like(seed: int, step: int, rows: int, cols: int,
                 vocab: int) -> np.ndarray:
    """Cheap counter-based deterministic token generator (splitmix-based)."""
    with np.errstate(over="ignore"):
        idx = (np.arange(rows, dtype=np.uint64)[:, None]
               * np.uint64(1 << 32)
               + np.arange(cols, dtype=np.uint64)[None, :])
        x = (idx + np.uint64(seed) * np.uint64(0x9E3779B97F4A7C15)
             + np.uint64(step) * np.uint64(0xBF58476D1CE4E5B9))
        x ^= x >> np.uint64(30)
        x *= np.uint64(0xBF58476D1CE4E5B9)
        x ^= x >> np.uint64(27)
        x *= np.uint64(0x94D049BB133111EB)
        x ^= x >> np.uint64(31)
        return (x % np.uint64(vocab)).astype(np.int32)


def _lm_sequences(seed: int, step: int, rows: int, cols: int,
                  vocab: int) -> np.ndarray:
    """LEARNABLE sequences: per-row random start, then the deterministic
    successor t[i+1] = (a*t[i] + c) % vocab — a 1-gram function a model
    learns in a few steps (used so train-loop tests can assert loss drops;
    the token distribution stays uniform)."""
    start = _philox_like(seed, step, rows, 1, vocab)[:, 0].astype(np.int64)
    a, c = 5, 7
    out = np.empty((rows, cols), np.int64)
    out[:, 0] = start
    for i in range(1, cols):
        out[:, i] = (a * out[:, i - 1] + c) % vocab
    return out.astype(np.int32)


class SyntheticDataset:
    def __init__(self, cfg: ModelConfig, shape: ShapeConfig,
                 tcfg: TrainConfig, seed: int = 0, runtime=None,
                 fault_retries: int = 3):
        self.cfg, self.shape, self.tcfg = cfg, shape, tcfg
        self.seed = seed
        self.runtime = runtime
        self.fault_retries = fault_retries
        self.step = 0           # checkpointable cursor

    def state(self) -> dict:
        return {"seed": self.seed, "step": self.step}

    def restore(self, st: dict):
        self.seed, self.step = st["seed"], st["step"]

    def _make(self, step: int) -> dict:
        cfg, shape = self.cfg, self.shape
        B, S = shape.global_batch, shape.seq_len
        Ft = cfg.frontend_tokens
        rng = np.random.default_rng(self.seed * 1_000_003 + step)
        batch = {}
        if cfg.family == "encdec":
            batch["enc_embeds"] = rng.standard_normal(
                (B, S, cfg.d_model), dtype=np.float32) * 0.02
            batch["tokens"] = _philox_like(self.seed, step, B, S,
                                           cfg.vocab_size)
            batch["labels"] = _philox_like(self.seed, step + 1, B, S,
                                           cfg.vocab_size)
        elif cfg.frontend != "none":
            batch["embeds"] = rng.standard_normal(
                (B, Ft, cfg.d_model), dtype=np.float32) * 0.02
            batch["tokens"] = _philox_like(self.seed, step, B, S - Ft,
                                           cfg.vocab_size)
            labels = _philox_like(self.seed, step + 1, B, S, cfg.vocab_size)
            labels[:, :Ft] = -1
            batch["labels"] = labels
        else:
            toks = _lm_sequences(self.seed, step, B, S, cfg.vocab_size)
            batch["tokens"] = toks
            labels = np.roll(toks, -1, axis=1)
            labels[:, -1] = -1              # no target for the last position
            batch["labels"] = labels
        if self.tcfg.microbatch:
            m = self.tcfg.microbatch
            assert B % m == 0
            batch = {k: v.reshape((B // m, m) + v.shape[1:])
                     for k, v in batch.items()}
        return batch

    def next(self) -> dict | None:
        """Returns the next batch, or None if an eBPF filter skipped it.

        A NEGATIVE override code (-errno) is a transient read fault: the
        same fetch is retried up to fault_retries times before degrading
        to a skip. A non-negative override is a policy veto: the batch is
        skipped immediately (no retry)."""
        step = self.step
        self.step += 1
        if self.runtime is None:
            return self._make(step)
        for _ in range(self.fault_retries + 1):
            res = self.runtime.syscalls.invoke(
                "sys_data_fetch", [step, self.shape.global_batch],
                impl=lambda: self._make(step))
            if not res.overridden:
                return res.value
            if not res.fault:
                return None          # veto: skip this batch
        return None                  # persistent fault: degrade to skip
