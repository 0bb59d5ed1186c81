"""Whole training step: model FLOPs (counts/<family>.py: 6 x the matrix
parameters a token plus the attention or state-space terms, no recompute)
of the traced steps over the sub-window's wall time and the bf16 peak."""
from portbench import counts


def read(run):
    t = run.trace
    if t is None or run.mode != "train" or not run.traced_steps:
        return None
    fam = counts.family(run.config["counts"])
    per_token = fam.train_flops_per_token(run.model,
                                          run.traffic["seq_len"])
    flops = per_token * run.tokens_per_step * run.traced_steps
    return 100.0 * flops / t.window_s / run.peak["bf16_flops_per_s"]
