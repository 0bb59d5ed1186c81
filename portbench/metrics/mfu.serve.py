"""Whole serving step: model FLOPs (counts/<family>.py) of the prefill and
decode tokens of the traced sub-window, over its wall time and the card's
bf16 peak."""
from portbench import counts


def read(run):
    t = run.trace
    if t is None or not run.traced_decode_positions:
        return None
    flops = counts.family(run.config["counts"]).serve_flops(
        run.model, run.traced_prefills, run.traced_decode_positions)
    return 100.0 * flops / t.window_s / run.peak["bf16_flops_per_s"]
