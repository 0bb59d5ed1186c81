"""Flash attention kernels (kernels/flash_attention.py,
csrc/flash_attention_sm90.cuh): the least time of every forward
(recompute included) and backward launch of the traced steps
(counts/flash.py at the card's peaks) over their device time."""
from portbench.cell import kernel_group
from portbench.counts import flash


def read(run):
    t = run.trace
    if t is None or not run.flash_launches:
        return None
    pk = run.peak
    bound = 0.0
    for kind, BH, BKH, S, hd, causal in run.flash_launches:
        if kind == "fwd":
            fl, by = flash.fwd_flops(BH, S, hd, causal), \
                flash.fwd_bytes(BH, BKH, S, hd)
        else:
            fl, by = flash.bwd_flops(BH, S, hd, causal), \
                flash.bwd_bytes(BH, BKH, S, hd)
        bound += flash.bound_s(fl, by, pk["bf16_flops_per_s"],
                               pk["hbm_bytes_per_s"])
    dev = t.device_s(lambda n: kernel_group(n) == "flash")
    return 100.0 * bound / dev if dev > 0 else None
