"""Probe kernels (tensor_stats, the hash fetch-add, the ring-buffer emit):
the least time their launches' bytes need at the card's peak bandwidth
(counts/probes.py, each input byte read once and each output byte written
once) over their device time in the traced sub-window."""
from portbench.cell import kernel_group


def read(run):
    t = run.trace
    if t is None or not run.probe_bytes:
        return None
    dev = t.device_s(lambda n: kernel_group(n) == "probe")
    if dev <= 0:
        return None
    return 100.0 * run.probe_bytes / run.peak["hbm_bytes_per_s"] / dev
