"""Model (models/, train/train_step.py): share of the traced steps'
device time in operations that are neither matrix products, flash
attention nor probe kernels (kernel_groups.json)."""
from portbench.cell import kernel_group


def read(run):
    t = run.trace
    if t is None or run.mode != "train":
        return None
    total = t.device_s()
    if total <= 0:
        return None
    return 100.0 * t.device_s(lambda n: kernel_group(n) == "elementwise") \
        / total
