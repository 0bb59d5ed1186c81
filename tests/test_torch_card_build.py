"""What nvcc made of the port's kernels, read from the build on the card:
every bf16 flash kernel runs its products on the tensor cores (HGMMA in
`cuobjdump -sass` of its library), and the interpreter keeps its state in
registers and shared memory (no stack frame in ptxas's report, which the
build keeps beside each library as <library>.log). Every test is marked
`cuda` and skips without a CUDA device; this file imports no JAX:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_card_build.py
"""
import re
import shutil
import subprocess
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import build  # noqa: E402

pytestmark = pytest.mark.cuda

# the bf16 flash kernels (namespace sm90 of csrc/flash_attention_sm90.cuh),
# each built for four head dims
FLASH_SM90 = ("fwd_kernel", "dkv_kernel", "dq_kernel")


@pytest.fixture
def built():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    build.build_all()
    return build


def _sm90_label(mangled: str):
    """`dkv_kernel<64>` for a mangled sm90 flash kernel's name, else None."""
    for k in FLASH_SM90:
        m = re.search(rf"sm90\d+{k}ILi(\d+)E", mangled)
        if m:
            return f"{k}<{m.group(1)}>"
    return None


def _probe_label(mangled: str):
    """`stats_kernel<bf16,row>`, `hash_shared`, ... for a mangled probe
    kernel's name, else None."""
    m = re.search(r"stats_kernelILb(\d)ELb(\d)E", mangled)
    if m:
        flags = [f for f, on in zip(("bf16", "row"), m.groups())
                 if on == "1"]
        return f"stats_kernel<{','.join(flags) or 'f32'}>"
    m = re.search(r"(hash_shared|hash_global|ringbuf_emit|table_interp)",
                  mangled)
    return m.group(1) if m else None


def ptxas_report(log: str, label) -> dict:
    """{kernel: stack frame bytes} of the kernels `label` names, from
    nvcc's -Xptxas=-v output."""
    out, cur = {}, None
    for line in log.splitlines():
        m = re.search(r"(?:Compiling entry function '|Function properties "
                      r"for )(\w+)", line)
        if m:
            cur = label(m.group(1))
            if cur:
                out.setdefault(cur, None)
            continue
        m = re.search(r"(\d+) bytes stack frame", line)
        if cur is not None and m:
            out[cur] = int(m.group(1))
    return out


def _log(built, name) -> str:
    return built.path(name).with_suffix(".log").read_text()


def test_bf16_flash_kernels_use_the_tensor_cores(built):
    """Three kernels at four head dims, each with HGMMA instructions."""
    tool = Path(built.nvcc()).with_name("cuobjdump")
    tool = str(tool) if tool.exists() else shutil.which("cuobjdump")
    if tool is None:
        pytest.skip("cuobjdump is not installed beside nvcc")
    sass = subprocess.run([tool, "-sass", str(built.path("flash_attention"))],
                          capture_output=True, text=True, timeout=300)
    assert sass.returncode == 0, sass.stderr[-2000:]
    counts, cur = {}, None
    for line in sass.stdout.splitlines():
        m = re.search(r"Function : (\w+)", line)
        if m:
            cur = _sm90_label(m.group(1))
            if cur:
                counts[cur] = 0
            continue
        if cur and "HGMMA" in line:
            counts[cur] += 1
    names = set(ptxas_report(_log(built, "flash_attention"), _sm90_label))
    assert names == set(counts) and len(names) == len(FLASH_SM90) * 4
    assert all(counts.values()), counts


def test_the_interpreter_has_no_stack_frame(built):
    """ptxas reports the eight probe kernels (four tensor_stats, the two
    hash routes, the ring buffer, the interpreter); the interpreter's
    stack frame is 0 bytes."""
    report = {}
    for src in ("tensor_stats", "hash_update", "ringbuf_emit",
                "table_interp"):
        report.update(ptxas_report(_log(built, src), _probe_label))
    assert len(report) == 8, sorted(report)
    assert report["table_interp"] == 0
