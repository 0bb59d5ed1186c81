"""The port's examples (examples/torch/, the twins of examples/*.py) run as
real subprocesses on the CPU and, marked `cuda`, on the card: each must
exit 0 -- every twin asserts its own end-to-end invariants and exits
non-zero on failure -- and print the lines tests/test_examples_smoke.py
asserts of its JAX twin. Each run gets its own temporary directory
(TMPDIR, the shm region, checkpoints). train_e2e is shortened with its own
--steps. This file imports no JAX."""
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# twin -> (its arguments beside --device cpu, the lines it must print)
TWINS = {
    "quickstart.py": ([], ["step 4: loss=", "per-layer probe hits: [5, 5]",
                           "activation RMS histogram"]),
    "serve_demo.py": ([], ["rejected", "per-request generated tokens",
                           "decode steps run:"]),
    "train_e2e.py": (["--steps", "3"], ["model: 64M params",
                                        "over 3 steps",
                                        "probe hits/layer: [6, 6,"]),
    "moe_balance.py": ([], ["max per-expert load histogram",
                            "total capacity drops across run:"]),
    "opensnoop_syscalls.py": ([], ["latest committed checkpoint: step 8",
                                   "OK"]),
    "trace_training.py": ([], ["did NOT restart",
                               "jit cache of the running step stayed 1"]),
    "fleet_agg.py": ([], [
        "global total=768 (= 3 workers x 256 events)",
        "OK: global histogram is the exact bin-wise sum",
        "(AOT cache hit)",
        "12 workers -> 3 node aggregators (fan-in 4)",
        "OK: hierarchical tree view is bit-identical to the flat merge"]),
    "chaos_drill.py": ([], [
        "SIGKILLed mid-publish (seqlock left odd)",
        "daemon restarted from the fold journal",
        "OK: global view converged to the oracle",
        "OK: chaos drill survived worker SIGKILL + daemon crash"]),
}


def _run(tmp_path, twin, device, args, lines):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               TMPDIR=str(tmp_path), BPFTIME_SHM=str(tmp_path / "shm"))
    out = subprocess.run(
        [sys.executable, os.path.join(ROOT, "examples", "torch", twin),
         "--device", device, *args],
        capture_output=True, text=True, env=env, cwd=str(tmp_path),
        timeout=400)
    assert out.returncode == 0, \
        f"{twin} exited {out.returncode}\n--- stdout\n{out.stdout[-2000:]}" \
        f"\n--- stderr\n{out.stderr[-3000:]}"
    for line in lines:
        assert line in out.stdout, (line, out.stdout[-2000:])


@pytest.mark.parametrize("twin", list(TWINS))
def test_twin_runs_on_the_cpu(tmp_path, twin):
    _run(tmp_path, twin, "cpu", *TWINS[twin])


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")


@pytest.mark.cuda
@pytest.mark.parametrize("twin", list(TWINS))
def test_twin_runs_on_the_card(cuda, tmp_path, twin):
    _run(tmp_path, twin, "cuda", *TWINS[twin])


@pytest.mark.cuda
def test_train_e2e_resumes_on_the_card(cuda, tmp_path):
    """20 steps (a checkpoint every 10), then --resume to 30."""
    _run(tmp_path, "train_e2e.py", "cuda", ["--steps", "20"],
         ["model: 64M params", "latest checkpoint: step 20"])
    _run(tmp_path, "train_e2e.py", "cuda", ["--steps", "30", "--resume"],
         ["resumed from step 20", "latest checkpoint: step 30"])
