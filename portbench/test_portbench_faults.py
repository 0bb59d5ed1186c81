"""The check that decides `correct`, shown to fail: each cell driven at
smoke width on the CPU (the harness's look for a card skipped) in
float32, with its own limits, comes out correct as it stands and not
correct with a fault planted in the timed path: a step that hands back
its state unchanged, half of the batch left out, a token altered where
it is produced. (One card, so there is no exchange between chips to
leave out.)

On the card, `test_control_fails_at_the_cells_size` runs the float8
control and the program at each cell's own size on three seeds: the
control fails a limit that the program passes. (The cells held out of
BENCHMARK.json, smoke.HELD_BACK, run here at smoke width with the limits
of the cell of their mix, and have none of their own to hold on the
card.)"""
import time

import pytest

torch = pytest.importorskip("torch")

from portbench import cell as C, smoke  # noqa: E402
from portbench.run import run_cell  # noqa: E402

SEED = 2**32 + 17
CASES = [
    ("qwen2-0.5b.serve_chat", ()),
    ("qwen2-0.5b.serve_chat", ("alter_token",)),
    ("qwen2-0.5b.serve_chat", ("stale_state",)),
    ("qwen2-0.5b.serve_chat", ("half_batch",)),
    ("mamba2-780m.serve_chat", ()),
    ("mamba2-780m.serve_chat", ("alter_token",)),
    ("mamba2-780m.serve_chat", ("stale_state",)),
    ("qwen2-0.5b.train_4k", ()),
    ("qwen2-0.5b.train_4k", ("frozen_state",)),
    ("qwen2-0.5b.train_4k", ("half_batch",)),
    ("mamba2-780m.train_4k", ()),
    ("mamba2-780m.train_4k", ("frozen_state",)),
    ("mamba2-780m.train_4k", ("half_batch",)),
]


@pytest.mark.parametrize("name,faults", CASES,
                         ids=[f"{n}-{'+'.join(f) or 'sound'}"
                              for n, f in CASES])
def test_correct_only_without_a_fault(name, faults):
    cell = smoke.small_cell(name)
    cell.config["model"]["dtype"] = "float32"
    cell.config["train"]["compute_dtype"] = "float32"
    out = run_cell(cell, SEED, 1.0, False, torch.device("cpu"),
                   time.perf_counter(), set(faults))
    assert out["correct"] is (not faults), out["checks"]
    assert list(out)[-1] == "checks"
    assert set(out["checks"]) == {k for k, v in cell.limits.items()
                                  if isinstance(v, dict)}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the control runs at the cell's "
                    "own size")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["qwen2-0.5b.train_4k",
                                  "qwen2-0.5b.serve_chat"])
def test_control_fails_at_the_cells_size(card, name):
    from portbench.calibrate import readings
    cell = C.load_cell(name)
    seconds = 2 if cell.traffic["mode"] == "train" else 20
    for seed, values in readings(name, [2**31 + 101, 2**31 + 102,
                                        2**31 + 103], seconds, ("control",),
                                 card, cell):
        checks = C.limited(cell.limits, values)
        assert C.passed(checks), (seed, checks)
        control = {k: v for k, v in values.items() if k.endswith("_control")}
        assert control, values
        assert any(v > cell.limits[k[:-len("_control")]]["limit"]
                   for k, v in control.items()), (seed, control)
