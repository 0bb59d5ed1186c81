"""The granite-4.0-h-small cell in the harness, with no card: its check
driven at the configuration's smoke cut on the CPU (float32) comes out
correct as the program stands and not correct with a fault planted in the
timed path, or with a router that drops; its counts agree with the
port's parameter count; and its three readers (the experts' and the
mixers' device ms a decode step, the experts' roofline) on a synthetic
trace in which a graphed decode step replays the spans and records its
segments were captured in, and on one with none of them.

On the card, `test_control_fails_at_the_cells_size` runs the float8
control and the program at the cell's own size on three seeds: the
control fails the limit that the program passes."""
import dataclasses
import gc
import time

import pytest

torch = pytest.importorskip("torch")

from portbench import cell as C, counts, profiling as PR, smoke  # noqa: E402
from portbench.run import run_cell  # noqa: E402
from portbench.test_portbench_room import _Ev  # noqa: E402

CELL = "granite-4.0-h-small.serve_chat"
SEED = 2**32 + 31
FAULTS = [(), ("alter_token",), ("stale_state",), ("half_batch",)]


@pytest.fixture(autouse=True)
def one_thread():
    """The CPU runs on one thread: the program's float32 sums then keep
    one order, so its served tokens, and the gaps a planted fault leaves,
    are the same from run to run (other thread counts round otherwise,
    tip other near-ties and serve other tokens)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _small(**model):
    c = smoke.small_cell(CELL)
    c.config["model"].update(dtype="float32", **model)
    return c


@pytest.mark.parametrize("faults", FAULTS,
                         ids=["+".join(f) or "sound" for f in FAULTS])
def test_correct_only_without_a_fault(faults):
    cell = _small()
    out = run_cell(cell, SEED, 1.0, False, torch.device("cpu"),
                   time.perf_counter(), set(faults))
    assert out["correct"] is (not faults), out["checks"]
    assert set(out["checks"]) == {k for k, v in cell.limits.items()
                                  if isinstance(v, dict)}
    if not faults:
        for k in ("counter_errors", "hist_count_error", "ring_head_error",
                  "events_per_step_error", "tokens_unaccounted"):
            assert out["checks"][k]["value"] == 0, k


def test_a_router_that_drops_fails_on_total_drops():
    """The least capacity, 8 slots an expert, under 16 slots' 160
    assignments a step: total_drops is no longer 0."""
    cell = _small(moe_dropless=False, capacity_factor=0.05)
    cell.traffic["slots"] = 16
    out = run_cell(cell, SEED, 1.0, False, torch.device("cpu"),
                   time.perf_counter())
    assert not out["correct"]
    assert out["checks"]["counter_errors"]["value"] > 0
    assert out["checks"]["events_per_step_error"]["value"] == 0


def test_counts_are_the_ports_active_parameters():
    """matmul_params is the port's active parameter count less what no
    product holds (the norms, the convolutions, A_log, D and dt_bias), at
    the cell's size: the shared expert at its own width of 1536."""
    from repro_torch.configs.base import ModelConfig
    m = C.load_cell(CELL).config["model"]
    cfg = ModelConfig(**m)
    fam = counts.family("granite")
    D, di, N, nh = cfg.d_model, cfg.d_inner(), cfg.ssm_state, cfg.ssm_heads()
    off = cfg.num_layers * 2 * D + 9 * (cfg.ssm_conv * (di + 2 * N) + 3 * nh)
    assert fam.matmul_params(m) == cfg.param_counts()["active"] - off
    assert cfg.param_counts()["total"] == pytest.approx(8.36e9, rel=2e-3)
    # a decode token's FLOPs: the products, the recurrence at 9 layers and
    # attention over 100 positions at one
    assert fam.serve_flops(m, [], [[99]]) == \
        2 * fam.matmul_params(m) + 9 * 4 * nh * 64 * N + 4 * 32 * 128 * 100


# ------------------------------------------------ the readers on a trace

SPAN = PR.SPAN_PREFIX
# (experts held, k, D, expert width, tokens, element size) -> calls
RECORDS = {(72, 10, 4096, 768, 32, 2): 1, (72, 10, 4096, 768, 100, 2): 1}


def _trace(spans=True):
    """A prefill of 100 tokens (eager: its mixer and experts launch kernel
    by kernel) and one graphed decode step of 32 slots: each segment is
    one graph launch, replayed inside the span it was captured in."""
    evs = [_Ev("portbench.window", 0, 2000),
           _Ev(SPAN + "serve.prefill", 10, 290),
           _Ev(SPAN + "decode.step", 1000, 1900),
           _Ev(SPAN + "decode.model", 1010, 1800),
           _Ev("cudaLaunchKernel", 60, 70, corr=1),
           _Ev("cudaLaunchKernel", 170, 180, corr=2),
           _Ev("cudaGraphLaunch", 1110, 1120, corr=3),
           _Ev("cudaGraphLaunch", 1310, 1320, corr=4),
           _Ev("cudaGraphLaunch", 1500, 1510, corr=5),
           _Ev("expert_gemm", 400, 450, device=True, corr=1),
           _Ev("ssd_einsum", 450, 470, device=True, corr=2),
           _Ev("conv_kernel", 1200, 1260, device=True, corr=3),
           _Ev("gemv_kernel", 1260, 1300, device=True, corr=3),
           _Ev("expert_gemm", 1400, 1500, device=True, corr=4),
           _Ev("norm_kernel", 1600, 1650, device=True, corr=5)]
    if spans:
        evs += [_Ev(SPAN + "moe.routed", 50, 150),
                _Ev(SPAN + "ssm.mixer", 160, 200),
                _Ev(SPAN + "ssm.mixer", 1100, 1150),
                _Ev(SPAN + "moe.routed", 1300, 1400)]
    t = PR.Trace(evs)
    t.records = {"launches": {}, "keyed": {"moe.routed": RECORDS}
                 if spans else {}}
    return t


def _run(trace):
    return C.Run(mode="serve", config={"peak": {"hbm_bytes_per_s": 1e12}},
                 traffic={}, trace=trace)


def test_the_readers_read_the_replayed_spans_and_records():
    run = _run(_trace())
    read = {n: C.metric_reader(n)(run) for n in (
        "moe_device_ms.serve", "mamba_device_ms.serve",
        "moe_roofline.serve")}
    # the decode step's spans only: 100 ns of experts, 60 + 40 of mixer
    assert read["moe_device_ms.serve"] == pytest.approx(100e-6)
    assert read["mamba_device_ms.serve"] == pytest.approx(100e-6)
    # every moe.routed span and record: the prefill's 50 ns and the step's
    # 100 against both calls' bytes
    nbytes = sum((E * 3 * D * F + 2 * T * D) * size
                 for E, _, D, F, T, size in RECORDS)
    assert read["moe_roofline.serve"] == pytest.approx(
        100 * nbytes / 1e12 / 150e-9)


def test_the_readers_find_nothing_without_the_spans():
    """A program with no `moe.routed` or `ssm.mixer` span (the parent of
    the change that adds them, or a dense model): nothing to read."""
    run = _run(_trace(spans=False))
    for n in ("moe_device_ms.serve", "mamba_device_ms.serve",
              "moe_roofline.serve"):
        assert C.metric_reader(n)(run) is None, n
    assert C.metric_reader("moe_device_ms.serve")(_run(None)) is None


def test_the_cell_reports_its_readers():
    cell = C.load_cell(CELL)
    names = {m["name"] for m in cell.per_layer}
    assert {"moe_device_ms.serve", "mamba_device_ms.serve",
            "moe_roofline.serve", "mfu.serve", "device_idle_share.serve",
            "prefill_share.serve", "decode_model_host_ms.serve"} <= names
    assert {m["name"] for m in cell.end_to_end} == {
        "output_tokens_per_s", "itl_p95_ms", "setup_s"}
    assert "program_limits" not in cell.config
    assert cell.config["map_expect"] == {"total_drops": 0}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the control runs at the cell's "
                    "own size")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_control_fails_at_the_cells_size(card):
    from portbench.calibrate import readings
    cell = C.load_cell(CELL)
    for seed, values in readings(CELL, [2**31 + 201, 2**31 + 202,
                                        2**31 + 203], 20, ("control",),
                                 card, dataclasses.replace(cell)):
        checks = C.limited(cell.limits, values)
        assert C.passed(checks), (seed, checks)
        assert values["logit_gap_control"] > \
            cell.limits["logit_gap"]["limit"], (seed, values)
        # the run's engine and the recorder that wraps its decode hold each
        # other: free both, and the 40 GB they hold, before the next seed
        gc.collect()
