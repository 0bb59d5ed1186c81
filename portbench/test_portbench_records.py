"""The program's launch records and spans against the harness's own
counts and ranges, with no card: the counts from the program's launch
keys (counts/keys.py) against the counts from the launch's tensors, and a
traced run of each mode at smoke width on the CPU, which turns telemetry
on over the traced window, its records and spans held against the
benchmark's counts and ranges, and the span readers reading them."""
import time

import pytest

torch = pytest.importorskip("torch")

from portbench import cell as C, serve_cell, smoke, train_cell  # noqa: E402
from portbench.counts import keys as K, probes as PB  # noqa: E402


def _meta(shape, dtype):
    return torch.empty(shape, dtype=dtype, device="meta")


I64, BOOL = torch.int64, torch.bool


@pytest.mark.parametrize("shape,dtype", [
    ((32, 1, 896), torch.bfloat16), ((32, 1, 152064), torch.float32),
    ((2, 4096, 896), torch.bfloat16), ((2, 4096, 152064), torch.float32),
    ((1,), torch.float32)])
def test_tensor_stats_bytes_from_the_key_equal_the_tensors(shape, dtype):
    x = _meta(shape, dtype)
    key = ("repro_tensor_stats_row", x.numel(), x.element_size())
    assert K.tensor_stats(key) == PB.tensor_stats_row(x)
    # the dict kernel reads the same input and writes six i64 lanes
    assert K.tensor_stats(("repro_tensor_stats",) + key[1:]) == \
        PB.tensor_stats_row(x) - PB.ROW_BYTES + 6 * 8


@pytest.mark.parametrize("n,b", [(256, 24), (256, 49), (128, 48)])
def test_table_kernel_bytes_from_the_key_equal_the_tensors(n, b):
    from repro_torch.telemetry import shapes
    hash_args = [_meta((n,), I64)] * 3 + [_meta((b,), I64)] * 2 + \
        [_meta((b,), BOOL)]
    assert K.table_kernel(shapes(*hash_args)) == \
        PB.hash_fetch_add_batch(*hash_args)
    ring_args = [_meta((64, 4), I64), _meta((1,), I64), _meta((1,), I64),
                 _meta((b, 4), I64), _meta((b,), BOOL)]
    assert K.table_kernel(shapes(*ring_args)) == \
        PB.ringbuf_emit_batch(*ring_args)
    keyed = {"probe.hash_fetch_add": {shapes(*hash_args): 3},
             "probe.ringbuf_emit": {shapes(*ring_args): 2}}
    assert K.probe_bytes(keyed) == 3 * PB.hash_fetch_add_batch(*hash_args) \
        + 2 * PB.ringbuf_emit_batch(*ring_args)


def test_flash_launches_and_serving_flops_from_the_records():
    keyed = {"flash.fwd": {(28, 4, 4096, 64, True): 2},
             "flash.bwd": {(28, 4, 4096, 64, True): 1},
             "serve.prefill_tokens": {12: 2, 40: 1},
             "serve.decode_position": {12: 1, 13: 2, 50: 1}}
    assert sorted(K.flash_launches(keyed)) == sorted(
        [("fwd", 28, 4, 4096, 64, True)] * 2
        + [("bwd", 28, 4, 4096, 64, True)])
    from portbench import counts
    m = C.load_cell("qwen2-0.5b.serve_chat").config["model"]
    fam = counts.family("dense")
    prefills, positions = K.serve_positions(keyed)
    assert fam.serve_flops(m, prefills, positions) == fam.serve_flops(
        m, [40, 12, 12], [[13, 12], [50, 13]])


# ------------------------------------------------- a traced run on the CPU

def _traced(name):
    """A traced run of the cell at smoke width on the CPU (profiling.Window
    turns the port's telemetry on over the traced window): serving traces
    its first 4 iterations of a 2 s window; training its first step,
    whatever the window holds."""
    cell = smoke.small_cell(name)
    cell.config["model"]["dtype"] = "float32"
    cell.config["train"]["compute_dtype"] = "float32"
    cell.traffic["trace_steps"] = 1
    mode = {"serve": serve_cell, "train": train_cell}[
        cell.traffic["mode"]]
    run, values, _, _ = mode.run(cell, 2**32 + 17, 2.0, True,
                                 torch.device("cpu"), time.perf_counter())
    assert C.passed(C.limited(cell.limits, values)), values
    return run


def _inside(inner, outer) -> bool:
    """Every interval of `inner` lies inside one of `outer`."""
    return all(any(a <= s and e <= b for a, b in outer) for s, e in inner)


def test_a_traced_serving_run_has_spans_and_records_beside_its_ranges():
    run = _traced("qwen2-0.5b.serve_chat")
    t = run.trace
    spans = t.spans
    assert len(spans["decode.step"]) == t.calls("decode") > 0
    assert _inside(spans["decode.step"], t.ranges["decode"])
    assert len(spans["probe.emit"]) == t.calls("emit")
    assert len(spans["probe.stage"]) == t.calls("probe_stage")
    # every serve.prefill inside a range of the benchmark's wrapper
    assert len(spans["serve.prefill"]) == t.calls("prefill_slot") == \
        len(run.traced_prefills)
    assert _inside(spans["serve.prefill"], t.ranges["prefill_slot"])
    assert _inside(spans["serve.slot_write"], spans["serve.prefill"])
    keyed = t.records["keyed"]
    prefills, positions = K.serve_positions(keyed)
    assert prefills == sorted(run.traced_prefills)
    assert positions[0] == sorted(p for step in run.traced_decode_positions
                                  for p in step)
    mfu = C.metric_reader("mfu.serve")
    recounted = C.Run(mode="serve", config=run.config, traffic=run.traffic,
                      trace=t, traced_prefills=prefills,
                      traced_decode_positions=positions)
    assert mfu(recounted) == mfu(run)
    # the span readers: every emit lies in the model's span of a decode
    # step, whose host time it is taken out of
    assert len(t.nested("probe.emit", "decode.model")) == \
        len(t.nested("probe.emit", "decode.step")) == \
        len(spans["probe.emit"])
    model = C.metric_reader("decode_model_host_ms.serve")(run)
    assert 0 < model < 1e3 * t.host_s("decode.model") / t.calls("decode")
    assert 0 < C.metric_reader("emit_host_us.serve")(run) < 1e6 * \
        t.host_s("decode.step") / t.calls("decode")
    slot_write = C.metric_reader("slot_write_ms.serve")(run)
    assert (slot_write is None) == (not run.traced_prefills)
    assert t.host_s("decode.step") <= t.host_s("decode")
    assert "idle_gaps_by_span" in t.breakdown()


def test_a_traced_training_run_has_spans_beside_its_ranges():
    run = _traced("qwen2-0.5b.train_4k")
    spans = run.trace.spans
    steps = len(spans["train.step"])
    assert steps == run.traced_steps == 1
    assert len(spans["train.forward"]) == run.trace.calls("forward") == \
        len(spans["train.backward"]) == 2 * steps
    # the benchmark wraps the loss the forward span calls
    assert _inside(run.trace.ranges["forward"], spans["train.forward"])
    assert len(spans["train.optimizer"]) == steps
    assert len(spans["model.loss"]) == 2 * steps
    assert _inside(spans["model.loss"], spans["train.forward"])
    # no device operation on the CPU: the device readers find nothing
    for name in ("optimizer_device_ms.train", "loss_device_ms.train",
                 "forward_idle_ms.train"):
        assert C.metric_reader(name)(run) is None, name
