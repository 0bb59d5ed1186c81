"""The paper's flagship scenario on the PyTorch port: attach to a RUNNING
training loop without restarting it -- without rebuilding the step -- and
without paying the interpreter forever: the live-injected program lands on
the table lane in ~ms, a background thread builds the fused-lane step off
the critical path, and the runtime swaps it in at the next generation
boundary. The injected probe's life is the full promotion state machine:
interp -> compiling -> ready -> fused. The twin of
examples/trace_training.py, on `repro_torch`.

The JAX twin asserts `step._cache_size() == 1`: the jitted step never
retraced. Eager PyTorch has no trace cache; the counterpart asserted here
is that the running step object is never rebuilt while the program runs on
the table lane -- `build_step` is called once to make it, and once
more only by the promotion (`build_calls`) -- and that the loop keeps
calling that same object until the promoted step is handed over.

    PYTHONPATH=src python examples/torch/trace_training.py          # CUDA
    PYTHONPATH=src python examples/torch/trace_training.py --device cpu
    # in another shell, while it runs:
    PYTHONPATH=src python -m repro_torch.core.daemon "$TMPDIR/bpftime_shm" --once
"""
import argparse
import os
import sys
import tempfile

from repro_torch.configs import registry
from repro_torch.configs.base import ShapeConfig, TrainConfig
from repro_torch.core import loader, maps as M
from repro_torch.core.daemon import render_log2_hist, request_load_attach
from repro_torch.core.runtime import BpftimeRuntime
from repro_torch.core.shm import ShmRegion
from repro_torch.data.pipeline import SyntheticDataset
from repro_torch.train.train_step import init_train_state, make_train_step

GRAD_WATCH = """
    ldxdw r2, [r1+ctx:rms]
    lddw r1, map:grad_hist
    call hist_add
    mov r0, 0
    exit
"""


def _hist_total(state) -> int:
    return int(state["maps"]["grad_hist"]["bins"].sum())


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    shm = os.environ.get("BPFTIME_SHM",
                         os.path.join(tempfile.gettempdir(), "bpftime_shm"))

    rt = BpftimeRuntime()
    rt.create_map(M.MapSpec("grad_hist", M.MapKind.LOG2HIST))
    # live lane: arm the candidate site BEFORE building the step (the
    # patched-but-idle trampoline); any verified program can hot-attach to
    # it later
    rt.enable_live_attach(max_programs=4, max_insns=64,
                          arm=("probe:grad.norm",))
    rt.setup_shm(shm)
    print(f"shm control plane at {shm}")

    cfg = registry.smoke("qwen2-0.5b")
    tcfg = TrainConfig(warmup=2)
    state = init_train_state(cfg, tcfg, rt, device=args.device)
    data = SyntheticDataset(cfg, ShapeConfig("t", 64, 8, "train"), tcfg,
                            runtime=rt)
    build_calls = []

    def build_step():
        step_fn = make_train_step(cfg, tcfg, rt)
        build_calls.append(step_fn)
        return step_fn

    step = build_step()

    # --- steps 0-4: UNinstrumented (armed site emits, table is empty)
    for _ in range(5):
        state, m = step(state, data.next())
    hist0 = _hist_total(state)
    print(f"steps 0-4 uninstrumented: loss={float(m['loss']):.4f}, "
          f"hist events={hist0}")
    assert hist0 == 0, "empty table must execute nothing"
    assert build_calls == [step]

    # --- a 'daemon' injects a grad-norm watcher into the RUNNING loop
    obj = loader.build_object(
        "grad_watch", GRAD_WATCH,
        [M.MapSpec("grad_hist", M.MapKind.LOG2HIST)],
        prog_type="uprobe", attach_to="probe:grad.norm")
    other = ShmRegion.attach(shm)
    request_load_attach(other, obj.to_json(), mode="table", promote=True)

    applied = rt.poll_control()             # picked up between steps
    assert applied and "error" not in applied[0], applied
    link = rt.links[applied[0]["link_id"]]
    state["maps"] = rt.sync_live_table(state["maps"])
    print(f"live-injected: link {int(link)} on lane {link.lane!r} "
          f"(table gen {int(rt.live.host['gen'][0])}, promotion "
          f"{link.promotion_state!r}) — training did NOT restart")
    assert link.lane == "table"

    # --- steps 5-9: interpreted by the SAME step object
    for _ in range(5):
        state, m = step(state, data.next())
    hist1 = _hist_total(state)
    print(f"steps 5-9 on the table lane: hist events={hist1}")
    assert hist1 == 5, f"one grad.norm event per step, got {hist1}"
    assert build_calls == [step], \
        "live attach must not rebuild the running step"

    # --- arm background promotion: hand the engine the loop's build_step
    # and call signature, so the live-injected link (promote=True) converges
    # to fused cost. The JAX twin arms it before the inject, while its
    # compile takes seconds; the port builds a step in microseconds (an
    # eager closure), so a promotion armed then would swap in at the very
    # sync that installed the table and the table lane would carry no step
    batch = data.next()
    rt.enable_promotion(build_step, (state, batch))

    # --- the swap: wait for the background build (a real loop would just
    # keep stepping), apply at the generation boundary, pick up the step
    rt._promoter.wait()
    state["maps"] = rt.sync_live_table(state["maps"])
    fused_step = rt.take_promoted_step()
    assert fused_step is not None, link.promotion_error
    assert link.lane == "fused" and link.promotion_state == "fused"
    print(f"promoted: link {int(link)} now on lane {link.lane!r} "
          f"(background compiles: {rt._promoter.compiles})")

    # --- steps 10-14: fused steady state; the event stream never skipped
    # or double-counted a step across the swap
    for i in range(5):
        state, m = fused_step(state, batch if i == 0 else data.next())
        rt.publish(state["maps"])
    hist2 = _hist_total(state)
    print(f"steps 10-14 on the fused lane: hist events={hist2}")
    assert hist2 == 10, f"exactly one event per instrumented step, {hist2}"
    assert build_calls == [step, fused_step], \
        "the live step itself was never rebuilt"
    assert rt._promoter.compiles == 1, "promotion compiled exactly once"

    # --- detach via the unified handle; the PRE-promotion step (no static
    # attachment, empty table) shows the probe is really gone
    link.detach()
    state["maps"] = rt.sync_live_table(state["maps"])
    for _ in range(3):
        state, m = step(state, data.next())
    hist3 = _hist_total(state)
    assert hist3 == hist2, "detached program kept running"
    assert build_calls == [step, fused_step]

    print("\ngradient-norm histogram (live in shm for the daemon):")
    print(render_log2_hist(state["maps"]["grad_hist"]["bins"].cpu().numpy(),
                           label="grad_norm"))
    print("OK: table attach -> background promotion -> fused steady state, "
          "jit cache of the running step stayed 1")
    return 0


if __name__ == "__main__":
    sys.exit(main())
