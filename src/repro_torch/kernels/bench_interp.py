"""Time the table interpreter kernel on the card and split its launches
into phases.

    python -m repro_torch.kernels.bench_interp --make-tape build/tape.npz
    python -m repro_torch.kernels.bench_interp --tape build/tape.npz
    python src/repro_torch/kernels/bench_interp.py --tree DIR \\
        --tape build/tape.npz

Cases: the mixed check table (`interp_cases.mixed_case`) at 49 and 4096
events, and the serving table (the first three `launch/serve.LIVE_PROBES`
on the live table: a vec, a sequential and a vec slot) over a decode tape
of qwen2-0.5b at full width, random weights from seed 0 (`--make-tape`
records one, with its sites' names). For each case: device ms per launch
(CUDA events around back-to-back calls queued behind a sleep, so the
host's enqueue rate does not bound them), host µs per call, and device ms
with slot masks -- no slot active (copy-in and copy-out), the sequential
slots only, the vec slots only, each slot alone. That split needs
nothing of the kernel, so it also measures a kernel with no timer. Where
the kernel leaves stamps (`table_interp.LAST_STAMPS`), their split too.

`--tree DIR` imports the package from DIR/src (another checkout, such as a
`git archive` export of a parent commit, which builds its own kernels).
Prints one JSON line. Needs one CUDA device; imports no JAX.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

SEED = 0


def _device_ms(torch, fn, reps: int) -> float:
    """Device ms per call of fn() run back to back: torch.cuda._sleep holds
    the stream while the host enqueues `reps` calls, so the CUDA events
    around them time the device alone, however short each launch is."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    cycles = int((time.perf_counter() - t0) * 4e9) + 4_000_000
    for _ in range(6):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        held = not a.query()      # the device still sleeps: a queue formed
        b.synchronize()
        if held:
            return a.elapsed_time(b) / reps
        cycles *= 4
    raise RuntimeError("bench_interp: the host did not finish enqueuing "
                       "within the sleep")


def _host_us(torch, fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t = time.perf_counter() - t0
    torch.cuda.synchronize()
    return t / reps * 1e6


def _masked(torch, table, keep):
    """A copy of a live table's device state with every slot outside `keep`
    inactive."""
    from repro_torch.core.table_interp import table_layout
    P, N = table["hcls"].shape
    buf = table["packed"].clone()
    views = {"packed": buf}
    for f, off, shape in table_layout(P, N)[0]:
        n = 1
        for d in shape:
            n *= d
        views[f] = buf[off:off + n].view(shape)
    for p in range(P):
        if p not in keep:
            views["active"][p] = 0
    return views


def make_tape(torch, path: str) -> None:
    """One decode step's event rows of qwen2-0.5b at full width, with the
    live lane armed, and the names of their sites."""
    from repro_torch.configs import registry
    from repro_torch.core import events as E
    from repro_torch.core.runtime import BpftimeRuntime
    from repro_torch.launch import serve as L
    from repro_torch.models import registry as MR
    from repro_torch.serve.engine import ServeEngine
    import numpy as np
    cfg = registry.get("qwen2-0.5b")
    rt = BpftimeRuntime()
    L.load_live_probes(rt)
    rt.enable_live_attach(arm=L.LIVE_ARM)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    engine = ServeEngine(MR.init_params(cfg, gen, "cuda"), cfg, slots=4,
                         max_seq=128, runtime=rt, device="cuda")
    engine.submit_all(L.make_requests(4, 2, cfg.vocab_size, SEED))
    rows = engine.last_tape[0].cpu().numpy()
    names = [E.SITES.name_of(int(s)) for s in rows[:, 0]]
    np.savez(path, rows=rows, names=np.array(names))


def serving_case(torch, path: str):
    """(spec_key, table, rows, maps, aux) of the serving table over the
    recorded tape, its site ids those of this process."""
    import numpy as np
    from repro_torch.core import events as E, jit as J
    from repro_torch.core.runtime import BpftimeRuntime
    from repro_torch.launch import serve as L
    d = np.load(path)
    rows = d["rows"].copy()
    rows[:, 0] = [E.SITES.get_or_create(str(n)) for n in d["names"]]
    rt = BpftimeRuntime()
    pids = L.load_live_probes(rt)
    rt.enable_live_attach(arm=L.LIVE_ARM)
    for name, _, _, target in L.LIVE_PROBES[:3]:
        rt.attach(pids[name], target, mode="table", promote=False)
    st = rt.init_device_maps("cuda")
    table = st.pop("__live_table__")
    maps = {k: st[k] for k, *_ in rt.live.spec_key}
    return (rt.live.spec_key, table, torch.as_tensor(rows, device="cuda"),
            maps, J.make_aux(time_ns=int(rows[0, 3]), device="cuda"))


def measure(torch, case, reps: int) -> dict:
    from repro_torch.kernels import ops, table_interp as TI
    key, table, rows, maps, aux = case
    active = [p for p, a in enumerate(table["active"].tolist()) if a]
    vec = [p for p in active if table["vec"][p]]
    seq = [p for p in active if p not in vec]

    def timed(tbl, n=reps):
        return _device_ms(torch, lambda: ops.table_interp_run(
            key, tbl, rows, maps, aux), n)

    out = {"events": rows.shape[0], "slots": {"seq": seq, "vec": vec},
           "ms": timed(table),
           "host_us": _host_us(torch, lambda: ops.table_interp_run(
               key, table, rows, maps, aux), reps),
           "masked_ms": {
               "none": timed(_masked(torch, table, [])),
               "seq_only": timed(_masked(torch, table, seq)),
               "vec_only": timed(_masked(torch, table, vec)),
               **{f"slot_{p}": timed(_masked(torch, table, [p]))
                  for p in active}}}
    if getattr(TI, "LAST_STAMPS", None) is not None:
        ops.table_interp_run(key, table, rows, maps, aux)
        torch.cuda.synchronize()
        out["clock_khz"] = TI.clock_khz()
        out["stamps_us"] = TI.phase_split(TI.LAST_STAMPS.cpu(),
                                          out["clock_khz"], vec)
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", help="a checkout whose src/ to import")
    ap.add_argument("--tape", help="a decode tape from --make-tape")
    ap.add_argument("--make-tape", help="record a decode tape here, stop")
    args = ap.parse_args(argv)
    if args.tree:
        sys.path.insert(0, str(Path(args.tree).resolve() / "src"))
    sys.modules.setdefault("jax", None)
    sys.modules.setdefault("repro", None)
    import torch
    if not torch.cuda.is_available():
        sys.exit("bench_interp: needs a CUDA device")
    if args.make_tape:
        make_tape(torch, args.make_tape)
        return
    import repro_torch
    from repro_torch.kernels import interp_cases as IC
    cases = {f"mixed {n}": (IC.mixed_case(n, SEED + n, "cuda"),
                            20 if n < 1000 else 5) for n in (49, 4096)}
    if args.tape:
        cases["serving"] = (serving_case(torch, args.tape), 200)
    report = {"tree": str(Path(repro_torch.__file__).parents[2]),
              "device": torch.cuda.get_device_name(0),
              "cases": {name: measure(torch, c, reps)
                        for name, (c, reps) in cases.items()}}
    print(json.dumps(report), flush=True)


if __name__ == "__main__":
    main()
