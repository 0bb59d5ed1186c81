"""What every cell shares: finding its files by name, the record a run
leaves for the metric readers, the checks that decide `correct`, and the
device it ran on."""
from __future__ import annotations

import functools
import importlib.util
import json
import math
import re
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


@dataclass
class Cell:
    """One entry of BENCHMARK.json's workloads with its files read."""
    name: str
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list
    per_layer: list


def _applies(metric: dict, cell: str, reported: set) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric.get("moves") in reported if "moves" in metric else True


def load_cell(name: str, bench: dict | None = None,
              root: Path = ROOT) -> Cell:
    """The cell `name`: its configuration (the file BENCHMARK.json names),
    its mix `traffic/<mix>.json`, its limits `limits/<cell>.json`, and the
    metrics it reports."""
    if bench is None:
        bench = json.loads((root / "BENCHMARK.json").read_text())
    try:
        w = next(w for w in bench["workloads"] if w["name"] == name)
    except StopIteration:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json") from None
    conf = next(c for c in bench["configs"] if c["name"] == w["config"])
    e2e = [m for m in bench["end_to_end"] if _applies(m, name, set())]
    reported = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if _applies(m, name, reported)]
    here = root / HERE.name
    return Cell(name=name,
                config=json.loads((root / conf["file"]).read_text()),
                traffic=json.loads((here / "traffic"
                                    / f"{w['traffic']}.json").read_text()),
                limits=json.loads((here / "limits"
                                   / f"{name}.json").read_text()),
                end_to_end=e2e, per_layer=per_layer)


@functools.cache
def metric_reader(name: str, root: Path = ROOT):
    """`read(run) -> float | None` of metrics/<name>.py."""
    path = root / HERE.name / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"portbench.metrics.{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


@functools.cache
def _groups():
    data = json.loads((HERE / "kernel_groups.json").read_text())
    return [(g, re.compile(rx)) for g, rx in data["groups"]]


def kernel_group(name: str) -> str:
    """flash, probe, matmul or elementwise (everything else)."""
    for g, rx in _groups():
        if rx.search(name):
            return g
    return "elementwise"


@dataclass
class Run:
    """What a run leaves for the metric readers. Times on the host's
    clock are seconds of time.perf_counter(); `trace` is the traced
    sub-window (profiling.Trace) of a --trace 1 run."""
    mode: str
    config: dict
    traffic: dict
    setup_s: float = 0.0
    window: tuple = (0.0, 0.0)
    trace: object = None
    # serving: {rid: [emission times]}; per traced iteration the
    # positions its active requests decoded at; the traced prefills'
    # prompt lengths
    emissions: dict = field(default_factory=dict)
    traced_decode_positions: list = field(default_factory=list)
    traced_prefills: list = field(default_factory=list)
    # training: (start, end) of every step of the window, tokens a step
    steps: list = field(default_factory=list)
    tokens_per_step: int = 0
    peak_bytes: int | None = None
    # bytes the probe kernels were given, and flash launches
    # (kind, BH, BKH, S, hd, causal), while traced
    probe_bytes: int = 0
    flash_launches: list = field(default_factory=list)
    traced_steps: int = 0

    @property
    def model(self) -> dict:
        return self.config["model"]

    @property
    def peak(self) -> dict:
        return self.config["peak"]


def passed(checks: dict) -> bool:
    return all(isinstance(c["value"], (int, float))
               and math.isfinite(c["value"]) and c["value"] <= c["limit"]
               for c in checks.values())


def limited(limits: dict, values: dict) -> dict:
    """{name: {"value", "limit"}} of every number the cell's limits file
    names; a number the run did not produce reads NaN and fails."""
    return {k: {"value": values.get(k, float("nan")), "limit": spec["limit"]}
            for k, spec in limits.items() if isinstance(spec, dict)}


def print_checks(checks: dict, out=sys.stderr) -> None:
    for k, c in checks.items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}", file=out,
              flush=True)


def now() -> float:
    return time.perf_counter()


def sync(device) -> None:
    import torch
    if getattr(device, "type", device) == "cuda":
        torch.cuda.synchronize(device)
