"""Cells at smoke width for the CPU tests: the cells of BENCHMARK.json
with their configuration cut by its own "smoke" section (each of its
sections' keys set over the configuration's: the model's widths, depth
and vocabulary, and where the cut needs it its probe_sites and
program_limits) and their mix to a few slots and short sequences. Every
other setting, the limits among them, is the cell's own.

HELD_BACK are cells whose files are here but which BENCHMARK.json leaves
out until the program can run their configuration as it is stated
(PERF.md, Open questions): the tests and calibrate.py still drive them,
with the limits of the cell of the same mix they name (they have no
limits of their own yet)."""
from __future__ import annotations

import dataclasses
import json

from . import cell as C

HELD_BACK = {
    # residual_in_fp32, which the port does not honour
    "mamba2-780m.serve_chat": "qwen2-0.5b.serve_chat",
    "mamba2-780m.train_4k": "qwen2-0.5b.train_4k",
}


def held_back_cell(name: str) -> C.Cell:
    """The held-back cell `name` (<config>.<mix>) at its full size."""
    config, mix = name.rsplit(".", 1)
    return dataclasses.replace(
        C.load_cell(HELD_BACK[name]), name=name,
        config=json.loads((C.HERE / "configs" / f"{config}.json")
                          .read_text()),
        traffic=json.loads((C.HERE / "traffic" / f"{mix}.json").read_text()))


def any_cell(name: str) -> C.Cell:
    return held_back_cell(name) if name in HELD_BACK else C.load_cell(name)


def small_cell(name: str) -> C.Cell:
    c = any_cell(name)
    for section, keys in c.config["smoke"].items():
        c.config.setdefault(section, {}).update(keys)
    if c.traffic["mode"] == "serve":
        c.traffic.update(slots=4, max_seq=128, pool=256, block=32,
                         warm_iterations=3, trace_iterations=4,
                         check_tokens=60)
        c.traffic["prompt_tokens"].update(median=12, min=4, max=40)
        c.traffic["output_tokens"].update(median=8, min=3, max=20)
    else:
        c.traffic.update(seq_len=32, batch=4)
    return c
