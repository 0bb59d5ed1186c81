"""The harness's own arithmetic and plumbing, with no card: the traffic
generators, the host-clock metrics on synthetic timestamps, files found
by name, and the imports it makes."""
import json
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from portbench import cell as C, smoke, timeline, traffic as TR  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def serve_mix():
    cell = smoke.held_back_cell("mamba2-780m.serve_chat")
    return cell.traffic, cell.config


def test_serving_traffic_is_the_seeds_own():
    tr, cfg = serve_mix()
    a = TR.serve_requests(tr, cfg, 2**31 + 5)
    b = TR.serve_requests(tr, cfg, 2**31 + 5)
    c = TR.serve_requests(tr, cfg, 2**31 + 6)
    assert a == b
    assert [r["prompt"] for r in a] != [r["prompt"] for r in c]
    # every seed offers the same lengths in the same order
    assert [(len(r["prompt"]), r["max_new"]) for r in a] == \
        [(len(r["prompt"]), r["max_new"]) for r in c]


def test_serving_lengths_follow_the_mix():
    tr, cfg = serve_mix()
    pool = TR.serve_requests(tr, cfg, 3)
    plen = sorted(len(r["prompt"]) for r in pool[:tr["block"]])
    olen = sorted(r["max_new"] for r in pool[:tr["block"]])
    assert plen[0] >= tr["prompt_tokens"]["min"]
    assert plen[-1] <= tr["prompt_tokens"]["max"]
    assert olen[0] == tr["output_tokens"]["min"]
    assert olen[-1] == tr["output_tokens"]["max"]
    # each block holds the same lengths
    for i in range(0, len(pool), tr["block"]):
        blk = pool[i:i + tr["block"]]
        assert sorted(len(r["prompt"]) for r in blk) == plen
        assert sorted(r["max_new"] for r in blk) == olen


def test_the_mamba2_chunk_rule_is_applied():
    tr, cfg = serve_mix()
    assert cfg["program_limits"]["prefill_multiple_above"] == 256
    lens = {len(r["prompt"]) for r in TR.serve_requests(tr, cfg, 9)}
    assert any(n > 256 for n in lens)
    assert all(n <= 256 or n % 256 == 0 for n in lens)
    assert TR.prompt_cut(700, cfg) == 512 and TR.prompt_cut(200, cfg) == 200
    qwen = C.load_cell("qwen2-0.5b.serve_chat").config
    assert TR.prompt_cut(700, qwen) == 700


def test_training_batches_are_the_seeds_own():
    cell = C.load_cell("qwen2-0.5b.train_4k")
    tr = dict(cell.traffic, seq_len=16)
    a = TR.train_batch(tr, cell.config, 7, 0, "cpu")
    assert a["tokens"].shape == (2, 2, 16)
    assert torch.equal(a["tokens"], TR.train_batch(tr, cell.config, 7, 0,
                                                   "cpu")["tokens"])
    assert not torch.equal(a["tokens"], TR.train_batch(
        tr, cell.config, 8, 0, "cpu")["tokens"])
    assert not torch.equal(a["tokens"], TR.train_batch(
        tr, cell.config, 7, 1, "cpu")["tokens"])
    # labels are the next tokens
    b = TR.train_batch(dict(tr, batch=1), dict(
        cell.config, train={"microbatch": 0}), 7, 0, "cpu")
    assert torch.equal(b["tokens"][0, 1:], b["labels"][0, :-1])


def test_itl_covers_every_token_and_a_stall_moves_it():
    # 4 requests, one token each 0.1 s, window (0, 10]
    em = {r: [0.05 + 0.1 * i for i in range(100)] for r in range(4)}
    gaps = timeline.token_gaps(em, 0.0, 10.0)
    assert len(gaps) == 4 * 99
    assert timeline.percentile(gaps, 95) == pytest.approx(0.1)
    # one iteration stalls 2 s: every request's next token waits; 4 of
    # 396 gaps is 1 %, under the 95th percentile
    stalled = {r: [t + (2.0 if t > 5 else 0.0) for t in ts]
               for r, ts in em.items()}
    assert timeline.percentile(timeline.token_gaps(stalled, 0, 20),
                               95) == pytest.approx(0.1)
    # a stall on every tenth iteration reaches it
    slow = {r: [0.1 * i + 0.5 * (i // 10) for i in range(100)]
            for r in range(4)}
    assert timeline.percentile(timeline.token_gaps(slow, 0, 60),
                               95) == pytest.approx(0.6)
    assert timeline.tokens_per_s(em, 0.0, 10.0) == pytest.approx(
        400 / 9.95)
    # tokens outside the window do not count
    assert len(timeline.window_tokens(em, 2.0, 3.0)) == 4 * 10


def test_train_rate_counts_whole_steps():
    steps = [(0.0, 0.7), (0.7, 1.4), (1.4, 2.1)]
    assert timeline.train_rate(steps, 0.0, 16384) == pytest.approx(
        3 * 16384 / 2.1)
    assert timeline.train_rate([], 0.0, 16384) == 0.0


def _copy_tree(tmp: Path) -> Path:
    root = tmp / "checkout"
    shutil.copytree(HERE, root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", root / "BENCHMARK.json")
    return root


def test_a_new_configuration_mix_and_metric_need_no_edit(tmp_path):
    """Adding a cell is adding files and entries: the harness finds a new
    configuration, mix, limits file and metric reader by their names."""
    root = _copy_tree(tmp_path)
    pb = root / "portbench"
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cfg = json.loads((pb / "configs" / "qwen2-0.5b.json").read_text())
    cfg["model"]["num_layers"] = 2
    (pb / "configs" / "tiny-qwen.json").write_text(json.dumps(cfg))
    mix = json.loads((pb / "traffic" / "serve_chat.json").read_text())
    mix["slots"] = 8
    (pb / "traffic" / "serve_tiny.json").write_text(json.dumps(mix))
    shutil.copy(pb / "limits" / "qwen2-0.5b.serve_chat.json",
                pb / "limits" / "tiny-qwen.serve_tiny.json")
    (pb / "metrics" / "slots.serve.py").write_text(
        "def read(run):\n    return float(run.traffic['slots'])\n")
    bench["configs"].append({"name": "tiny-qwen", "source": "x",
                             "file": "portbench/configs/tiny-qwen.json",
                             "reduced": ["num_hidden_layers"], "why": "x"})
    bench["workloads"].append({"name": "tiny-qwen.serve_tiny",
                               "config": "tiny-qwen",
                               "traffic": "serve_tiny", "chips": 1,
                               "why": "x"})
    bench["per_layer"].append({"name": "slots.serve", "unit": "slots",
                               "better": "higher", "source": "host_clock",
                               "layer": "serving loop",
                               "moves": "output_tokens_per_s"})
    for m in bench["end_to_end"]:
        if "workloads" in m and "qwen2-0.5b.serve_chat" in m["workloads"]:
            m["workloads"].append("tiny-qwen.serve_tiny")
    before = {p: p.read_bytes() for p in HERE.rglob("*.py")}
    cell = C.load_cell("tiny-qwen.serve_tiny", bench, root)
    assert cell.config["model"]["num_layers"] == 2
    assert cell.traffic["slots"] == 8
    assert "slots.serve" in [m["name"] for m in cell.per_layer]
    assert {m["name"] for m in cell.end_to_end} == {
        "output_tokens_per_s", "itl_p95_ms", "setup_s"}
    run = C.Run(mode="serve", config=cell.config, traffic=cell.traffic)
    assert C.metric_reader("slots.serve", root)(run) == 8.0
    # nothing of the harness was edited
    assert before == {p: p.read_bytes() for p in HERE.rglob("*.py")}


def test_every_metric_of_benchmark_json_has_a_reader_and_every_cell_files():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert (HERE / "metrics" / f"{m['name']}.py").exists(), m["name"]
    for w in bench["workloads"]:
        cell = C.load_cell(w["name"])
        assert cell.limits and cell.per_layer and cell.end_to_end
        assert "setup_s" in [m["name"] for m in cell.end_to_end]


def _run_isolated(code: str, cwd) -> subprocess.CompletedProcess:
    return subprocess.run([sys.executable, "-c", code], cwd=cwd,
                          capture_output=True, text=True, timeout=300,
                          env={"PYTHONPATH": f"{ROOT / 'src'}:{ROOT}",
                               "PATH": "/usr/bin:/bin",
                               "HOME": str(cwd)})


def test_the_harness_loads_neither_jax_nor_the_jax_package(tmp_path):
    """Importing portbench.run and everything a run imports (a whole cell
    at smoke width on the CPU) loads no module whose top-level name is
    jax or repro (repro_torch is a name of its own)."""
    code = """
import sys, time, importlib, pkgutil
import portbench, portbench.run as R
from portbench import smoke
import torch
for m in pkgutil.walk_packages(portbench.__path__, "portbench."):
    if ".test_" not in m.name:
        importlib.import_module(m.name)
for name in ("qwen2-0.5b.serve_chat", "mamba2-780m.train_4k"):
    c = smoke.small_cell(name)
    R.run_cell(c, 5, 0.5, False, torch.device("cpu"), time.perf_counter())
assert "repro_torch" in sys.modules
print(R.forbidden_modules())
"""
    out = _run_isolated(code, tmp_path)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_forbidden_names_are_compared_whole():
    from portbench import run as R
    fakes = ("jaxlib_not", "reprox", "repro_torch_like", "repro.core.x")
    for n in fakes:
        sys.modules[n] = type(sys)(n)
    try:
        got = set(R.forbidden_modules())
        assert "repro.core.x" in got
        assert not got & {"jaxlib_not", "reprox", "repro_torch_like"}
    finally:
        for n in fakes:
            del sys.modules[n]


def test_the_reference_imports_nothing_of_the_program(tmp_path):
    code = """
import sys
sys.modules["repro_torch"] = None
sys.modules["repro"] = None
sys.modules["jax"] = None
import importlib, pkgutil
import portbench.reference as R
for m in pkgutil.walk_packages(R.__path__, "portbench.reference."):
    importlib.import_module(m.name)
print(sorted(n for n in sys.modules if n.split(".")[0] in
             ("repro_torch", "repro", "jax") and sys.modules[n] is not None))
"""
    out = _run_isolated(code, tmp_path)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip() == "[]"


def test_without_a_card_the_command_prints_no_result(tmp_path):
    out = subprocess.run(
        [sys.executable, str(HERE / "run.py"), "--workload",
         "qwen2-0.5b.train_4k", "--seed", str(2**33), "--seconds", "1"],
        cwd=tmp_path, capture_output=True, text=True, timeout=300,
        env={"PATH": "/usr/bin:/bin", "HOME": str(tmp_path),
             "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0
    assert out.stdout.strip() == ""


def test_in_a_folder_without_the_program_the_command_fails(tmp_path):
    """A checkout that holds only BENCHMARK.json and portbench/ cannot
    import the port: the command exits with an error whether or not a card
    is there (here there is none)."""
    root = _copy_tree(tmp_path)
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload",
         "qwen2-0.5b.serve_chat", "--seed", "1", "--seconds", "1"],
        cwd=root, capture_output=True, text=True, timeout=300,
        env={"PATH": "/usr/bin:/bin", "HOME": str(tmp_path)})
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    code = "import portbench.serve_cell as S; S.build"
    out = subprocess.run([sys.executable, "-c", code + "\n"
                          "from portbench import smoke\n"
                          "import torch\n"
                          "S.build(smoke.small_cell('qwen2-0.5b.serve_chat'),"
                          " 1, torch.device('cpu'))"],
                         cwd=root, capture_output=True, text=True,
                         timeout=300,
                         env={"PATH": "/usr/bin:/bin", "HOME": str(tmp_path),
                              "PYTHONPATH": str(root)})
    assert out.returncode != 0 and "repro_torch" in out.stderr
