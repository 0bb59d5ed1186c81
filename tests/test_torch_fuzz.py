"""The port's grammar fuzzer and differential harness (repro_torch.core.fuzz)
against the JAX package's, on the CPU: the same seed gives the same program
text and tape (seeds 0-199); the port's run_case finds no lane mismatch on
seeds 0-49 and accepts, rejects and runs the same lanes as JAX's run_case
on seeds 0-9; every tests/corpus case replays clean through the port with
its pinned lane list; the campaign driver writes reproducers the corpus
can replay. Seeds 0-19 on the card, through the interpreter kernel, are in
test_torch_cuda.py."""
import json
import os

import pytest

torch = pytest.importorskip("torch")


from repro.core import fuzz as JF  # noqa: E402

from repro_torch.core import fuzz as TF  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CORPUS = sorted(os.path.join(ROOT, "tests", "corpus", p)
                for p in os.listdir(os.path.join(ROOT, "tests", "corpus"))
                if p.endswith(".json"))


def _load(path):
    with open(path) as fh:
        return json.load(fh)


def test_generation_is_jax_generation():
    """The generator, repair pass and tape are pure Python on
    random.Random(seed): a seed is the same reproducer in both packages."""
    for seed in range(200):
        t, j = TF.generate_case(seed), JF.generate_case(seed)
        assert t.text == j.text, seed
        assert t.tape == j.tape, seed
    for seed in (3, 17):
        assert TF.generate_case(seed, events=11, breakage=0.4).to_json() == \
            JF.generate_case(seed, events=11, breakage=0.4).to_json()


@pytest.mark.parametrize("block", range(5))
def test_run_case_on_cpu_finds_no_mismatch(block):
    """Seeds 0-49, ten per case, every lane on the CPU."""
    accepted = 0
    for seed in range(10 * block, 10 * block + 10):
        r = TF.run_case(TF.generate_case(seed), device="cpu")
        assert r.crashed is None, (seed, r.crashed)
        assert not r.mismatches, (seed, r.mismatches)
        accepted += r.accepted
    assert accepted >= 8


@pytest.mark.parametrize("block", range(2))
def test_run_case_verdicts_and_lanes_match_jax(block):
    for seed in range(5 * block, 5 * block + 5):
        t = TF.run_case(TF.generate_case(seed), device="cpu")
        j = JF.run_case(JF.generate_case(seed))
        assert (t.accepted, t.rejected, t.crashed) == \
            (j.accepted, j.rejected, j.crashed), seed
        assert t.lanes == j.lanes, seed
        assert t.mismatches == j.mismatches == [], seed


@pytest.mark.parametrize("path", CORPUS, ids=[os.path.basename(p)
                                              for p in CORPUS])
def test_corpus_case_replays_clean(path):
    d = _load(path)
    r = TF.run_case(TF.FuzzCase.from_json(d), device="cpu")
    assert r.accepted, r.rejected
    assert not r.diverged, r.mismatches or r.crashed
    assert r.lanes == d["lanes"], (r.lanes, d["lanes"])


def test_cli_campaign_on_cpu(capsys):
    assert TF.main(["--seeds", "0-3", "--device", "cpu", "--json"]) == 0
    summary = json.loads(capsys.readouterr().out)
    assert summary["seeds"] == 4 and summary["divergences"] == 0


def test_divergence_writes_a_replayable_reproducer(tmp_path, monkeypatch):
    """A lane divergence makes the campaign exit 1 and write a shrunk
    reproducer that FuzzCase.from_json (the corpus loader) reads back.
    The divergence is simulated: any program that still holds a `call`
    "diverges"."""
    real = TF.run_case

    def fake(case, device="cuda"):
        r = real(case, device)
        if r.accepted and "call " in case.text:
            r.mismatches.append("simulated")
        return r
    monkeypatch.setattr(TF, "run_case", fake)
    seed = next(s for s in range(50) if "call " in TF.generate_case(s).text
                and fake(TF.generate_case(s), "cpu").diverged)
    rc = TF.main(["--seeds", str(seed), "--device", "cpu",
                  "--out", str(tmp_path)])
    assert rc == 1
    rec = _load(tmp_path / f"repro_{seed}.json")
    case = TF.FuzzCase.from_json(rec)
    assert case.tape == TF.generate_case(seed).tape
    assert len(case.text.splitlines()) < \
        len(rec["original_text"].splitlines())
    assert fake(case, "cpu").diverged


def test_run_case_asks_for_the_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        TF.run_case(TF.generate_case(0))
