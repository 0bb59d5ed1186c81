"""The port's serving paths on the card, at smoke width: every family's
engine with its probes, the encoder-decoder and multimodal requests, the
live lane while serving, the engine as a fleet worker, the exported probe
stage and expert parallelism on a one-card mesh. Each test holds the
launch counts of the probe kernels, the map states and the replays of the
tapes, and compares with the same work on the CPU where the card's sums
could differ. Every test is marked `cuda` and skips without a CUDA device;
this file imports no JAX:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_card_serve.py
"""
import contextlib
import os

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

import torch_card as C  # noqa: E402
from repro_torch.configs import registry as R  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402

pytestmark = pytest.mark.cuda

DENSE = "qwen2-0.5b"
LLAMA4 = "llama4-scout-17b-a16e"
LONG = 4096                   # a prefill that takes the flash kernels


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    return torch.device("cuda")


def _served(engine, reqs):
    """The served requests: the admission filter at 12 admits some of the
    requests and rejects others; each gets its 8 tokens, in the vocab."""
    served = [r for r in reqs if not r.rejected]
    assert 0 < len(served) < len(reqs)
    assert all(len(r.out) == 8 for r in served)
    assert all(0 <= t < engine.cfg.vocab_size for r in served for t in r.out)
    return served


@pytest.mark.parametrize("arch", [DENSE, LLAMA4, "mamba2-780m",
                                  "jamba-v0.1-52b", "qwen2-vl-72b"])
def test_family_serves_on_the_card(cuda, arch):
    """8 requests, 4 slots, the family's serving probes on the fused lane:
    one tensor_stats launch and no other device operation a collected
    event, the events a step the family's sites, the maps' counts (one
    moe.load a MoE layer, one ssm.out rms a Mamba layer, one logits record
    a step), the last tape's scan and vectorized replays the fused lane's
    maps. The same model on the CPU from the same weights (f32, TF32 off):
    the same admissions, the prefill logits within 1e-4; the families'
    tokens equal and maps bit for bit (the logits records' stat lanes
    within 2e-5), qwen2's layer counters equal."""
    from repro_torch.core.maps import n_hash_items
    from repro_torch.core.runtime import to_numpy
    from repro_torch.models import registry as MR
    cfg = R.smoke(arch)
    with C.tf32_off():
        engine, reqs = C.serve(cfg, cuda)
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        with C.emits_counted() as emits:
            engine.submit_all(reqs)
        torch.cuda.synchronize()
        launches = ops.launch_counts()
        served = _served(engine, reqs)
        steps, maps = engine.step_count, to_numpy(engine.maps)
        assert all(launches[k] for k in C.SERVING_KERNELS), launches
        assert launches["tensor_stats"] == emits["events"] == engine.events
        assert emits["work"] == []
        assert engine.events == steps * C.events_per_step(cfg)
        assert int(maps["sv_logits_rb"]["head"][0]) == steps
        n_moe = C.layers_of(cfg, lambda j: cfg.ffn_kind(j) == "moe")
        if n_moe:
            assert int(maps["load_hist"]["bins"].sum()) == n_moe * steps
        n_ssm = C.layers_of(cfg, lambda j: cfg.block_kind(j) == "mamba")
        if n_ssm:
            assert int(maps["ssm_rms_hist"]["bins"].sum()) == n_ssm * steps
            toks = torch.randint(0, cfg.vocab_size, (1, LONG), device=cuda,
                                 generator=torch.Generator(cuda)
                                 .manual_seed(C.SEED))
            long = MR.prefill_fn(engine.params, {"tokens": toks},
                                 MR.make_cache(cfg, 1, LONG, torch.float32,
                                               cuda), cfg)[0]
            assert tuple(long.shape) == (1, LONG, cfg.padded_vocab)
            assert bool(torch.isfinite(long).all())
        C.replay_tape(engine.runtime, engine.last_tape, engine.maps)

        cpu, reqs_cpu = C.serve(cfg, "cpu", C.to_device(engine.params, "cpu"))
        cpu.submit_all(reqs_cpu)
        assert [r.rejected for r in reqs] == [r.rejected for r in reqs_cpu]
        if arch == DENSE:
            got = to_numpy(cpu.maps)
            assert maps["sv_layer_counts"]["values"][:cfg.num_layers] \
                .tolist() == [steps] * cfg.num_layers
            for m in ("sv_layer_counts", "sv_logits_rb"):
                for f in got[m]:
                    if m != "sv_logits_rb" or f == "head":
                        assert np.array_equal(maps[m][f], got[m][f]), m
            assert n_hash_items(maps["sv_key_hash"]) == \
                n_hash_items(got["sv_key_hash"])
            assert sum(n_hash_items(maps["sv_key_hash"]).values()) == \
                steps * cfg.num_layers
        else:
            assert [r.out for r in reqs] == [r.out for r in reqs_cpu]
            C.maps_card_vs_cpu(engine.maps, cpu.maps, "sv_logits_rb")
        prompt = served[0].prompt
        logits = [MR.prefill_fn(p, {"tokens": torch.tensor([prompt],
                                                           device=dev)},
                                MR.make_cache(cfg, 1, 128, torch.float32,
                                              dev), cfg)[0]
                  for p, dev in ((engine.params, cuda),
                                 (cpu.params, torch.device("cpu")))]
        C.logits_close(*logits)


def _encdec_run(cfg, params, batch, steps, device):
    """One probed prefill (ENCDEC_PROBES, through make_prefill_step) of
    `batch`, then `steps` greedy probed decode steps from its cache."""
    from repro_torch.core.runtime import BpftimeRuntime
    from repro_torch.launch import serve as L
    from repro_torch.models import registry as MR
    from repro_torch.serve.steps import make_decode_step, make_prefill_step
    rt = BpftimeRuntime()
    L.attach_serve_probes(rt, L.family_probes(cfg))
    prefill, decode = make_prefill_step(cfg, rt), make_decode_step(cfg, rt)
    maps = rt.init_device_maps(device)
    cache = MR.make_cache(cfg, batch["tokens"].shape[0], 128, torch.float32,
                          device, enc_seq=batch["enc_embeds"].shape[1])
    logits, cache, maps = prefill(params, batch, cache, maps)
    run = {"rt": rt, "prefill": prefill, "decode": decode, "logits": logits,
           "maps_prefill": {n: {f: a.clone() for f, a in st.items()}
                            for n, st in maps.items()},
           "events": [prefill.last[0].shape[0]]}
    nxt = logits[:, -1, :cfg.vocab_size].argmax(-1)[:, None]
    toks = [nxt[:, 0].tolist()]
    for step in range(steps):
        t, _, cache, maps = decode(params, nxt, cache, maps, step)
        run["events"].append(decode.last[0].shape[0])
        nxt = t[:, None].long()
        toks.append(t.tolist())
    run.update(maps=maps, tokens=toks)
    return run


def test_encdec_serves_on_the_card(cuda):
    """seamless-m4t-medium: 2 requests of 4096 frames (the f32 flash
    forward, non-causal, once an encoder layer) and 8 tokens, a probed
    prefill and 4 probed decode steps. 1 + enc_layers events in the
    prefill and 1 a step, one tensor_stats launch an event, the maps'
    counts, the prefill's and the last step's tapes replayed in every
    mode; tokens, maps and prefill logits equal to the CPU's as in
    test_family_serves_on_the_card."""
    from repro_torch.core.maps import n_hash_items
    from repro_torch.core.runtime import to_numpy
    cfg = R.smoke("seamless-m4t-medium")
    g = torch.Generator().manual_seed(C.SEED)
    batch = {"enc_embeds": torch.randn(2, LONG, cfg.d_model, generator=g),
             "tokens": torch.randint(0, cfg.vocab_size, (2, 8), generator=g)}
    params = C.init_params(cfg, cuda)
    with C.tf32_off():
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        run = _encdec_run(cfg, params, C.to_device(batch, cuda), 4, cuda)
        torch.cuda.synchronize()
        launches = ops.launch_counts()
        ev = run["events"]
        assert ev == [1 + cfg.enc_layers] + [1] * 4
        assert all(launches[k] for k in C.SERVING_KERNELS), launches
        assert launches["tensor_stats"] == sum(ev)
        assert launches["flash_fwd"] == cfg.enc_layers
        m = to_numpy(run["maps"])
        assert int(m["ed_rms_hist"]["bins"].sum()) == cfg.enc_layers
        assert int(m["ed_in_rms_hist"]["bins"].sum()) == 1
        assert sorted((int(k), v) for k, v in
                      n_hash_items(m["ed_layer_hash"]).items()) == \
            [(i, 1) for i in range(cfg.enc_layers)]
        assert int(m["ed_logits_rb"]["head"][0]) == 4
        assert all(0 <= t < cfg.vocab_size for ts in run["tokens"]
                   for t in ts)
        C.replay_tape(run["rt"], run["prefill"].last[:3],
                      run["maps_prefill"])
        C.replay_tape(run["rt"], run["decode"].last[:3], run["maps"])
        cpu = _encdec_run(cfg, C.to_device(params, "cpu"), batch, 4, "cpu")
    assert run["tokens"] == cpu["tokens"]
    C.maps_card_vs_cpu(run["maps"], cpu["maps"], "ed_logits_rb")
    C.logits_close(run["logits"], cpu["logits"])


def _multimodal(cfg, params, n_text, steps, device):
    """One request of the smoke frontend's 2 x 4 patches and n_text tokens
    with M-RoPE grid ids, prefilled through registry.prefill_fn (launches
    counted), then `steps` probed decode steps (launches counted)."""
    from repro_torch.core.runtime import BpftimeRuntime
    from repro_torch.launch import serve as L
    from repro_torch.models import layers as ML, registry as MR
    from repro_torch.serve.steps import make_decode_step
    g = torch.Generator().manual_seed(C.SEED)
    S = cfg.frontend_tokens + n_text
    batch = {"embeds": torch.randn(1, cfg.frontend_tokens, cfg.d_model,
                                   generator=g),
             "tokens": torch.randint(0, cfg.vocab_size, (1, n_text),
                                     generator=g),
             "positions": ML.mrope_grid_positions(2, 4, n_text, 1)}
    ops.reset_launch_counts()
    logits, cache = MR.prefill_fn(params, C.to_device(batch, device),
                                  MR.make_cache(cfg, 1, S + steps,
                                                torch.float32, device), cfg)
    out = {"logits": logits, "prefill": ops.launch_counts()}
    rt = BpftimeRuntime()
    L.attach_serve_probes(rt, L.family_probes(cfg))
    decode = make_decode_step(cfg, rt)
    maps = rt.init_device_maps(device)
    nxt = logits[:, -1, :cfg.vocab_size].argmax(-1)[:, None]
    toks, events = [nxt[:, 0].tolist()], 0
    ops.reset_launch_counts()
    for step in range(steps):
        t, _, cache, maps = decode(params, nxt, cache, maps, step)
        events += decode.last[0].shape[0]
        nxt = t[:, None].long()
        toks.append(t.tolist())
    out.update(rt=rt, decode=decode, maps=maps, tokens=toks, events=events,
               launches=ops.launch_counts())
    return out


def test_vlm_multimodal_request_on_the_card(cuda):
    """qwen2-vl-72b: a 4096-position request (8 patches with grid ids and
    4088 tokens; the flash forward once a layer in the prefill), then 4
    probed decode steps: one tensor_stats launch an event, the last tape
    replayed in every mode; tokens, maps and prefill logits equal to the
    CPU's as in test_family_serves_on_the_card."""
    cfg = R.smoke("qwen2-vl-72b")
    params = C.init_params(cfg, cuda)
    n_text = LONG - cfg.frontend_tokens
    with C.tf32_off():
        card = _multimodal(cfg, params, n_text, 4, cuda)
        torch.cuda.synchronize()
        assert tuple(card["logits"].shape) == (1, LONG, cfg.padded_vocab)
        assert card["prefill"]["flash_fwd"] == cfg.num_layers
        assert card["events"] == 4 * C.events_per_step(cfg)
        assert all(card["launches"][k] for k in C.SERVING_KERNELS)
        assert card["launches"]["tensor_stats"] == card["events"]
        assert all(0 <= t < cfg.vocab_size for ts in card["tokens"]
                   for t in ts)
        C.replay_tape(card["rt"], card["decode"].last[:3], card["maps"])
        cpu = _multimodal(cfg, C.to_device(params, "cpu"), n_text, 4, "cpu")
    assert card["tokens"] == cpu["tokens"]
    C.maps_card_vs_cpu(card["maps"], cpu["maps"], "sv_logits_rb")
    C.logits_close(card["logits"], cpu["logits"])


def _recording(engine, steps, part):
    """Wraps the engine's probe stage: every probed step's (part, rows,
    maps in, aux, maps out, table generation) goes to `steps`."""
    rt = engine.runtime
    stage = rt.probe_stage

    def recording(rows, maps, aux, mode=None):
        out = stage(rows, maps, aux, mode=mode)
        steps.append((part[0], rows, {k: v for k, v in maps.items()
                                      if k != "__live_table__"}, aux,
                      out[0], rt.table_generation))
        return out
    rt.probe_stage = recording


def test_live_lane_while_serving_on_the_card(cuda):
    """Three LIVE_PROBES hot-attached on the table lane (a vec, a
    sequential and a vec slot) to the running decode step after the first
    requests, one detached and a fourth attached with promote=True, then
    promoted to the fused lane at a sync. The decode step is never
    rebuilt; the interpreter launches once a probed step; every probed
    step's maps equal a replay through the same programs on the fused lane
    and one through the table lane with the table of the generation it
    ran; the maps count every step of their parts; one probed decode step
    on a side stream gives the default stream's tokens, tape and maps."""
    from repro_torch.launch import serve as L
    from repro_torch.serve.steps import make_decode_step
    cfg = R.smoke(DENSE)
    rt, pids = C.runtime(cfg, live="armed")
    engine, _ = C.serve(cfg, cuda, rt=rt)
    decode = engine._decode
    steps, part = [], [1]
    _recording(engine, steps, part)
    reqs_a = L.make_requests(8, 8, cfg.vocab_size, C.SEED)
    reqs_b = L.make_requests(8, 8, cfg.vocab_size, C.SEED + 1)
    ops.reset_launch_counts()
    engine.submit_all(reqs_a[:4])                 # part 1: nothing live
    part[0] = 2
    links = [rt.attach(pids[name], target, mode="table", promote=False)
             for name, _, _, target in L.LIVE_PROBES[:3]]
    engine.maps = rt.sync_live_table(engine.maps)
    assert [lk.lane for lk in links] == ["table"] * 3
    assert rt.live.host["vec"][:3].tolist() == [1, 0, 1]
    engine.submit_all(reqs_a[4:])                 # part 2: three on the table
    part[0] = 3
    rt.detach(links[2])
    lk_hash = rt.attach(pids["lv_hash"], "uprobe:block", mode="table",
                        promote=True)
    engine.maps = rt.sync_live_table(engine.maps)
    engine.submit_all(reqs_b[:4])                 # part 3: hash on the table
    rt.enable_promotion(lambda: make_decode_step(cfg, rt), (),
                        background=False)
    assert lk_hash.promotion_state == "ready"
    engine.maps = rt.sync_live_table(engine.maps)
    part[0] = 4
    engine.submit_all(reqs_b[4:])                 # part 4: hash fused
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    del rt.probe_stage
    assert engine._decode is decode
    assert (lk_hash.lane, lk_hash.promotion_state) == ("fused", "fused")
    probed = {k: sum(1 for s in steps if s[0] == k) for k in (1, 2, 3, 4)}
    assert all(probed.values()) and launches["table_interp"] == len(steps)
    assert all(launches[k] for k in C.SERVING_KERNELS), launches
    # every probed step again through the programs on the fused lane
    rf, fp = C.runtime(cfg, live="loaded")
    changes = {2: [("attach", "lv_count"), ("attach", "lv_rb"),
                   ("attach", "lv_hist")],
               3: [("detach", "lv_hist"), ("attach", "lv_hash")]}
    target = {n: t for n, _, _, t in L.LIVE_PROBES}
    flinks, cur = {}, 1
    for k, rows, maps_in, aux, out, _ in steps:
        while cur < k:
            cur += 1
            for op, name in changes.get(cur, []):
                if op == "attach":
                    flinks[name] = rf.attach(fp[name], target[name],
                                             mode="fused")
                else:
                    rf.detach(flinks.pop(name))
        assert C.differing(out, rf.probe_stage(rows, maps_in, aux)[0]) == \
            [], k
    # and through the table lane, each with its generation's table
    rr, rp = C.runtime(cfg, live="armed")
    assert rr.live.spec_key == rt.live.spec_key
    promoted = False
    for k, rows, maps_in, aux, out, gen in steps:
        if k == 4 and not promoted:
            rr.attach(rp["lv_hash"], target["lv_hash"], mode="fused")
            promoted = True
        want, _ = rr.probe_stage(rows, {**maps_in, "__live_table__":
                                        rt.live_table_at(gen, cuda)}, aux)
        assert C.differing(out, want) == [], (k, gen)
    assert int(engine.maps["lv_logits_rb"]["head"][0]) == \
        probed[2] + probed[3] + probed[4]
    assert int(engine.maps["lv_key_hash"]["values"].sum()) == \
        (probed[3] + probed[4]) * cfg.num_layers

    # one probed decode step on the default stream and on a side stream
    toks = torch.ones((engine.slots, 1), dtype=torch.int64, device=cuda)

    def one():
        nxt, logits, _, maps = decode(engine.params, toks, engine.cache,
                                      engine.maps, engine.step_count)
        return nxt, decode.last[0].clone(), maps
    a = one()
    torch.cuda.synchronize()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    before = ops.launch_counts()
    with torch.cuda.stream(side):
        b = one()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    ran = {k: v - before[k] for k, v in ops.launch_counts().items()}
    assert all(ran[k] for k in ("tensor_stats", "hash_fetch_add_batch",
                                "table_interp")), ran
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert C.differing(b[2], a[2]) == []


def test_fleet_worker_on_the_card(cuda, tmp_path):
    """The engine as shm worker w0 with the live lane on: the port's daemon
    CLI queues an attach of LIVE_PROBES[0] (table lane, not promoted)
    after 4 requests and a detach of the link status.json reports after 4
    more, then 2 more are served. The decode step is never rebuilt; both
    requests apply without error; status.json shows the program in a live
    slot, then not; the interpreter launches once a probed step; the
    program counts on exactly the steps it was attached; every probed step
    equals a replay on the fused lane; the region holds every map with an
    even seq, bit for bit the engine's."""
    from repro_torch.core import daemon as D, loader, shm as SH
    from repro_torch.core.maps import MapKind, MapSpec
    from repro_torch.core.runtime import to_numpy
    from repro_torch.launch import serve as L
    cfg = R.smoke(DENSE)
    root = str(tmp_path / "shm")
    engine, _ = C.serve(cfg, cuda, rt=C.runtime(cfg, live="armed")[0],
                        shm_dir=root, worker_id="w0")
    rt, decode = engine.runtime, engine._decode
    steps, part, applied = [], [1], []
    _recording(engine, steps, part)
    poll = rt.poll_control

    def recording_poll():
        got = poll()
        applied.extend(got or [])
        return got
    rt.poll_control = recording_poll
    name, text, (mname, kind, n, w), target = L.LIVE_PROBES[0]
    obj = loader.build_object(name, text, [MapSpec(mname, MapKind(kind), n,
                                                   rec_width=w)],
                              "uprobe", attach_to=target)
    obj_path = tmp_path / f"{name}.json"
    obj_path.write_text(obj.to_json())
    daemon = SH.ShmRegion.attach(root, worker_id="w0")
    reqs = L.make_requests(10, 8, cfg.vocab_size, C.SEED + 2)
    ops.reset_launch_counts()
    interp = [0]
    engine.submit_all(reqs[:4])                 # part 1: nothing live
    interp.append(ops.launch_counts()["table_interp"])
    part[0] = 2
    assert D.main([root, "attach", str(obj_path), "--mode", "table",
                   "--no-promote", "--worker", "w0"]) == 0
    engine.submit_all(reqs[4:8])                # part 2: the program live
    interp.append(ops.launch_counts()["table_interp"])
    status_on = daemon.read_status()
    links = [k for k, v in status_on["promotions"].items()
             if v["lane"] == "table"]
    assert len(links) == 1
    part[0] = 3
    assert D.main([root, "detach", links[0], "--worker", "w0"]) == 0
    engine.submit_all(reqs[8:])                 # part 3: detached
    interp.append(ops.launch_counts()["table_interp"])
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    status_off = daemon.read_status()
    del rt.probe_stage, rt.poll_control
    assert engine._decode is decode
    assert [(a["op"], a.get("error")) for a in applied] == \
        [("load_attach", None), ("detach", None)]
    assert status_on["live_slots"].get("0") == name
    assert status_off["live_slots"].get("0") is None
    assert links[0] not in status_off["links"]
    assert not rt.live.host["active"].any()
    probed = {k: sum(1 for s in steps if s[0] == k) for k in (1, 2, 3)}
    assert all(probed.values())
    assert {k: interp[k] - interp[k - 1] for k in (1, 2, 3)} == probed
    assert all(launches[k] for k in C.SERVING_KERNELS), launches
    for k, rows, maps_in, aux, out, _ in steps:
        moved = int(out[mname]["values"].sum()
                    - maps_in[mname]["values"].sum())
        assert moved == (cfg.num_layers if k == 2 else 0), k
    rf, fp = C.runtime(cfg, live="loaded")
    link, detached = None, False
    for k, rows, maps_in, aux, out, _ in steps:
        if k == 2 and link is None and not detached:
            link = rf.attach(fp[name], target, mode="fused")
        if k == 3 and link is not None:
            rf.detach(link)
            link, detached = None, True
        assert C.differing(out, rf.probe_stage(rows, maps_in, aux)[0]) == \
            [], k
    final = to_numpy(engine.maps)
    region = SH.ShmRegion.attach(root, mode="r", worker_id="w0")
    for m, st in final.items():
        got, seq, _ = region.snapshot_device_meta(m)
        assert seq > 0 and seq % 2 == 0, (m, seq)
        for f, a in st.items():
            assert np.array_equal(got[f], a), (m, f)


def _decode_tapes(cfg, device):
    """The serving of `serve` with every probed decode step's tape, the
    maps it started from, its step and the fused lane's maps recorded."""
    engine, reqs = C.serve(cfg, device)
    dec, tapes = engine._decode, []

    def recording(params, tokens, cache, maps, step):
        out = dec(params, tokens, cache, maps, step)
        recording.last = dec.last             # the engine reads it
        if dec.last is not None:
            rows, maps_in, st, _ = dec.last
            tapes.append((rows, maps_in, st, out[3]))
        return out
    recording.last = None
    engine._decode = recording
    engine.submit_all(reqs)
    torch.cuda.synchronize()
    assert tapes and len(tapes) == engine.step_count
    return tapes


def test_aot_step_on_the_card(cuda, tmp_path):
    """The serving runtime's probe stage booted through aot_step on the
    card: a fresh runtime misses and stores, another hits; both run every
    decode tape bit for bit as the eager fused lane did, each call one
    hash and one ring-buffer launch (the probe kernels as custom operators)
    and no other probe kernel. A corrupted entry is detected, dropped and
    stored again, then hit; a scan-lane stage runs eagerly, unexportable,
    storing nothing."""
    from repro_torch.core import faults as F, jit as J
    cfg = R.smoke(DENSE)
    tapes = _decode_tapes(cfg, cuda)
    key = ("card test", tapes[0][0].shape[0])

    def boot(cache_dir, mode=None):
        rt, _ = C.runtime(cfg)
        cache = rt.enable_artifact_cache(str(cache_dir))
        args = (tapes[0][0], tapes[0][1], J.make_aux(time_ns=tapes[0][2],
                                                     device=cuda))
        step, hit = rt.aot_step(
            lambda: (lambda r, m, a: rt.probe_stage(r, m, a, mode=mode)),
            args, extra_key=key + ((mode,) if mode else ()))
        return rt, cache, step, hit

    for k, want_hit in enumerate((False, True)):
        rt, cache, step, hit = boot(tmp_path / "cache")
        assert hit == want_hit and rt.last_export_error is None
        assert cache.counters["stores" if k == 0 else "hits"] == 1
        for rows, maps_in, st, want in tapes:
            ops.reset_launch_counts()
            got, _ = step(rows, maps_in, J.make_aux(time_ns=st, device=cuda))
            torch.cuda.synchronize()
            assert C.differing(got, want) == []
            assert ops.launch_counts() == {
                **{n: 0 for n in ops.KERNELS}, "hash_fetch_add_batch": 1,
                "ringbuf_emit_batch": 1}
    ops.reset_launch_counts()
    rt.probe_stage(tapes[0][0], tapes[0][1],
                   J.make_aux(time_ns=tapes[0][2], device=cuda))
    assert ops.launch_counts()["hash_fetch_add_batch"] == 1
    assert ops.launch_counts()["ringbuf_emit_batch"] == 1

    counters = []
    for k in range(3):
        with F.plan(F.FaultPlan(seed=0, rates={"corrupt_artifact": 1.0})) \
                if k == 0 else contextlib.nullcontext():
            rt, cache, step, hit = boot(tmp_path / "drill")
        counters.append(dict(cache.counters))
        assert hit == (k == 2), counters
        rows, maps_in, st, want = tapes[0]
        got, _ = step(rows, maps_in, J.make_aux(time_ns=st, device=cuda))
        assert C.differing(got, want) == []
    assert counters[1]["corrupt"] == 1 and counters[1]["stores"] == 1

    rt, cache, step, hit = boot(tmp_path / "scan", mode="scan")
    assert not hit and cache.counters["unexportable"] == 1
    assert not cache.ls()
    rows, maps_in, st, want = tapes[0]
    assert C.differing(step(rows, maps_in, J.make_aux(
        time_ns=st, device=cuda))[0], want) == []


def test_expert_parallel_on_a_one_card_mesh(cuda):
    """llama4-scout on a (1, 1) mesh (NCCL at world size 1) with
    REPRO_MOE_EP=1: a probed prefill of 4 prompts of 16 tokens and 8
    probed decode steps, then a 4096-token prefill (the flash forward once
    an attention layer): logits and every map state bit for bit the same
    steps with the switch off, one expert gather a MoE layer a step and
    none with the switch off, every serving kernel launched."""
    from repro_torch.core.runtime import BpftimeRuntime, to_numpy
    from repro_torch.dist import expert_parallel as EP, sharding as SH
    from repro_torch.launch import serve as L
    from repro_torch.models import registry as MR
    from repro_torch.serve.steps import make_decode_step, make_prefill_step
    cfg = R.smoke(LLAMA4)
    params = C.init_params(cfg, cuda)
    n_moe = C.layers_of(cfg, lambda j: cfg.ffn_kind(j) == "moe")
    rng = np.random.default_rng(C.SEED)
    prompts = torch.as_tensor(rng.integers(0, cfg.vocab_size, (4, 16)),
                              device=cuda)
    long_toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, (1, LONG)),
                                device=cuda)

    def switch(on):
        os.environ["REPRO_MOE_EP"] = "1" if on else "0"

    def decode_run(on, mesh):
        rt = BpftimeRuntime()
        L.attach_serve_probes(rt, L.family_probes(cfg))
        prefill = make_prefill_step(cfg, rt)
        decode = make_decode_step(cfg, rt, probe_mode="fused")
        maps = rt.init_device_maps(cuda)
        cache = MR.make_cache(cfg, 4, 16 + 8 + 1, torch.float32, cuda)
        switch(on)
        logits_all, maps_all, gathers = [], [], []
        with SH.use_mesh(mesh):
            logits, cache, maps = prefill(params, {"tokens": prompts},
                                          cache, maps)
            tok = torch.argmax(logits[:, -1, :cfg.vocab_size], -1)[:, None]
            for i in range(8):
                g0 = EP.GATHERS
                nxt, logits, cache, maps = decode(params, tok, cache, maps,
                                                  i + 1)
                gathers.append(EP.GATHERS - g0)
                tok = nxt[:, None].to(torch.int64)
                logits_all.append(logits.clone())
                maps_all.append(to_numpy(maps))
        return logits_all, maps_all, gathers

    def long_run(on, mesh):
        switch(on)
        g0 = EP.GATHERS
        with SH.use_mesh(mesh):
            logits = MR.prefill_fn(params, {"tokens": long_toks},
                                   MR.make_cache(cfg, 1, LONG, torch.float32,
                                                 cuda), cfg)[0]
        return logits, EP.GATHERS - g0

    was = os.environ.get("REPRO_MOE_EP")
    try:
        with C.one_card_mesh() as mesh:
            off = decode_run(False, mesh)
            ops.reset_launch_counts()
            on = decode_run(True, mesh)
            long_on, long_gathers = long_run(True, mesh)
            torch.cuda.synchronize()
            launches = ops.launch_counts()
            long_off, _ = long_run(False, mesh)
    finally:
        if was is None:
            os.environ.pop("REPRO_MOE_EP", None)
        else:
            os.environ["REPRO_MOE_EP"] = was
    for i, (a, b) in enumerate(zip(on[0], off[0])):
        assert C.bits_equal(a, b), i
    for i, (a, b) in enumerate(zip(on[1], off[1])):
        assert all(np.array_equal(a[m][f], x) for m, st in b.items()
                   for f, x in st.items()), i
    assert C.bits_equal(long_on, long_off)
    assert on[2] == [n_moe] * 8 and long_gathers == n_moe
    assert not any(off[2])
    assert all(launches[k] for k in C.SERVING_KERNELS), launches
    assert launches["flash_fwd"] == C.layers_of(
        cfg, lambda j: cfg.block_kind(j) == "attn")
    assert launches["tensor_stats"] >= 8 * C.events_per_step(cfg)
