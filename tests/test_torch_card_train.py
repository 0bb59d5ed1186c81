"""The port's training paths on the card, at smoke width and seq 4096 (the
flash kernels' path): every family trained at its preset with the training
probes, the int8-compressed step, and run_training's checkpoints restored
plainly and onto a one-card mesh. Every test is marked `cuda` and skips
without a CUDA device; this file imports no JAX:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_card_train.py
"""
import json
import math
import os

import pytest

torch = pytest.importorskip("torch")

import torch_card as C  # noqa: E402
from repro_torch.configs import registry as R  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402

pytestmark = pytest.mark.cuda

DENSE = "qwen2-0.5b"
SEQ, STEPS = 4096, 3
PARAM_TOL = 3e-5              # test_family_train_step_on_the_card_equals_the_cpu
# arch -> (global batch, microbatch, rows of step 1 with M-RoPE grid ids)
RUNS = {DENSE: (4, 2, False), "mamba2-780m": (4, 0, False),
        "seamless-m4t-medium": (2, 0, False), "qwen2-vl-72b": (2, 1, True),
        "llama4-scout-17b-a16e": (1, 0, False)}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    return torch.device("cuda")


def _train(cfg, arch, rt, device):
    """STEPS steps of `cfg` at `arch`'s preset on RUNS[arch]'s batch: as
    run_training where the preset is its TrainConfig (AdamW, f32), else
    through the functions it calls, in its loop. Returns (state, history,
    microbatches a step)."""
    from repro_torch.configs.base import ShapeConfig, TrainConfig
    from repro_torch.data.pipeline import SyntheticDataset
    from repro_torch.launch import presets, train as T
    from repro_torch.models import layers as ML
    from repro_torch.train.train_step import init_train_state, make_train_step
    batch, micro, grid = RUNS[arch]
    tcfg = presets.train_config(arch, microbatch=micro, warmup=10,
                                total_steps=STEPS)
    n_mb = batch // micro if micro else 1
    if tcfg == TrainConfig(microbatch=micro, remat=True, warmup=10,
                           total_steps=STEPS):
        state, hist = T.run_training(
            arch, steps=STEPS, smoke=True, runtime=rt, probe_mode="fused",
            seq_len=SEQ, batch=batch, microbatch=micro, log_every=0,
            device=device)
        return state, hist, n_mb
    data = SyntheticDataset(cfg, ShapeConfig("card", SEQ, batch, "train"),
                            tcfg, runtime=rt)
    state = init_train_state(cfg, tcfg, rt, torch.Generator(device=device)
                             .manual_seed(C.SEED), device)
    step = make_train_step(cfg, tcfg, rt, probe_mode="fused")
    hist = []
    for s in range(STEPS):
        rt.poll_control()
        state["maps"] = rt.sync_live_table(state["maps"])
        rt.syscalls.invoke("sys_step_begin", [s], impl=lambda: None)
        b = data.next()
        if grid and s == 1:
            lead = b["tokens"].shape[:-1]
            pos = ML.mrope_grid_positions(2, 4, b["tokens"].shape[-1],
                                          math.prod(lead))
            b["positions"] = pos.reshape(tuple(lead) + pos.shape[1:])
        state, m = step(state, b)
        hist.append({k: float(v) for k, v in m.items()})
        rt.syscalls.invoke("sys_step_end", [s + 1, 0], impl=lambda: None)
    return state, hist, n_mb


@pytest.mark.parametrize("arch", list(RUNS))
def test_family_trains_on_the_card(cuda, arch):
    """3 steps at the family's preset with TRAIN_PROBES on the fused lane:
    no step vetoed, losses and gradient norms finite; one tensor_stats
    launch and no other device operation a collected event; the events a
    step the layers' a microbatch (an encoder and a decoder layer each in
    the encoder-decoder family), a loss a microbatch and the gradient
    norm; the hash and ring-buffer kernels launched (qwen2: every kernel
    but the interpreter); the layer counters one a layer a microbatch, the
    loss ring and the gradient-norm histogram every event; the flash
    kernels twice (forward and remat recompute) and once (backward) an
    attention layer a microbatch; the last tape replayed in every mode."""
    from repro_torch.core.runtime import to_numpy
    cfg = R.smoke(arch)
    tape = {}
    rt, events = C.train_runtime(cfg, tape)
    ops.reset_launch_counts()
    with C.emits_counted() as emits:
        state, hist, n_mb = _train(cfg, arch, rt, cuda)
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    assert len(hist) == STEPS and not any(h["vetoed"] for h in hist)
    assert all(math.isfinite(h["loss"]) and math.isfinite(h["grad_norm"])
               for h in hist)
    assert launches["tensor_stats"] == emits["events"] == sum(events)
    assert emits["work"] == []
    encdec = cfg.family == "encdec"
    layers = cfg.enc_layers + cfg.dec_layers if encdec else cfg.num_layers
    assert events == [layers * n_mb + n_mb + 1] * STEPS
    kernels = [k for k in ops.KERNELS if k != "table_interp"] \
        if arch == DENSE else ["hash_fetch_add_batch", "ringbuf_emit_batch"]
    assert all(launches[k] for k in kernels), launches
    maps = to_numpy(state["maps"])
    n_idx = cfg.enc_layers if encdec else cfg.num_layers
    counts = maps["tr_layer_counts"]["values"]
    assert counts[:n_idx].tolist() == [(1 + encdec) * n_mb * STEPS] * n_idx
    assert not counts[n_idx:].any()
    assert int(maps["tr_loss_rb"]["head"][0]) == n_mb * STEPS
    assert int(maps["tr_gnorm_hist"]["bins"].sum()) == STEPS
    attn = layers if encdec else \
        C.layers_of(cfg, lambda j: cfg.block_kind(j) == "attn")
    assert (launches["flash_fwd"], launches["flash_bwd"]) == \
        (2 * attn * n_mb * STEPS, attn * n_mb * STEPS)
    C.replay_tape(rt, tape["last"], state["maps"])


def test_int8_step_on_the_card(cuda):
    """One training step with grad_compression="int8" (seq 4096, batch 4
    in microbatches of 2, TRAIN_PROBES): the step calls int8_roundtrip
    once, on the card, and its output is bit for bit the same function of
    CPU copies of its input; loss and gradient norm finite, not vetoed;
    every kernel but the interpreter launched."""
    from repro_torch.configs.base import ShapeConfig, TrainConfig
    from repro_torch.data.pipeline import SyntheticDataset
    from repro_torch.optim import tree_leaves
    from repro_torch.train import train_step as TS
    cfg = R.smoke(DENSE)
    rt, _ = C.train_runtime(cfg)
    tcfg = TrainConfig(microbatch=2, remat=True, warmup=10, total_steps=3,
                       grad_compression="int8")
    state = TS.init_train_state(cfg, tcfg, rt, torch.Generator(device=cuda)
                                .manual_seed(C.SEED), cuda)
    b = SyntheticDataset(cfg, ShapeConfig("int8", SEQ, 4, "train"), tcfg,
                         seed=C.SEED).next()
    roundtrip, calls = TS.int8_roundtrip, []

    def recording(tree):
        out = roundtrip(tree)
        calls.append((tree, out))
        return out
    TS.int8_roundtrip = recording
    ops.reset_launch_counts()
    try:
        _, m = TS.make_train_step(cfg, tcfg, rt, probe_mode="fused")(state,
                                                                      b)
    finally:
        TS.int8_roundtrip = roundtrip
    assert len(calls) == 1
    assert all(v for k, v in ops.launch_counts().items()
               if k != "table_interp"), ops.launch_counts()
    assert math.isfinite(float(m["loss"])) and \
        math.isfinite(float(m["grad_norm"])) and not int(m["vetoed"])
    grads, card = calls[0]
    for g, c in zip(tree_leaves(grads), tree_leaves(card)):
        assert c.device.type == "cuda"
        assert C.bits_equal(c, roundtrip(g.cpu())), tuple(g.shape)


def test_checkpoint_on_the_card(cuda, tmp_path):
    """run_training for 2 steps as shm worker t0 with a checkpoint after
    each (seq 4096, batch 4 in microbatches of 2), every kernel but the
    interpreter launched: t0's published maps are the final state's; step_1 restored into a fresh state on the card and
    step 2 taken again with the same batch gives step_2's files (every
    parameter and optimizer leaf bit for bit, or within 3e-5 where a sum
    is not repeatable on the card; the rest bit for bit); step_1 restored
    again onto a (1, 1) mesh (NCCL at world size 1) with shardings from
    spec_for has every leaf's full_tensor() bit for bit the plain
    restore."""
    from repro_torch.ckpt import checkpoint as CK
    from repro_torch.configs.base import ShapeConfig, TrainConfig
    from repro_torch.core.runtime import to_numpy
    from repro_torch.core.shm import ShmRegion
    from repro_torch.data.pipeline import SyntheticDataset
    from repro_torch.launch import train as T
    from repro_torch.launch.specs import state_shardings
    from repro_torch.optim import tree_leaves
    from repro_torch.train.train_step import init_train_state, make_train_step
    cfg = R.smoke(DENSE)
    shm, ck = str(tmp_path / "shm"), str(tmp_path / "ckpt")
    os.makedirs(ck)
    rt, _ = C.train_runtime(cfg)
    ops.reset_launch_counts()
    state, _ = T.run_training(
        DENSE, steps=2, smoke=True, runtime=rt, probe_mode="fused",
        seq_len=SEQ, batch=4, microbatch=2, log_every=0, shm_dir=shm,
        worker_id="t0", ckpt_dir=ck, save_every=1, device=cuda)
    assert CK.latest(ck) == 2 and os.path.isdir(os.path.join(ck, "step_1"))
    assert all(v for k, v in ops.launch_counts().items()
               if k != "table_interp"), ops.launch_counts()
    region = ShmRegion.attach(shm, mode="r", worker_id="t0")
    for m, st in to_numpy(state["maps"]).items():
        got = region.snapshot_device(m)
        assert all((got[f] == a).all() for f, a in st.items()), m
    del state
    tcfg = TrainConfig(microbatch=2, remat=True, warmup=10, total_steps=2)
    rt2, _ = C.train_runtime(cfg)
    fresh = init_train_state(cfg, tcfg, rt2, torch.Generator(device=cuda)
                             .manual_seed(C.SEED + 1), cuda)
    restored = CK.restore(ck, 1, fresh, device=cuda)
    with C.one_card_mesh() as mesh:
        placed = CK.restore(ck, 1, fresh, mesh=mesh,
                            shardings=state_shardings(fresh, mesh))
        leaves, plain = tree_leaves(placed), tree_leaves(restored)
        assert len(leaves) == len(plain)
        assert all(C.bits_equal(a.full_tensor(), b)
                   for a, b in zip(leaves, plain))
        del placed, leaves
    data = SyntheticDataset(cfg, ShapeConfig("ckpt", SEQ, 4, "train"), tcfg)
    data.next()
    state2, _ = make_train_step(cfg, tcfg, rt2, probe_mode="fused")(
        restored, data.next())
    want = CK.restore(ck, 2, state2, device="cpu")
    with open(os.path.join(ck, "step_2", "tree.json")) as f:
        names = json.load(f)["names"]
    for nm, a, b in zip(names, tree_leaves(state2), tree_leaves(want)):
        if not C.bits_equal(a, b):
            assert nm.startswith(("params/", "opt/")), nm
            assert float((a.detach().cpu().float() - b.float()).abs().max()) \
                <= PARAM_TOL, nm
