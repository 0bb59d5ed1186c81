"""Worker processes for the port's multi-rank tests on the CPU (gloo).

This module imports only torch, numpy and the port, so a worker never
imports JAX. `launch(job, world, workdir)` starts `world` processes that
rendezvous through a file in `workdir` (never a network port), each runs
`JOBS[job](rank, world, workdir)` and saves what it returns to
`workdir/out_<rank>.pt`; a worker that fails writes its traceback instead.
Every rendezvous and join has a timeout, so a hung group fails one test.
"""
from __future__ import annotations

import datetime
import json
import os
import subprocess
import sys
import traceback
from pathlib import Path

import numpy as np
import torch

HERE = Path(__file__).resolve().parent
SRC = HERE.parent / "src"
TIMEOUT_S = 120


def launch(job: str, world: int, workdir, timeout: float = TIMEOUT_S,
           **params) -> list:
    """Run `job` on `world` gloo ranks; returns each rank's result."""
    workdir = Path(workdir)
    workdir.mkdir(parents=True, exist_ok=True)
    (workdir / "params.json").write_text(json.dumps(params))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(SRC), str(HERE), os.environ.get("PYTHONPATH", "")]))
    code = ("import sys; sys.modules['jax'] = None; "
            "sys.modules['repro'] = None; import torch_dist_workers as W; "
            "W.main()")
    procs = [subprocess.Popen([sys.executable, "-c", code, job, str(r),
                               str(world), str(workdir)], env=env,
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(world)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    out = []
    for r, p in enumerate(procs):
        err = workdir / f"err_{r}.txt"
        if err.exists():
            raise RuntimeError(f"rank {r} of {job} failed:\n"
                               f"{err.read_text()}")
        if p.returncode != 0:
            raise RuntimeError(f"rank {r} of {job} exited "
                               f"{p.returncode}:\n{logs[r][-3000:]}")
        out.append(torch.load(workdir / f"out_{r}.pt", weights_only=False))
    return out


def main():
    job, rank, world, workdir = sys.argv[1], int(sys.argv[2]), \
        int(sys.argv[3]), Path(sys.argv[4])
    import torch.distributed as dist
    try:
        dist.init_process_group(
            "gloo", init_method=f"file://{workdir / 'rendezvous'}",
            rank=rank, world_size=world,
            timeout=datetime.timedelta(seconds=TIMEOUT_S / 2))
        params = json.loads((workdir / "params.json").read_text())
        res = JOBS[job](rank, world, workdir, **params)
        torch.save(res, workdir / f"out_{rank}.pt")
        dist.barrier()          # nobody leaves while a peer still gathers
    except BaseException:
        (workdir / f"err_{rank}.txt").write_text(traceback.format_exc())
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


# --------------------------------------------------------------- jobs

def _mesh(shape):
    from repro_torch.launch.mesh import make_host_mesh
    return make_host_mesh(tuple(shape), device="cpu")


def _cfg(arch, over):
    import dataclasses
    from repro_torch.configs import registry
    return dataclasses.replace(registry.smoke(arch), **over)


def _ep_layer(world, workdir, case):
    """One MoE layer from the parent's numpy weights and x: apply_moe_ep
    on the (1, world) mesh against apply_moe, values and gradients."""
    from repro_torch.dist import expert_parallel as EP, sharding as SH
    from repro_torch.models import moe as MOE
    cfg = _cfg(case["arch"], case["over"])
    npz = np.load(workdir / f"{case['name']}.npz")
    p = {k: torch.tensor(npz[k]) for k in ("router", "w_in", "w_gate",
                                           "w_out")}
    x = torch.tensor(npz["x"])
    g = torch.tensor(npz["g"])
    mesh = _mesh((1, world))

    def run(ep):
        pp = {k: v.clone().requires_grad_(True) for k, v in p.items()}
        xx = x.clone().requires_grad_(True)
        with SH.use_mesh(mesh):
            y = (EP.apply_moe_ep if ep else MOE.apply_moe)(pp, xx, cfg)
        (y * g).sum().backward()
        return y.detach(), xx.grad, {k: v.grad for k, v in pp.items()}

    g0 = EP.GATHERS
    y_ep, dx_ep, dw_ep = run(True)
    gathers = EP.GATHERS - g0
    y, dx, dw = run(False)
    _, info = MOE.route(p, x, cfg)
    ints = {k: info[k] for k in ("gids", "sort_idx", "sorted_eids", "pos_c",
                                 "tok_idx", "keep")}
    # the expert weights as DTensors laid out by spec_for (experts over
    # 'model'): each rank takes its local shard
    from torch.distributed.tensor import distribute_tensor
    pd = dict(p)
    for k in ("w_in", "w_gate", "w_out"):
        pd[k] = distribute_tensor(p[k], mesh.device_mesh, SH.placements(
            SH.spec_for(["moe", k], p[k].shape, mesh), mesh))
    with torch.no_grad(), SH.use_mesh(mesh):
        y_dt = EP.apply_moe_ep(pd, x, cfg)
    return {"y_ep": y_ep, "y": y, "dx_ep": dx_ep, "dx": dx, "dw_ep": dw_ep,
            "dw": dw, "ints": ints, "gathers": gathers, "y_dtensor": y_dt}


def _ep_model(world, arch):
    """A smoke model's forward with REPRO_MOE_EP=1 on the (1, world) mesh
    against the switch off: logits and the gathers made."""
    from repro_torch.dist import expert_parallel as EP, sharding as SH
    from repro_torch.models import registry as MR
    cfg = _cfg(arch, {})
    gen = torch.Generator().manual_seed(0)
    params = MR.init_params(cfg, gen, "cpu")
    toks = torch.as_tensor(np.random.default_rng(3).integers(
        0, cfg.vocab_size, (2, 16)))
    mesh = _mesh((1, world))
    out = {}
    for on in ("0", "1"):
        os.environ["REPRO_MOE_EP"] = on
        g0 = EP.GATHERS
        with SH.use_mesh(mesh):
            out[on] = MR.prefill_fn(params, {"tokens": toks}, MR.make_cache(
                cfg, 2, 16, torch.float32, "cpu"), cfg)[0]
        out[f"gathers_{on}"] = EP.GATHERS - g0
    os.environ.pop("REPRO_MOE_EP")
    moe_layers = sum(cfg.ffn_kind(j) == "moe" for j in range(cfg.num_layers))
    return {"off": out["0"], "on": out["1"], "gathers": out["gathers_1"],
            "gathers_off": out["gathers_0"], "moe_layers": moe_layers}


def ep(rank, world, workdir, cases=(), models=()):
    return {"layers": {c["name"]: _ep_layer(world, workdir, c)
                       for c in cases},
            "models": {a: _ep_model(world, a) for a in models}}


def _state(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"params": {"embed": {"embedding": torch.randn(8, 6, generator=g)},
                       "blk": {"wq": torch.randn(3, 4, 6, generator=g),
                               "scale": torch.randn(6, generator=g)},
                       "moe": {"w_in": torch.randn(4, 6, 2, generator=g)
                               .to(torch.bfloat16)}},
            "step": torch.tensor(7, dtype=torch.int32)}


def dtensors(rank, world, workdir):
    """Elastic restore onto (2, 1) and (1, 2), a save of DTensor leaves,
    and constrain redistributing a DTensor."""
    from torch.distributed.tensor import distribute_tensor
    from repro_torch.ckpt import checkpoint as CK
    from repro_torch.dist import sharding as SH
    from repro_torch.launch.specs import leaf_paths, state_shardings
    from repro_torch.optim import tree_leaves, tree_map
    ck = str(workdir / "ckpt")
    out = {}
    for shape in ((2, 1), (1, 2)):
        mesh = _mesh(shape)
        like = _state()
        specs = state_shardings(like, mesh)
        got = CK.restore(ck, 1, like, mesh=mesh, shardings=specs,
                         device="cpu")
        out[shape] = {
            "specs": [tuple(s) for _, s in leaf_paths(specs)],
            "local": [t.to_local() for t in tree_leaves(got)],
            "full": [t.full_tensor() for t in tree_leaves(got)],
            "placements": [_dims(t) for t in tree_leaves(got)],
            "coord": mesh.device_mesh.get_coordinate()}
    # a save of DTensor leaves (rank 0 writes), restored without a mesh
    mesh = _mesh((2, 1))
    state = _state(seed=1)
    dstate = tree_map(lambda t, spec: distribute_tensor(
        t, mesh.device_mesh, SH.placements(spec, mesh)), state,
        state_shardings(state, mesh))
    CK.save(str(workdir / "ckpt_dt"), 2, dstate)
    back = CK.restore(str(workdir / "ckpt_dt"), 2, _state(), device="cpu")
    out["saved"] = {"back": tree_leaves(back)}
    # constrain: replicated -> the second dim over 'model' on (1, 2)
    mesh = _mesh((1, 2))
    x = distribute_tensor(torch.arange(24.).reshape(4, 6), mesh.device_mesh,
                          SH.replicated(mesh))
    with SH.use_mesh(mesh):
        y = SH.constrain(x, None, "model")
        z = SH.constrain(x, "batch", None)
    out["constrain"] = {"y_local": y.to_local(),
                        "y_placements": _dims(y),
                        "z_placements": _dims(z),
                        "y_full": y.full_tensor()}
    return out


def _dims(t) -> list:
    """A DTensor's placements: the sharded tensor dim of each mesh axis,
    None where it is replicated."""
    return [p.dim if p.is_shard() else None for p in t.placements]


JOBS = {"ep": ep, "dtensors": dtensors}
