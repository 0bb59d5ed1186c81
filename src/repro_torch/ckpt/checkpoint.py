"""Checkpointing: numpy save/restore with async commit, in the JAX
package's on-disk layout, so either package restores the other's files.

Layout:  <dir>/step_<N>/ leaf files `<flat-index>.npy` + `tree.json`
(`n`, `names`, `step`). Leaves are in `optim.tree_leaves` order (dict keys
sorted, list items in order), which is JAX's flatten order; `names` are the
"/"-joined dict keys and list indices of each leaf. A bf16 leaf is written
as JAX writes one: its raw bytes under the header descr '<V2' (numpy has
no bf16), and restored by the dtype of `like`. The live table of a
runtime's maps is saved as its fields, as JAX holds it; its packed buffer,
which those fields view, is rebuilt on restore.

Commit protocol: write into `step_<N>.tmp`, then rename -- a crash mid-save
never corrupts the latest checkpoint. `latest()` returns the newest
COMMITTED step. Saves go through the sys_checkpoint_save framework syscall
and restores through sys_checkpoint_restore (eBPF programs can audit or
veto them).

Elastic resharding: the files hold full arrays, whatever mesh wrote them.
`save` takes DTensor leaves, gathers each with `full_tensor()` (a
collective every rank of its mesh runs), and rank 0 writes. `restore`
with `shardings` (a tree of `dist.sharding.PartitionSpec`s shaped like
`like`) and a `mesh` (or the active one) places each leaf with
`distribute_tensor`: every rank reads the same files and keeps its own
shard, so a checkpoint written on one mesh restores onto any other.
"""
from __future__ import annotations

import json
import os
import shutil
import threading

import numpy as np
import torch

from ..device import resolve
from ..dist.sharding import PartitionSpec

_LIVE = "__live_table__"


def _flatten(tree, path=()):
    """[(name, leaf)] in tree_leaves order, without the live table's
    packed buffer."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree)
                if not (path and path[-1] == _LIVE and k == "packed")
                for x in _flatten(tree[k], path + (str(k),))]
    if isinstance(tree, (list, tuple)) and \
            not isinstance(tree, PartitionSpec):
        return [x for i, t in enumerate(tree)
                for x in _flatten(t, path + (str(i),))]
    return [("/".join(path), tree)]


def _unflatten(like, leaves, path=()):
    """`like`'s structure with `leaves` (an iterator, _flatten order) in
    place of its leaves; a live table gets a packed buffer again, laid out
    as like's, with its fields as views of it."""
    if isinstance(like, dict):
        out = {k: _unflatten(like[k], leaves, path + (str(k),))
               for k in sorted(like)
               if not (path and path[-1] == _LIVE and k == "packed")}
        if path and path[-1] == _LIVE and "packed" in like:
            packed = like["packed"]
            buf = torch.empty_like(packed, device=out[next(iter(out))].device)
            base = packed.storage_offset()
            for k, view in out.items():
                off = like[k].storage_offset() - base
                dst = buf[off:off + view.numel()].view(view.shape)
                dst.copy_(view)
                out[k] = dst
            out["packed"] = buf
        return out
    if isinstance(like, (list, tuple)):
        return type(like)(_unflatten(t, leaves, path + (str(i),))
                          for i, t in enumerate(like))
    return next(leaves)


def _host(x) -> tuple[np.ndarray, bool]:
    """(a host copy of one leaf, whether it is bf16 bytes). The copy is
    made now, so nothing the caller does next can change what is saved."""
    if isinstance(x, torch.Tensor):
        t = x.detach()
        if _is_dtensor(t):
            t = t.full_tensor()
        bf16 = t.dtype == torch.bfloat16
        if bf16:
            t = t.view(torch.int16)
        return t.to("cpu", copy=True).contiguous().numpy(), bf16
    return np.array(x, copy=True), False


def _is_dtensor(x) -> bool:
    if not torch.distributed.is_available():
        return False
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def _write_leaf(path: str, arr: np.ndarray, bf16: bool) -> None:
    if not bf16:
        np.save(path, arr)
        return
    with open(path, "wb") as f:
        np.lib.format.write_array_header_1_0(
            f, {"descr": "<V2", "fortran_order": False, "shape": arr.shape})
        f.write(arr.tobytes())


def save(ckpt_dir: str, step: int, state, *, runtime=None,
         blocking: bool = True,
         fault_retries: int = 3) -> threading.Thread | None:
    """state: tree of tensors (or numpy arrays). Returns the writer thread
    if async; the host copy of every leaf is complete before this returns,
    only the file writes run in the thread.

    Failure drill semantics: an eBPF filter overriding sys_checkpoint_save
    with a NEGATIVE code (-errno) is a transient write fault -- the save is
    retried up to `fault_retries` times, then skipped (training continues;
    the previous committed checkpoint stays latest). A non-negative
    override is a policy veto: skipped immediately.

    With DTensor leaves every rank must call this: each leaf is gathered
    (a collective), rank 0 writes, and a blocking save returns on every
    rank once the files are committed."""
    flat = _flatten(state)
    names = [n for n, _ in flat]
    dist_save = any(_is_dtensor(x) for _, x in flat)
    host = [_host(x) for _, x in flat]
    if dist_save and torch.distributed.get_rank() != 0:
        if blocking:
            torch.distributed.barrier()
        return None

    def impl():
        tmp = os.path.join(ckpt_dir, f"step_{step}.tmp")
        final = os.path.join(ckpt_dir, f"step_{step}")
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp, exist_ok=True)
        for i, (arr, bf16) in enumerate(host):
            _write_leaf(os.path.join(tmp, f"{i}.npy"), arr, bf16)
        with open(os.path.join(tmp, "tree.json"), "w") as f:
            json.dump({"n": len(host), "names": names, "step": step}, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
        return step

    def run():
        if runtime is not None:
            for _ in range(fault_retries + 1):
                res = runtime.syscalls.invoke("sys_checkpoint_save",
                                              [step, len(host)], impl=impl)
                if not res.overridden:
                    return res.value
                if not res.fault:
                    return None      # policy veto: no retry
            return None              # fault persisted: degrade (skip save)
        return impl()

    if blocking:
        run()
        if dist_save:
            torch.distributed.barrier()
        return None
    t = threading.Thread(target=run, daemon=True)
    t.start()
    return t


def latest(ckpt_dir: str) -> int | None:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = []
    for d in os.listdir(ckpt_dir):
        if d.startswith("step_") and not d.endswith(".tmp") and \
                os.path.exists(os.path.join(ckpt_dir, d, "tree.json")):
            steps.append(int(d.split("_")[1]))
    return max(steps) if steps else None


def _to_tensor(arr: np.ndarray, ref, i: int, dev) -> torch.Tensor:
    """One loaded leaf as a tensor on `dev`; raw 2-byte leaves ('<V2', how
    bf16 is written) are read as bf16 when `ref` is bf16."""
    if arr.dtype.kind == "V":
        if arr.dtype.itemsize != 2 or \
                getattr(ref, "dtype", None) != torch.bfloat16:
            raise ValueError(f"leaf {i}: raw {arr.dtype} bytes restore only "
                             f"into a bf16 leaf, not {ref.dtype}")
        return torch.from_numpy(arr.view(np.int16)).view(
            torch.bfloat16).to(dev)
    return torch.from_numpy(arr).to(dev)


def restore(ckpt_dir: str, step: int, like, *, mesh=None, shardings=None,
            runtime=None, fault_retries: int = 3, device="cuda"):
    """Restore into the structure of `like` (a tree of tensors or arrays
    giving each leaf's shape, and bf16 where the file holds raw bytes), on
    `device` (CUDA unless the caller passes "cpu").

    With `shardings`, a tree of `PartitionSpec`s shaped like `like`, each
    leaf becomes a DTensor on `mesh` (default: the active mesh) with the
    spec's placements, on the mesh's device type: elastic resharding."""
    placed = None
    if shardings is not None:
        from ..dist import sharding as SH
        from torch.distributed.tensor import distribute_tensor
        mesh = mesh if mesh is not None else SH.active_mesh()
        if mesh is None:
            raise ValueError("restore with shardings needs a mesh")
        specs = [x for _, x in _flatten(shardings)]
        dm = SH.device_mesh_of(mesh)
        device = dm.device_type

        def placed(i, t):
            # every rank holds the full array: keep the local shard, no
            # collective (src_data_rank=None)
            return distribute_tensor(t, dm, SH.placements(specs[i], mesh),
                                     src_data_rank=None)
    elif mesh is not None:
        raise ValueError("restore onto a mesh needs shardings")
    dev = resolve(device)

    def impl():
        d = os.path.join(ckpt_dir, f"step_{step}")
        with open(os.path.join(d, "tree.json")) as f:
            meta = json.load(f)
        refs = [x for _, x in _flatten(like)]
        if meta["n"] != len(refs):
            raise ValueError(f"checkpoint has {meta['n']} leaves, expected "
                             f"{len(refs)}")
        out = []
        for i, ref in enumerate(refs):
            arr = np.load(os.path.join(d, f"{i}.npy"))
            if arr.shape != tuple(np.shape(ref)):
                raise ValueError(f"leaf {i}: {arr.shape} != "
                                 f"{tuple(np.shape(ref))}")
            out.append(_to_tensor(arr, ref, i, dev))
        if placed is not None:
            if len(specs) != len(out):
                raise ValueError(f"{len(specs)} shardings for {len(out)} "
                                 "leaves")
            out = [placed(i, t) for i, t in enumerate(out)]
        return _unflatten(like, iter(out))

    if runtime is not None:
        # same drill convention as save(): negative override = transient
        # read fault, bounded retry; non-negative = veto (returns None)
        for _ in range(fault_retries + 1):
            res = runtime.syscalls.invoke("sys_checkpoint_restore", [step],
                                          impl=impl)
            if not res.overridden or not res.fault:
                return res.value
        return None
    return impl()
