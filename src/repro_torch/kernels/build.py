"""Build the package's CUDA kernels at first use and load them with ctypes.

Each `csrc/<name>.cu` has a plain C interface and is compiled by its own
`nvcc` process into `build/repro_torch_kernels/<name>-<digest>.so` at the
root of the checkout, for `sm_90a` (Hopper). All the sources build in
parallel; a library whose source, headers (`csrc/*.cuh`) and flags are
unchanged is reused. Nothing here runs when the package is imported.
"""
from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

SOURCES = ("tensor_stats", "hash_update", "ringbuf_emit",
           "flash_attention", "table_interp")
CSRC = Path(__file__).with_name("csrc")
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
FLAGS = ("-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_LIBS: dict[str, ctypes.CDLL] = {}
BUILD_LOG: dict[str, str] = {}        # name -> nvcc/ptxas output (kept
                                      # beside the library as <lib>.log)
_LOCK = threading.Lock()


def nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on "
                           "PATH to build the repro_torch kernels")
    return found


def path(name: str) -> Path:
    """The library that source `name` builds into."""
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build_all() -> float:
    """Compile every source not yet built (one nvcc each, all at once) and
    load every library. Returns the seconds spent; raises on a failure."""
    with _LOCK:
        t0 = time.perf_counter()
        todo = [n for n in SOURCES if n not in _LIBS]
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        procs = {}
        for name in todo:
            out = path(name)
            if out.exists():
                log = out.with_suffix(".log")
                BUILD_LOG[name] = log.read_text() if log.exists() else ""
                continue
            tmp = out.with_suffix(f".{os.getpid()}.tmp.so")
            procs[name] = (subprocess.Popen(
                [nvcc(), *FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
                tmp, out)
        errors = []
        for name, (p, tmp, out) in procs.items():
            log, _ = p.communicate()
            BUILD_LOG[name] = log
            if p.returncode != 0:
                errors.append(f"{name}: nvcc exited {p.returncode}\n{log}")
            else:
                out.with_suffix(".log").write_text(log)
                os.replace(tmp, out)
        if errors:
            raise RuntimeError("kernel build failed:\n" + "\n".join(errors))
        for name in todo:
            _LIBS[name] = ctypes.CDLL(str(path(name)))
        return time.perf_counter() - t0


def lib(name: str) -> ctypes.CDLL:
    if name not in _LIBS:
        build_all()
    return _LIBS[name]


def function(name: str, symbol: str, argtypes: list):
    """The C entry point `symbol` of library `name`, typed: every pointer
    and the stream as c_void_p, so no address is cut to 32 bits."""
    fn = getattr(lib(name), symbol)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def stream_ptr(device) -> int:
    """The handle of PyTorch's current stream on `device`, as an int (the
    raw getter PyTorch's own generated kernels use, where it exists: the
    probe kernels' wrappers run on every event)."""
    import torch
    raw = getattr(torch._C, "_cuda_getCurrentRawStream", None)
    if raw is None:
        return torch.cuda.current_stream(device).cuda_stream
    index = torch.device(device).index
    return raw(torch.cuda.current_device() if index is None else index)


def device_guard(device):
    """`torch.cuda.device(device)`, or no context at all when `device` is
    the current device already (the common case, and the cheaper one)."""
    import torch
    index = torch.device(device).index
    if index is None or index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(device)


_SCRATCH: dict = {}     # (name, device index, stream handle) -> buffer


def device_scratch(name: str, device, nbytes: int):
    """(buffer, stream): a zeroed u8 buffer of `nbytes` that kernel `name`
    keeps on `device` for the current stream, for the life of the process
    (ticket counters a launch leaves at 0, per-block partials), made on
    the first call from that stream, and the stream's handle. Each stream
    has its own buffer, so launches on different streams never share one,
    and later launches on one stream reuse it."""
    import torch
    dev = torch.device(device)
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    stream = stream_ptr(dev)
    buf = _SCRATCH.get((name, index, stream))
    if buf is None:
        buf = torch.zeros(nbytes, dtype=torch.uint8, device=dev)
        _SCRATCH[(name, index, stream)] = buf
    if buf.numel() < nbytes:
        raise RuntimeError(f"{name}: scratch of {buf.numel()} bytes, "
                           f"{nbytes} asked")
    return buf, stream


def require(t, what: str, dtype, ndim: int, device=None) -> None:
    """Raise unless `t` is a contiguous CUDA tensor of `dtype` and `ndim`
    dimensions (on `device` when given)."""
    if not t.is_cuda:
        raise ValueError(f"{what}: expected a CUDA tensor, got {t.device}")
    if device is not None and t.device != device:
        raise ValueError(f"{what}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{what}: expected {dtype}, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{what}: expected {ndim} dims, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{what}: must be contiguous")


def on_card(t, name: str) -> bool:
    """True when `t` goes to the kernel (a CUDA tensor), False when it goes
    to the plain version (a CPU tensor); any other device raises."""
    if t.is_cuda:
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"{name}: no kernel or plain version for {t.device}")


def check(rc: int, kernel: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{kernel}: CUDA launch failed with error {rc}")
