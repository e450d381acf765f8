"""Build, load and launch the hand-written CUDA kernels of ``csrc/``.

Each ``csrc/<name>.cu`` is compiled by nvcc, on its own, into a shared
library with a plain C interface (no PyTorch headers, so a build takes
seconds), and loaded with ``ctypes``.  Libraries land in ``build/kernels``
at the repository root, named by a hash of the source and the flags, so a
changed source is rebuilt and an unchanged one is reused.  ``build_all``
starts one nvcc per source, all at once.

Every C entry point takes device pointers and the CUDA stream as
``void*``, launches on that stream, allocates nothing, does not
synchronise, and returns ``cudaGetLastError()``; :func:`launch` raises if
that is not 0 and counts the launch.  Nothing here runs at import time.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
SOURCES = ("scan_window", "occ_round", "index_merge", "thomas_merge",
           "rmsnorm", "flash_attention", "ssd")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_LIBS: dict = {}
_LOCK = threading.Lock()
# launches per kernel name: incremented in :func:`launch` only, i.e. once
# per C entry point that enqueued its kernels on the card
LAUNCHES: dict = {}


def launch_counts() -> dict:
    return dict(LAUNCHES)


def reset_launch_counts():
    LAUNCHES.clear()


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    cands = [shutil.which("nvcc")]
    if home:
        cands.append(str(Path(home) / "bin" / "nvcc"))
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if c and Path(c).exists():
            return c
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _lib_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    h = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{h}.so"


def _start(name: str):
    """Start nvcc for one source unless its library is already built;
    returns (path, process or None)."""
    out = _lib_path(name)
    if out.exists():
        return out, None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return out, (proc, tmp)


def _finish(name: str, out: Path, job) -> str:
    if job is None:
        return ""
    proc, tmp = job
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{log}")
    os.replace(tmp, out)
    out.with_suffix(".log").write_text(log)
    return log


def build_all(names=SOURCES) -> dict:
    """Compile every listed source in parallel (one nvcc each).  Returns
    {name: nvcc output} (empty for libraries already built)."""
    with _LOCK:
        jobs = {n: _start(n) for n in names}
        return {n: _finish(n, *jobs[n]) for n in names}


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built at first use."""
    lib = _LIBS.get(name)
    if lib is None:
        build_all((name,))
        with _LOCK:
            lib = _LIBS.get(name)
            if lib is None:
                lib = _LIBS[name] = ctypes.CDLL(str(_lib_path(name)))
    return lib


def bind(name: str, fn: str, argtypes,
         restype=ctypes.c_int) -> ctypes._CFuncPtr:
    """The C entry point ``fn`` of library ``name`` with its signature set
    (``ctypes.c_void_p`` for every pointer and the stream)."""
    f = getattr(library(name), fn)
    if f.argtypes is None:
        f.argtypes = list(argtypes)
        f.restype = restype
    return f


def launch(kernel: str, f, *args):
    """Call one C entry point, raise on a launch error, count the launch."""
    err = f(*args)
    if err != 0:
        raise RuntimeError(f"CUDA launch of {kernel} failed: error {err}")
    LAUNCHES[kernel] = LAUNCHES.get(kernel, 0) + 1


def checked(name: str, t, dtype, shape, device):
    """Validate a kernel argument: CUDA tensor on ``device``, ``dtype``,
    ``shape`` and contiguous.  Raises ValueError otherwise."""
    if t.device != device or t.device.type != "cuda":
        raise ValueError(f"{name}: on {t.device}, the kernel needs {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: dtype {t.dtype}, the kernel needs {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")
    return t


def aligned16(t):
    """``t`` contiguous and starting on a 16-byte boundary (a copy if it is
    not), for kernels that move 16-byte vectors."""
    t = t.contiguous()
    return t.clone() if t.data_ptr() % 16 else t


def stream_ptr(device) -> int:
    import torch
    return torch.cuda.current_stream(device).cuda_stream
