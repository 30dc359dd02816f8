"""Build and load the port's CUDA kernels: ``nvcc`` by hand, bound with ctypes.

Every ``csrc/*.cu`` is compiled for ``sm_90a`` (one ``nvcc -c`` per source,
all started together) and linked into one shared library with a plain C
interface under ``<repo>/build/kernels/``, named by a digest of the sources
and flags, so a tree that already built them loads the library as it is.
The build happens at the first kernel launch, never at import: the CPU
tests import every module on a machine without ``nvcc``.

Each C entry point returns ``cudaGetLastError()`` after its launch; the
wrappers pass it to ``check``, which raises on anything but 0. A launch is
forward-only: its output has no ``grad_fn``. So a wrapper whose kernel has
no backward calls ``refuse_grad`` before it launches, and raises where a
gradient is asked for instead of silently dropping it.

Each launch is an operator of the dispatcher, ``torch.ops.repro_torch.*``
(``op``): the wrappers call it for every tensor not on the CPU. Its one
implementation launches the kernel on a CUDA tensor and refuses any other
device, so a tensor on ``meta`` raises as any other device does, except
under a ``TorchDispatchMode``, which sees the call before any
implementation: the dry run's cost counter (``launch/cost.py``) answers it
with the kernel's outputs and counts its work by the operator's name.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().with_name("csrc")
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = ("-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_lib = None
build_log = ""          # the compiler's output of the last build in this
                        # process (registers, spills: -Xptxas -v)


def nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            f"nvcc not found (looked in {cand} and on PATH): the port's CUDA "
            "kernels are built on a machine with the CUDA toolkit")
    return found


def sources():
    return sorted(CSRC.glob("*.cu"))


def digest() -> str:
    h = hashlib.sha256(" ".join(ARCH_FLAGS + NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def compile_commands(out_dir: Path, tool: str = "nvcc"):
    """(per-source compile commands, link command, library path)."""
    lib = out_dir / f"libreprotorch_{digest()}.so"
    objs, cmds = [], []
    for src in sources():
        obj = out_dir / (src.stem + ".o")
        objs.append(obj)
        cmds.append([tool, *ARCH_FLAGS, *NVCC_FLAGS, "-c", str(src),
                     "-o", str(obj)])
    # -ldl: the TMA descriptors' encoder is looked up in the loaded driver
    link = [tool, *ARCH_FLAGS, "-shared", "-o", str(lib), *map(str, objs), "-ldl"]
    return cmds, link, lib


def build() -> Path:
    """Compile (if needed) and return the shared library's path."""
    global build_log
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cmds, link, lib = compile_commands(BUILD_DIR, nvcc())
    if lib.is_file():
        return lib
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for c in cmds]
    logs, failed = [], []
    for c, p in zip(cmds, procs):
        out, _ = p.communicate()
        logs.append(out)
        if p.returncode != 0:
            failed.append(c[-3])
    build_log = "".join(logs)
    if failed:
        raise RuntimeError(f"nvcc failed on {failed}:\n{build_log}")
    res = subprocess.run(link, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                         text=True)
    build_log += res.stdout
    if res.returncode != 0:
        raise RuntimeError(f"nvcc link failed:\n{res.stdout}")
    return lib


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first use, thread-safe)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
            lib.repro_cuda_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def op(name: str, schema: str):
    """Declare ``torch.ops.repro_torch.<name>`` with ``schema`` and make the
    decorated function its implementation for every device; returns the
    operator."""
    import torch

    def wrap(fn):
        qual = f"repro_torch::{name}"
        torch.library.define(qual, schema)
        torch.library.impl(qual, "default")(fn)
        return getattr(torch.ops.repro_torch, name)
    return wrap


def entry(name: str, argtypes) -> ctypes._CFuncPtr:
    """A C entry point of the library with its argument types declared
    (every pointer and the stream as ``c_void_p``; ints as ``c_int``)."""
    fn = getattr(library(), name)
    fn.argtypes = list(argtypes)
    fn.restype = ctypes.c_int
    return fn


def refuse_grad(name: str, why: str, *tensors):
    """Raise ``NotImplementedError`` when autograd is on and an input
    (None allowed) requires grad: the kernel's output would carry no
    gradient back. ``why`` says where a backward comes from, if ever."""
    import torch
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad
                                       for t in tensors):
        raise NotImplementedError(
            f"{name}: the CUDA kernel has no backward ({why}); its output "
            "would carry no gradient")


def check(err: int, name: str):
    if err != 0:
        msg = library().repro_cuda_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA launch failed ({err}: {msg})")
