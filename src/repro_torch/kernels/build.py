"""Build and load the port's CUDA kernels: ``nvcc`` by hand, bound with ctypes.

Every ``csrc/*.cu`` is compiled for ``sm_90a`` (one ``nvcc -c`` per source,
all started together) and linked into one shared library with a plain C
interface under ``<repo>/build/kernels/``, named by a digest of the sources
and flags, so a tree that already built them loads the library as it is.
The build happens at the first kernel launch, never at import: the CPU
tests import every module on a machine without ``nvcc``.

Each C entry point returns ``cudaGetLastError()`` after its launch; the
wrappers pass it to ``check``, which raises on anything but 0.
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
    link = [tool, *ARCH_FLAGS, "-shared", "-o", str(lib), *map(str, objs)]
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


def entry(name: str, argtypes) -> ctypes._CFuncPtr:
    """A C entry point of the library with its argument types declared
    (every pointer and the stream as ``c_void_p``; ints as ``c_int``)."""
    fn = getattr(library(), name)
    fn.argtypes = list(argtypes)
    fn.restype = ctypes.c_int
    return fn


def check(err: int, name: str):
    if err != 0:
        msg = library().repro_cuda_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA launch failed ({err}: {msg})")
