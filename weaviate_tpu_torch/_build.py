"""Builds and loads the port's CUDA kernels.

Each kernel is one ``csrc/<name>.cu`` with a plain C interface. It is
compiled with ``nvcc`` for ``sm_90a`` into a shared library under
``_build/`` (listed in ``.gitignore``), named by the hash of its source and
flags, so an edited source is rebuilt on its next use, and loaded with
``ctypes``. Nothing is built at import: the first call that launches a
kernel builds it. A missing ``nvcc`` or a failed build raises with the
compiler's output.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-lineinfo",
    "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

_lock = threading.Lock()


def nvcc() -> str:
    """Path of the CUDA compiler: ``nvcc`` on PATH, else the toolkit's."""
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.path.isfile(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME, /usr/local/cuda): the port's "
        "CUDA kernels are built from csrc/ on first use")


def library_path(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    h = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(*names: str) -> dict[str, str]:
    """Compile the named kernels that are not built yet, one ``nvcc`` each,
    all started together. Returns each kernel's compiler log (register and
    shared-memory use from ``-Xptxas -v``); "" for one already built."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    logs = {}
    with _lock:
        for name in names:
            out = library_path(name)
            if out.exists():
                logs[name] = ""
                continue
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                   str(CSRC / f"{name}.cu")]
            procs[name] = (subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True), tmp, out)
        failed = []
        for name, (proc, tmp, out) in procs.items():
            log, _ = proc.communicate()
            logs[name] = log
            if proc.returncode != 0:
                failed.append(f"nvcc failed for {name}.cu "
                              f"(exit {proc.returncode}):\n{log}")
                continue
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("\n".join(failed))
    return logs


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """The built library of kernel ``name``, built first if needed."""
    build(name)
    return ctypes.CDLL(str(library_path(name)))
