"""What the kernel probes (``probe_rerank.py``, ``probe_hybrid.py``,
``probe_hfresh.py``) share: the entry points appended to every copy of a
kernel source (an empty kernel and a kernel that holds the stream), copies
of a source with text replaced, their build with the port's flags (one
``nvcc`` a copy, all started together), another checkout's module loaded
beside this one's, a wrapper's arguments captured from the entry points,
and the timing of a call with the stream held.
"""

from __future__ import annotations

import ctypes
import importlib.util
import subprocess
import sys
import time
from pathlib import Path

import torch

SPIN_NS = 40_000_000

# the probe's own entry points, appended to every copy: an empty kernel
# and a kernel that holds the stream for a while
APPENDED = r"""
__global__ void probe_empty_kernel() {}
__global__ void probe_spin_kernel(long long ns) {
  long long t0, t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t0));
  do {
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  } while (t - t0 < ns);
}
extern "C" int probe_empty(void* stream) {
  probe_empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
extern "C" int probe_spin(long long ns, void* stream) {
  probe_spin_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(ns);
  return static_cast<int>(cudaGetLastError());
}
"""


def edited(edits, text: str) -> str:
    """``text`` with each (old, new) of ``edits`` replaced; exits where
    the text no longer holds an old one."""
    for old, new in edits:
        if old not in text:
            raise SystemExit(f"probe: the source no longer holds {old!r}")
        text = text.replace(old, new)
    return text


def copies_of(tables, text: str, appended: str, what: str) -> dict:
    """The copies of the first table of ``tables`` (dicts of name -> edits,
    None skipped) whose edits all apply to ``text``, each with
    ``appended`` after it; exits where none applies to ``what``."""
    for table in tables:
        if table and all(old in text for edits in table.values()
                         for old, _ in edits):
            return {name: edited(edits, text) + appended
                    for name, edits in table.items()}
    raise SystemExit(f"probe: no table of copies applies to {what}")


def build(sources: dict, out: Path) -> dict:
    """Each source text compiled into ``out`` with the port's flags, one
    nvcc each, together; returns the libraries' paths. The logs of the
    sources as they are (names ending in ``as_is``) go to stderr."""
    from weaviate_tpu_torch import _build

    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, text in sources.items():
        src = out / f"{name}.cu"
        src.write_text(text)
        lib = out / f"lib{name}.so"
        procs[name] = (subprocess.Popen(
            [_build.nvcc(), *_build.NVCC_FLAGS, "-o", str(lib), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), lib)
    paths = {}
    for name, (proc, lib) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"probe: nvcc failed for {name}:\n{log}")
        if name.endswith("as_is"):
            print(log, file=sys.stderr, flush=True)
        paths[name] = lib
    return paths


def load(mod, path: Path, **argtypes) -> ctypes.CDLL:
    """The library at ``path`` with ``mod``'s C signatures declared, the
    appended entry points' and those of ``argtypes`` (name -> types)."""
    lib = mod.declare(ctypes.CDLL(str(path)))
    lib.probe_spin.argtypes = [ctypes.c_longlong, ctypes.c_void_p]
    lib.probe_empty.argtypes = [ctypes.c_void_p]
    for name, types in argtypes.items():
        getattr(lib, name).argtypes = types
    return lib


def load_module(path: Path, name: str):
    """The module at ``path`` (another checkout's) loaded as ``name``
    beside this checkout's (registered first: dataclasses look their
    module up)."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod
    spec.loader.exec_module(mod)
    return mod


def stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def queued(lib, fn, iters: int) -> dict:
    """``fn``'s device ms a call with the stream held while ``iters`` calls
    are enqueued, the host ms a call to enqueue, and CUDA events around
    the calls back to back."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    lib.probe_spin(SPIN_NS, stream())
    a.record()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    host = time.perf_counter() - t0
    b.record()
    b.synchronize()
    dev = a.elapsed_time(b) / iters
    held = host * 1e9 < SPIN_NS
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    b.synchronize()
    return {"device_ms": dev, "host_ms": host * 1e3 / iters,
            "back_to_back_ms": a.elapsed_time(b) / iters, "held": held}


def host_ms(fn, iters: int) -> float:
    """Host ms a call of ``fn``, after one call."""
    fn()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    return (time.perf_counter() - t0) * 1e3 / iters


class Capture:
    """Wraps ``module.name`` while installed, keeping every call's
    arguments."""

    def __init__(self, module, name: str):
        self.module, self.name, self.calls = module, name, []

    def __enter__(self):
        self.real = getattr(self.module, self.name)

        def spy(*a, **kw):
            self.calls.append((a, kw))
            return self.real(*a, **kw)

        spy.launches = getattr(self.real, "launches", 0)
        setattr(self.module, self.name, spy)
        return self

    def __exit__(self, *exc):
        if hasattr(self.real, "launches"):
            self.real.launches = getattr(self.module, self.name).launches
        setattr(self.module, self.name, self.real)
