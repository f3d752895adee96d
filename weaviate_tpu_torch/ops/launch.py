"""What the wrappers of the hand-written kernels share on the host side of
a launch: a source's constants, the operands' contract check, the current
stream as the raw handle a C entry point takes, and the thread's device
set to a tensor's for the call."""

from __future__ import annotations

import contextlib
import re
from pathlib import Path

import torch


def source_ints(path: Path) -> dict:
    """The ``constexpr int`` constants that a kernel source defines."""
    return {name: int(v) for name, v in re.findall(
        r"^constexpr int (k\w+) = (\d+);", path.read_text(), re.M)}


def bad_operand(x, dtype, shape, dev: int) -> bool:
    """Whether ``x`` is not ``dtype`` and ``shape``, contiguous, on device
    ``dev`` (the index ``get_device`` gives, -1 the CPU): checked in the
    order of their cost."""
    return (x.dtype is not dtype or x.get_device() != dev
            or not x.is_contiguous() or x.shape != shape)


def raw_stream(index: int) -> int:
    """The current CUDA stream of device ``index`` as its ``cudaStream_t``
    (an int): what ``torch.cuda.current_stream(index).cuda_stream`` gives,
    without making a Python ``Stream`` object, which took about 8 µs of a
    launch's host part on an H100 host (``probe_rerank.py``'s floor)."""
    return torch._C._cuda_getCurrentRawStream(index)


def launch_on(dev: torch.device):
    """The thread's device set to ``dev`` for a launch (nothing to do where
    it is already)."""
    if dev.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(dev)
