"""Build and load the hand-written CUDA kernels.

Each `csrc/<name>.cu` has a plain C interface and compiles on its own
with `nvcc` for Hopper (``sm_90a``) into ``build/lib<name>-<hash>.so``
beside this file, at first use; the hash is of the source and of every
shared header in `csrc/` (`*.cuh`), so an edited kernel is rebuilt and
a stale library is never loaded. The libraries are
opened with `ctypes`. `build_all` starts one `nvcc` per source, all at
once, and waits for them together.

A build or load that fails raises: there is no fallback to the plain
PyTorch route on a CUDA tensor.
"""

from __future__ import annotations

import collections
import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Dict, Iterable, Iterator, List

import torch

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_HERE, "csrc")
BUILD_DIR = os.path.join(_HERE, "build")
SOURCES = ("fused_score", "fused_trees", "level_hist", "best_splits")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
_capture = threading.local()


def nvcc_path() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (PATH or /usr/local/cuda/bin); the "
                       "CUDA kernels of shifu_tpu_torch cannot be built")


def _lib_path(name: str) -> str:
    h = hashlib.sha256()
    headers = sorted(f for f in os.listdir(CSRC) if f.endswith(".cuh"))
    for f in [f"{name}.cu", *headers]:
        with open(os.path.join(CSRC, f), "rb") as fh:
            h.update(f.encode() + b"\0" + fh.read())
    digest = h.hexdigest()[:16]
    return os.path.join(BUILD_DIR, f"lib{name}-{digest}.so")


def _start(name: str, out: str, extra: Iterable[str]) -> subprocess.Popen:
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [nvcc_path(), *NVCC_FLAGS, *extra, "-o", tmp,
           os.path.join(CSRC, f"{name}.cu")]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def build_all(names: Iterable[str] = SOURCES,
              extra_flags: Iterable[str] = ()) -> Dict[str, str]:
    """Compile every listed source that has no current library, one
    `nvcc` each, all started together. Returns {name: compiler output}
    for the sources compiled now (``-Xptxas -v`` in `extra_flags` puts
    register and shared-memory use there)."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs: List = []
    for name in names:
        out = _lib_path(name)
        if not os.path.exists(out):
            procs.append((name, out, _start(name, out, extra_flags)))
    logs, failed = {}, []
    for name, out, p in procs:
        text, _ = p.communicate()
        logs[name] = text
        tmp = f"{out}.{os.getpid()}.tmp"
        if p.returncode != 0:
            failed.append(f"{name}.cu (rc {p.returncode}):\n{text}")
            if os.path.exists(tmp):
                os.remove(tmp)
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library of `csrc/<name>.cu`, built first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            path = _lib_path(name)
            if not os.path.exists(path):
                build_all([name])
            lib = ctypes.CDLL(path)
            _libs[name] = lib
        return lib


def check(rc: int, what: str, error_string) -> None:
    """Raise on a non-zero `cudaError_t` returned by a launch;
    `error_string` is the library's `cudaGetErrorString` export."""
    if rc != 0:
        msg = error_string(rc).decode(errors="replace")
        raise RuntimeError(f"{what}: CUDA launch failed: {msg} "
                           f"(cudaError_t {rc})")


def call_on(index: int, fn, *args):
    """`fn(*args)` with card `index` current, as a launch and a kernel
    attribute need: switches (and switches back) only when another card
    is current, so a serving launch on the current card pays one
    device query."""
    if torch.cuda.current_device() == index:
        return fn(*args)
    with torch.cuda.device(index):
        return fn(*args)


def raw_stream(device: torch.device) -> int:
    """The current CUDA stream of `device` as the handle a launch takes:
    `torch.cuda.current_stream(device).cuda_stream` without building a
    Stream object on every launch of a serving kernel."""
    return torch._C._cuda_getCurrentRawStream(device.index)


@contextlib.contextmanager
def capturing() -> Iterator[collections.Counter]:
    """While this thread captures a CUDA graph: a kernel wrapper records
    its launch in the yielded counter (name → launches) instead of its
    module's `launches`, since a captured kernel runs only when the
    graph is replayed, and the replay adds it there (`serve/aot.py`)."""
    prev = getattr(_capture, "counts", None)
    counts: collections.Counter = collections.Counter()
    _capture.counts = counts
    try:
        yield counts
    finally:
        _capture.counts = prev


def captured(name: str) -> bool:
    """True, and the launch of kernel `name` recorded in the capture's
    counter, when this thread is inside `capturing`; else False (the
    wrapper then counts the launch itself)."""
    counts = getattr(_capture, "counts", None)
    if counts is None:
        return False
    counts[name] += 1
    return True
