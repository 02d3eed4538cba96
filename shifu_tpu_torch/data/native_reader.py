"""The C route of the reader: part files → a mixed-dtype `Table`
(float32 numeric columns, stripped strings for the rest).

The port's copy of `shifu_tpu/data/native_reader.py` over its own copy
of the parser, `shifu_tpu_torch/native/fast_reader.c`. The source is
built with the host C compiler (`cc`, else `gcc`) at first use into
``shifu_tpu_torch/build/libfast_reader-<hash>.so``, the hash being the
source's, as `_build.py` names the CUDA libraries; a build or a parse
that fails raises (the JAX package falls back to pandas instead).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from shifu_tpu_torch.data.reader import Table

_HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_HERE, "native", "fast_reader.c")
BUILD_DIR = os.path.join(_HERE, "build")
CC_FLAGS = ["-O3", "-shared", "-fPIC", "-pthread"]

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def lib_path(build_dir: str = BUILD_DIR) -> str:
    with open(SOURCE, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    return os.path.join(build_dir, f"libfast_reader-{digest}.so")


def build(build_dir: str = BUILD_DIR) -> str:
    """Compile `fast_reader.c` into `build_dir` unless its library is
    there already; returns the library's path. Raises when no compiler
    builds it."""
    out = lib_path(build_dir)
    if os.path.exists(out):
        return out
    os.makedirs(build_dir, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    errors = []
    for cc in ("cc", "gcc"):
        try:
            r = subprocess.run([cc, *CC_FLAGS, SOURCE, "-o", tmp],
                               capture_output=True, text=True, timeout=120)
        except (FileNotFoundError, subprocess.TimeoutExpired) as e:
            errors.append(f"{cc}: {e}")
            continue
        if r.returncode == 0:
            os.replace(tmp, out)
            return out
        errors.append(f"{cc} (rc {r.returncode}): {r.stderr[-2000:]}")
    if os.path.exists(tmp):
        os.remove(tmp)
    raise RuntimeError("cannot build shifu_tpu_torch/native/fast_reader.c:\n"
                       + "\n".join(errors))


def load(build_dir: str = BUILD_DIR) -> ctypes.CDLL:
    """The parser's library, built first if needed, with its argument
    types declared."""
    with _lock:
        path = build(build_dir)
        lib = _libs.get(path)
        if lib is None:
            lib = ctypes.CDLL(path)
            i32p = ctypes.POINTER(ctypes.c_int32)
            i64p = ctypes.POINTER(ctypes.c_int64)
            f32p = ctypes.POINTER(ctypes.c_float)
            lib.ft_parse_file.restype = ctypes.c_int64
            lib.ft_parse_file.argtypes = [
                ctypes.c_char_p, ctypes.c_char, ctypes.c_int, ctypes.c_int,
                i32p, ctypes.c_int, f32p,
                i32p, ctypes.c_int, i64p, i32p, ctypes.c_int]
            lib.ft_count_file_rows.restype = ctypes.c_int64
            lib.ft_count_file_rows.argtypes = [ctypes.c_char_p, ctypes.c_int]
            _libs[path] = lib
        return lib


def _gather_strings(blob: np.ndarray, off: np.ndarray,
                    lens: np.ndarray) -> np.ndarray:
    """(offset, len) slices → str array: one gather into an (R, maxlen)
    byte matrix, then a vectorized utf-8 decode."""
    r = len(off)
    w = max(int(lens.max()) if r else 1, 1)
    pos = np.arange(w, dtype=np.int64)[None, :]
    idx = off[:, None] + pos
    valid = pos < lens[:, None].astype(np.int64)
    mat = np.where(valid, blob[np.clip(idx, 0, len(blob) - 1)],
                   0).astype(np.uint8)
    fixed = np.frombuffer(mat.reshape(r * w).tobytes(), dtype=f"S{w}")
    try:
        return fixed.astype(f"U{w}")      # ASCII fast path
    except UnicodeDecodeError:
        pass
    try:
        return np.char.decode(fixed, "utf-8")
    except UnicodeDecodeError:
        return np.array([b.decode("utf-8", "replace") for b in fixed])


def read_files_native(files: Sequence[str], header: List[str], delim: str,
                      numeric_columns: Sequence[str],
                      skip_first_row_of: Optional[str] = None,
                      n_threads: int = 8,
                      build_dir: str = BUILD_DIR) -> Table:
    """Parse uncompressed part files with the C parser: numeric columns
    float32 (NaN = missing/unparseable), the others strings trimmed of
    spaces, tabs and a trailing \\r."""
    lib = load(build_dir)
    n_cols = len(header)
    num_set = set(numeric_columns)
    num_names = [c for c in header if c in num_set]
    str_names = [c for c in header if c not in num_set]
    num_idx = np.full(n_cols, -1, np.int32)
    str_idx = np.full(n_cols, -1, np.int32)
    for slot, name in enumerate(num_names):
        num_idx[header.index(name)] = slot
    for slot, name in enumerate(str_names):
        str_idx[header.index(name)] = slot
    i32p = ctypes.POINTER(ctypes.c_int32)
    i64p = ctypes.POINTER(ctypes.c_int64)
    f32p = ctypes.POINTER(ctypes.c_float)

    per_file: List[Tuple[np.ndarray, Dict[str, np.ndarray]]] = []
    for path in files:
        skip = 1 if path == skip_first_row_of else 0
        n_rows = int(lib.ft_count_file_rows(path.encode(), skip))
        if n_rows < 0:
            raise OSError(f"fast_reader cannot open {path}")
        if n_rows == 0:
            continue
        num_out = np.full((n_rows, max(len(num_names), 1)), np.nan,
                          np.float32)
        off = np.zeros((n_rows, max(len(str_names), 1)), np.int64)
        lens = np.zeros((n_rows, max(len(str_names), 1)), np.int32)
        got = int(lib.ft_parse_file(
            path.encode(), ctypes.c_char(delim.encode()[:1]), skip, n_cols,
            num_idx.ctypes.data_as(i32p), len(num_names),
            num_out.ctypes.data_as(f32p),
            str_idx.ctypes.data_as(i32p), len(str_names),
            off.ctypes.data_as(i64p), lens.ctypes.data_as(i32p),
            n_threads))
        if got != n_rows:
            raise RuntimeError(f"fast_reader parsed {got} rows of {path}, "
                               f"counted {n_rows}")
        blob = np.memmap(path, dtype=np.uint8, mode="r")
        str_cols = {name: _gather_strings(blob, off[:, slot], lens[:, slot])
                    for slot, name in enumerate(str_names)}
        per_file.append((num_out[:, :len(num_names)], str_cols))

    if not per_file:
        raise FileNotFoundError(f"no rows in {list(files)!r}")
    num_all = np.concatenate([p[0] for p in per_file], axis=0)
    cols: Dict[str, np.ndarray] = {}
    for name in header:
        if name in num_set:
            cols[name] = num_all[:, num_names.index(name)]
        else:
            cols[name] = np.concatenate([p[1][name] for p in per_file])
    return Table(cols, len(num_all))
