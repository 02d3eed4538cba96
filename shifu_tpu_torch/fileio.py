"""Atomic local writes — the port's copy of the parts of
`shifu_tpu/resilience.py` (`atomic_path`, `atomic_write`) and
`shifu_tpu/data/fs.py` (`has_scheme`) that the config files and model
specs need. The ``atomic.commit`` fault site fires just before each
rename, so ``SHIFU_TPU_FAULT=atomic.commit:kill:1`` kills a step
between its staged output and its publication.

Remote (``scheme://``) paths are not ported yet: `atomic_write` raises
on them, and `has_scheme` lets callers detect them first.
"""

from __future__ import annotations

import contextlib
import os
import re
import shutil
from typing import IO, Iterator

from shifu_tpu_torch.resilience import fault_point

_SCHEME_RE = re.compile(r"^[a-zA-Z][a-zA-Z0-9+.\-]*://")


def has_scheme(path: str) -> bool:
    """True for URL-style paths (hdfs://, s3://, gs://, memory://...)."""
    return bool(path) and bool(_SCHEME_RE.match(path))


def _tmp_name(path: str) -> str:
    d, base = os.path.split(path)
    return os.path.join(d, f".tmp.{os.getpid()}.{base}")


def _scrub(tmp: str) -> None:
    if os.path.isdir(tmp):
        shutil.rmtree(tmp, ignore_errors=True)
    elif os.path.exists(tmp):
        os.remove(tmp)


@contextlib.contextmanager
def atomic_path(path: str) -> Iterator[str]:
    """Yield a dot-prefixed sibling temp path that keeps the extension;
    on clean exit replace `path` with it, on error remove it."""
    tmp = _tmp_name(path)
    try:
        yield tmp
        fault_point("atomic.commit")
        if os.path.isdir(path) and os.path.isdir(tmp):
            shutil.rmtree(path)
        os.replace(tmp, path)
    except BaseException:
        _scrub(tmp)
        raise


@contextlib.contextmanager
def atomic_write(path: str, mode: str = "w", **open_kwargs) -> Iterator[IO]:
    """``open()``-shaped atomic file write: the handle points at a temp
    file that is fsynced and renamed onto `path` only on clean exit."""
    if has_scheme(path):
        raise NotImplementedError(
            f"{path}: remote filesystems are not ported yet (the "
            "streaming/remote-data slice); write to a local path")
    tmp = _tmp_name(path)
    _scrub(tmp)
    f = open(tmp, mode, **open_kwargs)
    try:
        yield f
        f.flush()
        os.fsync(f.fileno())
        f.close()
        fault_point("atomic.commit")
        os.replace(tmp, path)
    except BaseException:
        if not f.closed:
            f.close()
        _scrub(tmp)
        raise
