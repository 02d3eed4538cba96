"""Multi-scheme filesystem dispatch — the port's copy of
`shifu_tpu/data/fs.py`.

Plain paths stay on the local code path (the C reader included), while
`hdfs://`, `s3://`, `s3a://`, `gs://`, `file://`, `memory://`, ...
paths go through `fsspec` (`fs/ShifuFileUtils.java` SourceType
dispatch). A scheme's backend may need its own package (s3fs, gcsfs,
pyarrow for hdfs); a clear error names what is missing. `memory://` is
fsspec's in-process filesystem, which the tests use to drive the remote
route without a cluster. Every call is retried under its `fs.*` fault
site (`resilience.retrying`). The scheme test is `fileio.has_scheme`.
"""

from __future__ import annotations

from typing import List

from shifu_tpu_torch.fileio import has_scheme
from shifu_tpu_torch.resilience import retrying

__all__ = ["has_scheme", "readahead_hints", "open_text", "exists", "size",
           "list_data_files"]


def _fs_and_path(path: str):
    try:
        import fsspec
    except ImportError as e:  # pragma: no cover - fsspec ships in-image
        raise RuntimeError(
            f"path {path!r} needs fsspec for remote filesystems; "
            "pip install fsspec (+ the scheme's backend, e.g. s3fs/gcsfs)"
        ) from e
    try:
        return fsspec.core.url_to_fs(path)
    except (ImportError, ValueError) as e:
        raise RuntimeError(
            f"no filesystem backend for {path!r}: {e} — install the "
            "scheme's fsspec backend (s3fs for s3://, gcsfs for gs://, "
            "pyarrow for hdfs://)") from e


def readahead_hints() -> dict:
    """fsspec caching hints for sequential remote scans: a readahead
    cache with a multi-MiB block turns many small range requests into a
    few large ones. SHIFU_TPU_FS_CACHE_TYPE ("none" = the backend's
    default) and SHIFU_TPU_FS_BLOCK_SIZE (0 = the backend's default)
    tune or disable the hints."""
    from shifu_tpu_torch.config.environment import knob_int, knob_str
    hints = {}
    ct = (knob_str("SHIFU_TPU_FS_CACHE_TYPE") or "").lower()
    if ct and ct != "none":
        hints["cache_type"] = ct
    bs = knob_int("SHIFU_TPU_FS_BLOCK_SIZE")
    if bs > 0:
        hints["block_size"] = bs
    return hints


def open_text(path: str, mode: str = "rt"):
    """Open a (possibly remote, possibly compressed) file for reading."""
    import fsspec

    hints = readahead_hints()

    def _open():
        return fsspec.open(path, mode, compression="infer", **hints).open()

    return retrying("fs.open", _open)


def exists(path: str) -> bool:
    fs, p = _fs_and_path(path)
    return retrying("fs.exists", fs.exists, p)


def size(path: str) -> int:
    """On-storage byte size of one (possibly remote) file; 0 when the
    backend cannot stat it."""
    fs, p = _fs_and_path(path)
    try:
        return int(retrying("fs.size", fs.size, p) or 0)
    except OSError:
        return 0


def list_data_files(path: str, skip_basenames) -> List[str]:
    """File / directory-of-part-files / glob expansion for a remote
    path — the scheme-side twin of `reader.expand_data_files`. Returns
    full URLs (scheme kept) so later opens dispatch right; marker
    basenames and names starting with '.' or '_' are skipped."""
    fs, p = _fs_and_path(path)
    proto = fs.protocol if isinstance(fs.protocol, str) else fs.protocol[0]

    def url(q: str) -> str:
        return q if has_scheme(q) else \
            f"{proto}://{q.lstrip('/') if proto == 'memory' else q}"

    def _list() -> List[str]:
        if fs.isdir(p):
            names = sorted(fs.ls(p, detail=False))
            out = []
            for q in names:
                base = q.rstrip("/").rsplit("/", 1)[-1]
                if base in skip_basenames or base.startswith((".", "_")):
                    continue
                if fs.isfile(q):
                    out.append(url(q))
            return out
        if fs.isfile(p):
            return [url(p)]
        return [url(q) for q in sorted(fs.glob(p)) if fs.isfile(q)]

    return retrying("fs.list", _list)
