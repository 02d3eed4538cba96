"""Chunk sizes of the steps that read their raw set in chunks — the
port of `shifu_tpu/processor/chunking.py`: the streaming trigger
`chunk_rows_for` (shared with stats, norm and eval),
`analysis_chunk_rows` (the exact chunked correlation, PSI and
posttrain), and varselect's `analysis_frame`: None while the set fits
resident, else a uniform row sample of at most
SHIFU_TPU_ANALYSIS_MAX_ROWS rows read in chunks (`sampled_frame`),
cached on the context. Rows are picked by `splitmix64_uniform` of the
global row index, so the sample equals the JAX package's row for row.
The sharded readers are ROADMAP A8.3.
"""

from __future__ import annotations

import logging
import os
from typing import Optional

import numpy as np

from shifu_tpu_torch.config.environment import knob_int, knob_raw
from shifu_tpu_torch.data import fs as fs_mod
from shifu_tpu_torch.data.reader import Table, expand_data_files, is_parquet
from shifu_tpu_torch.data.sampling import splitmix64_uniform

__all__ = ["chunk_rows_for", "analysis_chunk_rows", "analysis_frame",
           "sampled_frame", "splitmix64_uniform"]

log = logging.getLogger("shifu_tpu_torch")


def chunk_rows_for(ctx, env_keys, byte_env: str, data_path: str,
                   label: str, default_rows: int = 2_000_000) -> int:
    """The JAX package's streaming trigger (`processor/chunking.
    chunk_rows_for`): 0 = resident. Explicit through any of `env_keys`
    (first set wins; '0' forces resident); automatic when the raw
    files' estimated decompressed size passes the `byte_env` knob
    (default 2 GB; gzip/bz2 parts count 6×, parquet parts 4× for their
    columnar compression)."""
    for k in env_keys:
        v = knob_raw(k) if k.startswith("SHIFU_TPU_") else os.environ.get(k)
        if v is not None and str(v).strip() != "":
            try:
                return max(int(float(v)), 0)
            except (TypeError, ValueError):
                raise ValueError(
                    f"{label} chunkRows must be an integer, got {v!r}")
    try:
        files = expand_data_files(ctx.model_config.resolve_path(data_path))
        total = sum(_stored_size(p) * (6 if p.endswith((".gz", ".bz2"))
                                       else 4 if is_parquet(p) else 1)
                    for p in files)
    except (OSError, FileNotFoundError, ValueError, RuntimeError) as e:
        log.warning("%s: could not estimate raw data size (%s) — "
                    "streaming auto-trigger disabled, resident read", label,
                    e)
        return 0
    return default_rows if total > knob_int(byte_env) else 0


def _stored_size(p: str) -> int:
    """A part file's bytes on storage: `fs.size` for a ``scheme://``
    part, 0 for a local one that is gone."""
    if fs_mod.has_scheme(p):
        return int(fs_mod.size(p))
    return os.path.getsize(p) if os.path.exists(p) else 0


def analysis_chunk_rows(ctx) -> int:
    """0 when the raw set fits resident; else the chunk size for the
    exact chunked analysis passes (posttrain): their statistics (bin
    score sums, squared ablation deltas) merge exactly across chunks,
    so they never sample."""
    mc = ctx.model_config
    return chunk_rows_for(ctx, ("shifu.analysis.chunkRows",
                                "SHIFU_TPU_ANALYSIS_CHUNK_ROWS"),
                          "SHIFU_TPU_ANALYSIS_STREAM_BYTES",
                          mc.dataSet.dataPath, "analysis")


def _frame_bytes(df: Table) -> float:
    """What the JAX package takes as a raw chunk's memory (pandas'
    ``memory_usage(deep=False).sum()`` of its Arrow-string frame): the
    UTF-8 bytes of every value plus an 8-byte offset each, and 132 bytes
    of RangeIndex. Its `sampled_frame` sizes the sampling rate by it."""
    total = 132.0
    for name in df.columns:
        col = np.asarray(df[name])
        if col.dtype.kind == "U":
            total += float(np.char.str_len(np.char.encode(col, "utf-8"))
                           .sum()) + 8.0 * len(col)
        else:
            total += float(col.nbytes)
    return total


def sampled_frame(mc, cap_rows: int, chunk_rows: int = 1_000_000,
                  seed: int = 12306) -> Optional[Table]:
    """A uniform sample of about `cap_rows` rows of the raw table, read
    in chunks so host memory stays bounded. A row is kept when the
    splitmix64 uniform of its global index falls below a rate set from
    the first chunk (the whole file is always scanned, so an
    over-estimated rate cannot turn into a prefix of the file); a sample
    over the cap is thinned by a second, independent hash. None when no
    row is kept."""
    from shifu_tpu_torch.data.pipeline import prefetch
    from shifu_tpu_torch.data.reader import iter_raw_table

    frames = []
    rate = None
    start = 0
    for df in prefetch(iter_raw_table(mc, chunk_rows=chunk_rows)):
        if rate is None:
            # total rows estimated from the first chunk's bytes a row
            # (compressed parts at the trigger's 6× text expansion)
            try:
                files = expand_data_files(
                    mc.resolve_path(mc.dataSet.dataPath))
                total_bytes = sum(
                    _stored_size(p)
                    * (6 if p.endswith((".gz", ".bz2")) else 1)
                    for p in files)
                row_bytes = max(_frame_bytes(df) / max(len(df), 1), 1.0)
                est_rows = max(total_bytes / (row_bytes * 0.5), len(df))
            except (OSError, ValueError, RuntimeError):
                est_rows = len(df) * 10
            rate = min(1.0, cap_rows / max(est_rows, 1.0))
        sel = splitmix64_uniform(start, len(df), seed,
                                 purpose="analysis-sample") < rate
        start += len(df)
        if sel.any():
            frames.append(df.select(sel))
    out = Table.concat(frames) if frames else None
    if out is not None and len(out) > cap_rows:
        # thin uniformly by an independent hash, not by a prefix
        u = splitmix64_uniform(0, len(out), seed, purpose="thin")
        out = out.select(np.sort(np.argsort(u)[:cap_rows]))
    return out


def analysis_frame(ctx, log_to: Optional[logging.Logger] = None
                   ) -> Optional[Table]:
    """The raw table varselect's SE/ST/V filters read: None when the set
    fits resident (the step reads it whole), else `sampled_frame` of at
    most SHIFU_TPU_ANALYSIS_MAX_ROWS rows. The sample is cached on the
    context, so a recursive varselect scans the raw set once."""
    cached = getattr(ctx, "_analysis_frame", "unset")
    if not isinstance(cached, str):
        return cached
    mc = ctx.model_config
    chunk = analysis_chunk_rows(ctx)
    if not chunk:
        ctx._analysis_frame = None
        return None
    cap = knob_int("SHIFU_TPU_ANALYSIS_MAX_ROWS")
    (log_to or log).warning(
        "dataset exceeds the resident threshold — analysis step runs on "
        "a ~%d-row uniform sample (SHIFU_TPU_ANALYSIS_MAX_ROWS)", cap)
    out = sampled_frame(mc, cap, chunk_rows=chunk)
    ctx._analysis_frame = out
    return out
