"""Chunk sizes of the steps that read their raw set in chunks — the
port's part of `shifu_tpu/processor/chunking.py`: the streaming trigger
`chunk_rows_for` (shared with stats, norm and eval),
`analysis_chunk_rows` (posttrain) and `analysis_frame` (varselect). The
sampled frame past the trigger (`sampled_frame`) is ROADMAP A6, and the
sharded readers A8.
"""

from __future__ import annotations

import logging
import os

from shifu_tpu_torch.config.environment import knob_int, knob_raw
from shifu_tpu_torch.data.reader import expand_data_files

log = logging.getLogger("shifu_tpu_torch")


def chunk_rows_for(ctx, env_keys, byte_env: str, data_path: str,
                   label: str, default_rows: int = 2_000_000) -> int:
    """The JAX package's streaming trigger (`processor/chunking.
    chunk_rows_for`): 0 = resident. Explicit through any of `env_keys`
    (first set wins; '0' forces resident); automatic when the raw
    files' estimated decompressed size passes the `byte_env` knob
    (default 2 GB; gzip/bz2 parts count 6×)."""
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
        total = sum((os.path.getsize(p) if os.path.exists(p) else 0)
                    * (6 if p.endswith((".gz", ".bz2")) else 1)
                    for p in files)
    except (OSError, FileNotFoundError, ValueError, RuntimeError) as e:
        log.warning("%s: could not estimate raw data size (%s) — "
                    "streaming auto-trigger disabled, resident read", label,
                    e)
        return 0
    return default_rows if total > knob_int(byte_env) else 0


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


def analysis_frame(ctx):
    """The raw table varselect's SE/ST/V/FI filters read: None when the
    set fits resident (the step reads it whole). Past the trigger the
    JAX package reads a uniform row sample (`sampled_frame`), which the
    port has not yet: it raises."""
    if analysis_chunk_rows(ctx):
        raise NotImplementedError(
            "varselect: the dataset is past the analysis trigger, where "
            "the JAX package reads a sampled analysis frame; that frame "
            "is not ported yet (ROADMAP A6) — set "
            "SHIFU_TPU_ANALYSIS_CHUNK_ROWS=0 to read it whole")
    return None
