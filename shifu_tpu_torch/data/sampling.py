"""DataSampler-style row sampling shared by the stats and norm steps —
the port's copy of `shifu_tpu/data/sampling.py`, with
`splitmix64_uniform` copied from `shifu_tpu/processor/chunking.py`.

Stateless per-RAW-row uniforms (splitmix64) so any chunking — and the
resident whole-table read, which starts at row 0 — selects the
identical row set; `sampleNegOnly` keeps every positive (reference:
DataSampler.isNotSampled, `udf/NormalizeUDF.java:375-385`).
"""

from __future__ import annotations

import zlib
from typing import Optional

import numpy as np

from shifu_tpu_torch.data.reader import (Table, simple_column_name,
                                         string_column)

__all__ = ["positive_tag_mask", "sample_flags", "splitmix64_uniform"]


def splitmix64_uniform(start: int, n: int, seed: int,
                       purpose: str = "") -> np.ndarray:
    """(n,) uniforms in [0, 1) from a stateless splitmix64 hash of the
    global row indices start..start+n — identical for any chunking of
    the rows. `purpose` salts the stream so the val split, the stats
    sample and the norm sample are independent draws."""
    # crc32, not hash(): string hashing is randomized per process
    mixed = ((int(seed) | 1) + zlib.crc32(purpose.encode()) * 0x9E3779B9) \
        * 0x9E3779B97F4A7C15
    idx = np.arange(start, start + n, dtype=np.uint64)
    z = idx + np.uint64(mixed & 0xFFFFFFFFFFFFFFFF)
    z = (z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
    z = (z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    z = z ^ (z >> np.uint64(31))
    return z.astype(np.float64) / float(2 ** 64)


def positive_tag_mask(mc, df: Table) -> Optional[np.ndarray]:
    """(n,) bool: rows whose primary-task tag is a posTag — the
    keep-all-positives side of sampleNegOnly. None when the target
    column is absent from this table."""
    tgt_col = simple_column_name(mc.dataSet.targetColumnName.split("|")[0])
    if tgt_col not in df:
        return None
    return np.isin(string_column(df[tgt_col]), list(mc.pos_tags))


def sample_flags(rate: float, seed: int, start_row: int, n: int,
                 purpose: str,
                 keep_pos: Optional[np.ndarray] = None) -> np.ndarray:
    """(n,) bool sampling flags for raw rows start_row..start_row+n;
    rate >= 1 keeps everything."""
    if rate >= 1.0:
        return np.ones(n, bool)
    m = splitmix64_uniform(start_row, n, seed, purpose=purpose) < rate
    if keep_pos is not None:
        m |= keep_pos
    return m
