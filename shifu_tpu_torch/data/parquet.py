"""Parquet part files — the port's copy of the parquet route of
`shifu_tpu/data/reader.py` (`_parquet_file`, `parquet_column_names`,
`_table_to_contract`, the bounded head read, the batch iterator and the
footer's row count).

This is the one module of the port that imports `pyarrow`, and only
inside its functions: `import shifu_tpu_torch` and every verb that reads
no parquet stay free of it. A part file becomes the reader's `Table`
under the text reader's contract:

- the header's names apply by position (a column count that differs
  from the header's raises);
- every column is a string column with a missing value as "" — the
  string form is an **arrow** cast from the stored type, so a stored
  int 5 reads '5' (a float64 detour, as pandas takes for a nullable
  int, would give '5.0' and miss every vocabulary learned from text);
- except `numeric_columns`, which come back float32 with NaN for
  missing: the JAX package's ``pd.to_numeric(errors="coerce")
  .astype(np.float32)`` without pandas. Numeric and bool columns go
  through numpy as pandas takes them (an int column with nulls through
  float64), timestamps and durations as their int64 counts of their
  unit (a null is NaN, where pandas' NaT wraps to the int64 minimum);
  any other type through its string form and `reader.to_numeric`, so
  an unparsable string is NaN.

`write_part` goes the other way: a `Table` as one part file (float
columns keep their type, NaN stored as null), as a Hadoop writer leaves
a parquet dataPath; `chip_smoke.py` writes its parquet sets with it.
"""

from __future__ import annotations

from typing import Iterator, List, Optional, Sequence

import numpy as np

from shifu_tpu_torch.data import fs as fs_mod

__all__ = ["column_names", "read_file", "iter_batches", "num_rows",
           "to_table", "write_part"]


def _parquet_file(path: str):
    import pyarrow.parquet as pq
    if fs_mod.has_scheme(path):
        return pq.ParquetFile(fs_mod.open_text(path, mode="rb"))
    return pq.ParquetFile(path)


def column_names(path: str) -> List[str]:
    """The schema's column names, from the footer: a parquet dataPath's
    header when the dataSet has no headerPath."""
    return [str(c) for c in _parquet_file(path).schema_arrow.names]


def num_rows(path: str) -> int:
    """Data rows of one part file from its footer, without decoding."""
    return max(int(_parquet_file(path).metadata.num_rows), 0)


def _float32(col) -> np.ndarray:
    """One arrow column as pandas' ``to_numeric(errors="coerce")`` then
    ``astype(float32)`` take it."""
    import pyarrow as pa
    import pyarrow.compute as pc
    t = col.type
    if pa.types.is_dictionary(t):
        col = col.cast(t.value_type)
        t = t.value_type
    if pa.types.is_integer(t) or pa.types.is_floating(t):
        # no nulls: the stored dtype; nulls: float64 with NaN
        return np.asarray(col.to_numpy(), dtype=np.float32)
    if pa.types.is_boolean(t) or pa.types.is_decimal(t):
        return np.asarray(pc.cast(col, pa.float64()).to_numpy(),
                          dtype=np.float32)
    if pa.types.is_timestamp(t) or pa.types.is_duration(t):
        return np.asarray(pc.cast(col, pa.int64()).to_numpy(),
                          dtype=np.float32)
    from shifu_tpu_torch.data.reader import to_numeric
    s = pc.fill_null(pc.cast(col, pa.string()), "")
    return to_numeric(np.asarray(s.to_pylist(), dtype=str)) \
        .astype(np.float32)


def _strings(col) -> np.ndarray:
    import pyarrow as pa
    import pyarrow.compute as pc
    s = pc.fill_null(pc.cast(col, pa.string()), "")
    return np.asarray(s.to_pylist(), dtype=str)


def to_table(tbl, header: Sequence[str], names: Sequence[str],
             numeric_columns: Optional[Sequence[str]] = None):
    """An arrow table (or batch) as the reader's `Table` under `names`
    (the header's simple names where they do not collide)."""
    from shifu_tpu_torch.data.reader import Table
    if tbl.num_columns != len(header):
        raise ValueError(
            f"parquet file has {tbl.num_columns} columns but the header "
            f"declares {len(header)}")
    num = set(numeric_columns or ())
    cols = {}
    for pos, name in enumerate(names):
        col = tbl.column(pos)
        cols[name] = _float32(col) if name in num else _strings(col)
    return Table(cols, tbl.num_rows)


def read_file(path: str, header: Sequence[str], names: Sequence[str],
              numeric_columns: Optional[Sequence[str]] = None,
              max_rows: Optional[int] = None):
    """One part file as a `Table`. With `max_rows` (init's type
    sampling) the read stops at the batch past `max_rows` instead of
    decoding the whole file — the text route's ``nrows``."""
    import pyarrow as pa
    pf = _parquet_file(path)
    if max_rows is None:
        return to_table(pf.read(), header, names, numeric_columns)
    batches, have = [], 0
    for b in pf.iter_batches(batch_size=max(max_rows, 1)):
        batches.append(b)
        have += len(b)
        if have >= max_rows:
            break
    tbl = pa.Table.from_batches(batches, schema=pf.schema_arrow) \
        .slice(0, max_rows)
    return to_table(tbl, header, names, numeric_columns)


def iter_batches(path: str, header: Sequence[str], names: Sequence[str],
                 chunk_rows: int) -> Iterator:
    """All-string `Table`s of at most `chunk_rows` rows, in pyarrow's
    batches (never the whole file): the columnar twin of the chunked
    text read."""
    import pyarrow as pa
    for batch in _parquet_file(path).iter_batches(batch_size=chunk_rows):
        yield to_table(pa.Table.from_batches([batch]), header, names)


def write_part(path: str, table, row_group_size: Optional[int] = None
               ) -> None:
    """One `Table` as a parquet part file at `path` (a local path or a
    ``scheme://`` URL): string columns as strings, float columns as
    their float type with NaN stored as null, integer columns as they
    are; written whole or in row groups of `row_group_size` rows."""
    import pyarrow as pa
    import pyarrow.parquet as pq
    cols = {}
    for name in table.columns:
        v = np.asarray(table[name])
        if v.dtype.kind == "f":
            cols[name] = pa.array(v, mask=np.isnan(v))
        elif v.dtype.kind in "US":
            cols[name] = pa.array(v.astype(str).tolist(), pa.string())
        else:
            cols[name] = pa.array(v)
    tbl = pa.table(cols)
    kw = {"row_group_size": row_group_size} if row_group_size else {}
    if fs_mod.has_scheme(path):
        import fsspec
        with fsspec.open(path, "wb") as f:
            pq.write_table(tbl, f, **kw)
    else:
        pq.write_table(tbl, path, **kw)
