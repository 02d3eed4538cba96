"""Delimited-text ingestion: raw files → a `Table` of numpy columns.

The port's copy of the resident half of `shifu_tpu/data/reader.py`
(`expand_data_files`, `read_header`, `simple_column_name`,
`missing_mask`, `_table_layout`, `read_raw_table`). The JAX package
returns a pandas frame; the port returns a `Table` — an ordered mapping
from column name to a 1-D numpy array (str, or float32 for
`numeric_columns` read through the C parser).

Two routes, picked by the input as in the JAX package:

- uncompressed files with `numeric_columns` and no `max_rows` → the C
  parser (`data/native_reader.py`, `native/fast_reader.c`): numeric
  columns parse straight to float32 with `strtof`, the rest come back
  as stripped strings;
- otherwise (gzip/bz2 parts, init's `max_rows` sample read) → the text
  route, which reproduces pandas' `read_csv(dtype=str, na_filter=False,
  quoting=3)`: every value a string, no quote handling (`""` stays a
  two-character token), `\\r\\n` and lone `\\r` line ends, blank and
  whitespace-only lines skipped, short rows padded with "".

`iter_raw_table` yields the text route's tables in chunks, as the JAX
package's chunked reader does for delimited text: the streaming stats,
norm and eval, the chunked correlation and PSI, posttrain past the size
trigger, varselect's sampled frame and eval's audit read through it.

Not ported: parquet input (needs pyarrow; ROADMAP A9), remote
filesystems (ROADMAP A8.4), the pod-sharded read and the
sharded/broadcast chunk iterators (A8.3); parquet and remote paths
raise and name their queue item. Of pandas' compressions only gzip and
bz2 are read.
"""

from __future__ import annotations

import glob
import itertools
import os
import re
from typing import (Dict, Iterable, Iterator, List, Mapping, Optional,
                    Sequence)

import numpy as np

from shifu_tpu_torch.fileio import has_scheme
from shifu_tpu_torch.resilience import retrying

_SKIP_BASENAMES = {"_SUCCESS", ".pig_header", ".pig_schema"}


class Table:
    """Ordered name → 1-D numpy column, all of one length: the port's
    stand-in for the string-typed pandas frame of the JAX package.
    String columns are numpy unicode arrays; numeric columns read by
    the C parser are float32 with NaN for missing."""

    def __init__(self, columns: Mapping[str, np.ndarray],
                 n_rows: Optional[int] = None):
        self._cols: Dict[str, np.ndarray] = dict(columns)
        lens = {len(v) for v in self._cols.values()}
        if len(lens) > 1:
            raise ValueError(f"columns of different lengths: {sorted(lens)}")
        self._n = lens.pop() if lens else int(n_rows or 0)

    @property
    def columns(self) -> List[str]:
        return list(self._cols)

    def __len__(self) -> int:
        return self._n

    def __getitem__(self, name: str) -> np.ndarray:
        return self._cols[name]

    def __contains__(self, name: object) -> bool:
        return name in self._cols

    def select(self, rows: np.ndarray) -> "Table":
        """The rows of a boolean mask or an index array, in order."""
        rows = np.asarray(rows)
        n = int(rows.sum()) if rows.dtype == bool else len(rows)
        return Table({k: v[rows] for k, v in self._cols.items()}, n)

    def with_columns(self, extra: Mapping[str, np.ndarray]) -> "Table":
        cols = dict(self._cols)
        cols.update(extra)
        return Table(cols, self._n)

    @staticmethod
    def concat(tables: Sequence["Table"]) -> "Table":
        if len(tables) == 1:
            return tables[0]
        names = tables[0].columns
        return Table({k: np.concatenate([t[k] for t in tables])
                      for k in names}, sum(len(t) for t in tables))


def string_column(values: np.ndarray) -> np.ndarray:
    """`df[col].astype(str).str.strip()` of the JAX package."""
    return np.char.strip(np.asarray(values).astype(str, copy=False))


def _remote(path: str) -> NotImplementedError:
    return NotImplementedError(
        f"{path}: remote filesystems are not ported yet (ROADMAP A8.4); "
        "use a local path")


def is_parquet(path: str) -> bool:
    """Columnar input files, dispatched by extension like the JAX
    package's `is_parquet`."""
    return path.split("?")[0].lower().endswith((".parquet", ".parq"))


def _no_parquet(path: str) -> NotImplementedError:
    return NotImplementedError(
        f"{path}: parquet input needs pyarrow and is not ported yet "
        "(ROADMAP A9); convert it to delimited text")


def expand_data_files(data_path: str) -> List[str]:
    """A dataPath may be a file, a glob, or a directory of part files
    (Hadoop layout); hidden/marker files are skipped."""
    if has_scheme(data_path):
        raise _remote(data_path)
    if os.path.isdir(data_path):
        files = sorted(
            p for p in glob.glob(os.path.join(data_path, "*"))
            if os.path.isfile(p) and os.path.basename(p) not in _SKIP_BASENAMES
            and not os.path.basename(p).startswith((".", "_")))
    elif os.path.isfile(data_path):
        files = [data_path]
    else:
        files = sorted(p for p in glob.glob(data_path) if os.path.isfile(p))
    if not files:
        raise FileNotFoundError(f"no data files under {data_path!r}")
    return files


def _opener_for(path: str):
    """Text-mode opener with universal newlines (\\r\\n and \\r end a
    line, as they do for pandas' C tokenizer)."""
    if path.endswith(".gz"):
        import gzip
        return lambda p: gzip.open(p, "rt", encoding="utf-8")
    if path.endswith(".bz2"):
        import bz2
        return lambda p: bz2.open(p, "rt", encoding="utf-8")
    if path.endswith((".zip", ".xz", ".zst")):
        raise NotImplementedError(
            f"{path}: only gzip and bz2 part files are read; convert it")
    return lambda p: open(p, "rt", encoding="utf-8")


def read_header(ds, base_resolver=None) -> List[str]:
    """Column names from headerPath (one delimiter-joined line), else
    the first line of the first data file (`CommonUtils.getHeaders`)."""
    resolve = base_resolver or (lambda p: p)
    if ds.headerPath:
        hp = resolve(ds.headerPath)
        if has_scheme(hp):
            raise _remote(hp)
        with open(hp, encoding="utf-8") as f:
            line = f.readline().rstrip("\r\n")
        delim = ds.headerDelimiter or "|"
    else:
        files = expand_data_files(resolve(ds.dataPath))
        if is_parquet(files[0]):
            raise _no_parquet(files[0])
        with _opener_for(files[0])(files[0]) as f:
            line = f.readline().rstrip("\r\n")
        delim = ds.dataDelimiter or "|"
    return [c.strip() for c in line.split(delim)]


def simple_column_name(name: str) -> str:
    """NSColumn semantics: 'namespace::col' matches by its simple name."""
    return name.split("::")[-1].strip()


def _table_layout(mc, ds):
    """(ds, header, files, first_file, has_header_line, simple_names);
    simple_names is None when NSColumn simple names collide."""
    ds = ds or mc.dataSet
    header = read_header(ds, mc.resolve_path)
    files = expand_data_files(mc.resolve_path(ds.dataPath))
    bad = [p for p in files if is_parquet(p)]
    if bad:
        raise _no_parquet(bad[0])
    has_header_line = not ds.headerPath
    simple = [simple_column_name(c) for c in header]
    if len(set(simple)) != len(simple):
        simple = None
    return ds, header, files, files[0], has_header_line, simple


def _iter_text_lines(path: str, skip: int) -> Iterator[str]:
    """The data lines of one file: `skip` leading lines dropped, blank
    and whitespace-only lines skipped (pandas' skip_blank_lines)."""
    with _opener_for(path)(path) as f:
        for i, line in enumerate(f):
            if i < skip:
                continue
            if line.endswith("\n"):
                line = line[:-1]
            if line.strip(" \t"):
                yield line


def _rows_table(rows: List[str], names: Sequence[str], delim: str,
                path: str, first_row: int = 0) -> Table:
    """Data lines as all-string columns; a row with more fields than
    `names` raises, as pandas' tokenizer does, and short rows are padded
    with ""."""
    n = len(names)
    if not rows:
        return Table({c: np.zeros(0, dtype="<U1") for c in names}, 0)
    counts = np.fromiter((line.count(delim) for line in rows), np.int64,
                         len(rows))
    if counts.max() > n - 1:
        i = int(np.argmax(counts > n - 1))
        raise ValueError(f"{path}: data row {first_row + i + 1} has "
                         f"{counts[i] + 1} fields, the header {n}")
    if counts.min() < n - 1:      # short rows: pad with ""
        rows = [line + delim * (n - 1 - int(k))
                for line, k in zip(rows, counts)]
    flat = delim.join(rows).split(delim)
    return Table({c: np.asarray(flat[j::n], dtype=str)
                  for j, c in enumerate(names)}, len(rows))


def read_text_file(path: str, names: Sequence[str], delim: str,
                   skip: int = 0, limit: Optional[int] = None) -> Table:
    """One delimited file as all-string columns — pandas'
    ``read_csv(sep=delim, header=None, names=names, dtype=str,
    na_filter=False, quoting=3, skiprows=skip, nrows=limit)``."""
    lines = _iter_text_lines(path, skip)
    if limit is not None:
        lines = itertools.islice(lines, max(limit, 0))
    return _rows_table(list(lines), names, delim, path)


def iter_raw_table(mc, ds=None, chunk_rows: int = 2_000_000
                   ) -> Iterator[Table]:
    """Yield `Table`s of at most `chunk_rows` all-string rows across
    the part files, the header line skipped in the first file only:
    the chunks of the JAX package's `iter_raw_table` over delimited
    text (pandas' ``read_csv(..., chunksize=chunk_rows)`` a file, so a
    file's last chunk may be short), row for row. Sequential itself: the
    streaming steps read it ahead on a thread (`data/pipeline.prefetch`,
    `map_stream`)."""
    ds, header, files, first_file, has_header_line, simple = \
        _table_layout(mc, ds)
    names = simple if simple is not None else list(header)
    delim = ds.dataDelimiter or "|"
    for path in files:
        skip = 1 if (has_header_line and path == first_file) else 0
        lines = _iter_text_lines(path, skip)
        done = 0
        while True:
            rows = list(itertools.islice(lines, chunk_rows))
            if not rows:
                break
            yield _rows_table(rows, names, delim, path, done)
            done += len(rows)


def read_raw_table(mc, ds=None, max_rows: Optional[int] = None,
                   numeric_columns: Optional[Sequence[str]] = None
                   ) -> Table:
    """The raw dataset as a `Table` under the header's (simple) column
    names: all strings, except that `numeric_columns` come back float32
    (missing/invalid tokens NaN) when the C parser reads them — the
    route for uncompressed files with `numeric_columns` and no
    `max_rows`."""
    ds, header, files, first_file, has_header_line, simple = \
        _table_layout(mc, ds)
    names = simple if simple is not None else list(header)
    delim = ds.dataDelimiter or "|"
    if numeric_columns and max_rows is None and \
            not any(p.endswith((".gz", ".bz2")) for p in files):
        from shifu_tpu_torch.data.native_reader import read_files_native
        return read_files_native(
            files, names, delim, [c for c in numeric_columns if c in names],
            skip_first_row_of=(first_file if has_header_line else None))
    tables = []
    rows_left = max_rows
    for path in files:
        skip = 1 if (has_header_line and path == first_file) else 0
        # retried: a file's read is idempotent, and a mount can flake
        t = retrying("reader.read", read_text_file, path, names, delim,
                     skip, rows_left)
        tables.append(t)
        if rows_left is not None:
            rows_left -= len(t)
            if rows_left <= 0:
                break
    return Table.concat(tables)


def missing_mask(values: np.ndarray,
                 missing_values: Sequence[str]) -> np.ndarray:
    """Boolean mask of missing/invalid tokens
    (dataSet#missingOrInvalidValues)."""
    miss = set(missing_values)
    return np.isin(values, list(miss)) if miss \
        else np.zeros(len(values), bool)


# ---------------------------------------------------------------------------
# pandas' numeric parse, without pandas
# ---------------------------------------------------------------------------

# what `pd.to_numeric(errors="coerce")` accepts once the token is
# stripped: decimal and exponent forms and inf/infinity in any case;
# "nan" parses to NaN (so it counts as not parsed), and underscores,
# hex, unicode digits and every other token are NaN too
_NUMBER = re.compile(
    r"[+-]?(?:(?:[0-9]+\.?[0-9]*|\.[0-9]+)(?:[eE][+-]?[0-9]+)?"
    r"|[iI][nN][fF](?:[iI][nN][iI][tT][yY])?)")


def to_numeric(values: Iterable) -> np.ndarray:
    """float64 values of string tokens under `pd.to_numeric(...,
    errors="coerce")`'s rules, NaN where a token does not parse. Values
    agree with pandas once rounded to float32 (pandas' own decimal
    parser can sit one double ulp off a 17-digit token). Tokens of
    digits, signs, points and exponents parse in one vectorized call;
    the rest, one distinct token at a time."""
    arr = np.asarray(values)
    if arr.dtype.kind in "fiub":
        return arr.astype(np.float64)
    s = np.char.strip(arr.astype(str, copy=False))
    out = np.full(s.shape, np.nan)
    plain = (np.char.strip(s, "0123456789.eE+-") == "") & (s != "")
    if plain.any():
        sub = s[plain]
        try:
            out[plain] = sub.astype(np.float64)
        except ValueError:           # a malformed token such as "1e"
            out[plain] = _parse_each(sub)
    if not plain.all():
        out[~plain] = _parse_each(s[~plain])
    return out


def _parse_each(tokens: np.ndarray) -> np.ndarray:
    uniq, inv = np.unique(tokens, return_inverse=True)
    vals = np.asarray([float(t) if _NUMBER.fullmatch(t) else np.nan
                       for t in uniq.tolist()], np.float64)
    return vals[inv.reshape(-1)] if len(tokens) else vals
