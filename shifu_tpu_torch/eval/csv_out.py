"""Vectorized CSV writing for eval outputs — the port's copy of
`format_block`, `write_rows` and `write_csv` from
`shifu_tpu/eval/csv_out.py`.

Each row is rendered by one printf-style format of the joined column
formats ("%s" columns through `astype(str)` first, as `np.char.mod`
would render them), the rows are joined once, and the block is written
in one call, chunked so peak memory stays bounded at
~chunk_rows formatted rows. The JAX package assembles the rows with
pandas' CSV writer (`QUOTE_NONE`); the port joins them itself, with the
same output: no quoting, and a field that holds the separator raises as
pandas' writer does.
"""

from __future__ import annotations

from typing import IO, List, Sequence

import numpy as np

from shifu_tpu_torch.fileio import atomic_write


def format_block(columns: Sequence[np.ndarray],
                 fmts: Sequence[str], sep: str = ",") -> str:
    """Render equal-length 1-D columns into CSV text (no header, no
    trailing newline)."""
    parts: List[list] = []
    for col, fmt in zip(columns, fmts):
        a = np.asarray(col)
        if fmt == "%s":
            a = a.astype(str)
            if a.size and (np.char.find(a, sep) >= 0).any():
                raise ValueError("need to escape, but no escapechar set")
        parts.append(a.tolist())
    line = sep.join(fmts)
    return "\n".join(line % row for row in zip(*parts))


def write_rows(f: IO[str], columns: Sequence[np.ndarray],
               fmts: Sequence[str], chunk_rows: int = 1_000_000,
               sep: str = ",") -> None:
    """Append formatted rows to an open file, chunked."""
    n = len(columns[0])
    for a in range(0, n, chunk_rows):
        b = min(a + chunk_rows, n)
        block = format_block([c[a:b] for c in columns], fmts, sep=sep)
        if block:
            f.write(block + "\n")


def write_csv(path: str, header: Sequence[str],
              columns: Sequence[np.ndarray], fmts: Sequence[str],
              chunk_rows: int = 1_000_000) -> None:
    with atomic_write(path) as f:
        f.write(",".join(header) + "\n")
        write_rows(f, columns, fmts, chunk_rows=chunk_rows)
