"""Durable streaming ingest plane: a partitioned, append-only row log
with exactly-once window consumption — counterpart of
`shifu_tpu/data/ingest.py`, byte for byte on disk.

The live plane (watch → drift → refresh) needs a durable, replayable
log: `watch` tailing a flat file races the writer (torn lines), loses
its place on SIGKILL, and can never re-read the window that fired a
retrain. `RowLog` is that substrate, built from the registry's
write-tmp-then-rename + fault-site discipline.

Layout (one local log root):

    <root>/log.json                 header, delimiter, partitions
    <root>/part-K/manifest.json     sealed-segment list for partition K
    <root>/part-K/seg-NNNNNN.rows   immutable newline-delimited rows
    <root>/offsets/<consumer>.json  committed read position

The files are the JAX package's: the same JSON (``indent=1``,
``sort_keys``), the same UTF-8 segment bytes and sha256, so either
package reads and appends to the other's log.

WRITER. ``append(rows)`` buffers into per-partition open segments; a
segment seals into an immutable ``seg-NNNNNN.rows`` file when it
reaches ``SHIFU_TPU_INGEST_SEGMENT_ROWS`` rows or has been open for
``SHIFU_TPU_INGEST_SEGMENT_AGE_S`` seconds. A seal is the registry's
two-rename discipline: the segment file commits first
(`fault_point("ingest.seal")` + `atomic_write`), then the partition
manifest (row count, per-segment sha256) commits the reference. A kill
between the renames leaves a complete-but-unreferenced segment file and
the PREVIOUS manifest — the rerun re-seals under the same sequence
number, atomically replacing the orphan, and ``.tmp.*`` residue is
swept on open.

READER. Named consumers (``watch``, ``refresh``, ``eval``) each hold a
committed offset per partition. ``read_window(consumer, max_rows)``
returns the next unconsumed rows in a deterministic order (partitions
ascending, segments ascending, rows in file order) WITHOUT moving the
offset; the caller applies the window downstream and only then calls
``commit(consumer, window.end)`` — `fault_point("ingest.offset")` +
`atomic_write`. A crash between read and commit replays the window
instead of skipping it. Segments are immutable and offsets only move on
commit, so ``read_range(start, end)`` re-reads any committed window
bitwise — the refresh manifest records exactly that range.

The reader-side bridge `frame_from_rows` builds the port's `Table`
(`data/reader._rows_table`), not a pandas frame. A ``scheme://`` root
is ROADMAP A8.4 and a multi-host partition shard ROADMAP A8.3: both
raise.
"""

from __future__ import annotations

import hashlib
import json
import os
import time
from dataclasses import dataclass
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

from shifu_tpu_torch.config.environment import knob_float, knob_int
from shifu_tpu_torch.fileio import atomic_write, has_scheme
from shifu_tpu_torch.resilience import fault_point, sweep_stale

LOG_FILE = "log.json"
MANIFEST_FILE = "manifest.json"
OFFSETS_DIR = "offsets"

# consumer names the health plane registers; any other name works too
# (an offset file per name)
WATCH_CONSUMER = "watch"
REFRESH_CONSUMER = "refresh"
EVAL_CONSUMER = "eval"

_SEG_FMT = "seg-{:06d}.rows"


def _read_json(path: str) -> Optional[Dict[str, Any]]:
    """One JSON file; None when absent."""
    try:
        with open(path, encoding="utf-8") as f:
            return json.load(f)
    except FileNotFoundError:
        return None


def _write_json(path: str, obj: Dict[str, Any]) -> None:
    with atomic_write(path, encoding="utf-8") as f:
        json.dump(obj, f, indent=1, sort_keys=True)


def _read_text(path: str) -> str:
    with open(path, encoding="utf-8") as f:
        return f.read()


def rows_from_frame(table, delimiter: str = "|") -> List[str]:
    """A `Table` as raw log rows (delimiter-joined, no newline) — the
    writer-side bridge from the tabular world. A missing value (NaN in
    a numeric column) becomes an empty field, as in the raw text."""
    cols = []
    for name in table.columns:
        v = np.asarray(table[name])
        if v.dtype.kind == "f":
            cols.append(["" if x != x else str(x) for x in v.tolist()])
        else:
            cols.append([str(x) for x in v.tolist()])
    return [delimiter.join(vals) for vals in zip(*cols)] if cols else []


def frame_from_rows(lines: Sequence[str], header: Sequence[str],
                    delimiter: str = "|"):
    """Raw log rows back to an all-string `Table` under the log's
    schema header — the reader-side bridge, with the raw reader's
    conventions (blank lines skipped, short rows padded with "")."""
    from shifu_tpu_torch.data import reader
    rows = [ln for ln in lines if ln.strip(" \t")]
    return reader._rows_table(rows, list(header), delimiter, "row log")


@dataclass
class Window:
    """One read_window result: the raw rows plus the (segment, offset)
    range they span. `start`/`end` map partition → {"seq", "row"}
    (rows consumed within segment `seq`, 1-based sequence numbers);
    committing `end` marks the window consumed."""
    lines: List[str]
    start: Dict[str, Dict[str, int]]
    end: Dict[str, Dict[str, int]]

    @property
    def rows(self) -> int:
        return len(self.lines)

    def range_record(self) -> Dict[str, Any]:
        """The replayable range for manifests and audit trails."""
        return {"start": self.start, "end": self.end, "rows": self.rows}


class RowLog:
    """One partitioned append-only row log rooted at `root`.

    Opening an existing log needs only `root` (the schema comes from
    ``log.json``); creating one needs `header`. Writer and reader state
    live on disk — any number of processes may open the same log, as
    long as each partition has one writer and each consumer name one
    reader.
    """

    def __init__(self, root: str, header: Optional[Sequence[str]] = None,
                 delimiter: str = "|", partitions: int = 1,
                 segment_rows: Optional[int] = None,
                 segment_age_s: Optional[float] = None):
        if has_scheme(root):
            raise NotImplementedError(
                f"{root}: a row log on a remote filesystem is not ported "
                "yet (ROADMAP A8.4); use a local path")
        self.root = root
        self.segment_rows = int(
            segment_rows if segment_rows is not None
            else knob_int("SHIFU_TPU_INGEST_SEGMENT_ROWS"))
        self.segment_age_s = float(
            segment_age_s if segment_age_s is not None
            else knob_float("SHIFU_TPU_INGEST_SEGMENT_AGE_S"))
        meta = _read_json(os.path.join(root, LOG_FILE))
        if meta is None:
            if header is None:
                raise FileNotFoundError(
                    f"ingest: no log at {root!r} (pass header= to "
                    "create one)")
            os.makedirs(root, exist_ok=True)
            meta = {"format": 1, "header": list(header),
                    "delimiter": delimiter,
                    "partitions": int(max(partitions, 1))}
            # idempotent create: concurrent openers write identical
            # bytes, and the atomic rename makes either copy whole
            _write_json(os.path.join(root, LOG_FILE), meta)
        self.header: List[str] = list(meta["header"])
        self.delimiter: str = meta["delimiter"]
        self.partitions: int = int(meta["partitions"])
        # startup hygiene: a killed writer or committer leaves only
        # invisible dot-temps — sweep them so the tree stays clean
        sweep_stale(root)
        sweep_stale(os.path.join(root, OFFSETS_DIR))
        for k in range(self.partitions):
            sweep_stale(self._part_dir(k))
        self._open_rows: Dict[int, List[str]] = {}
        self._open_since: Dict[int, float] = {}
        self._rr = 0   # round-robin cursor for unpinned appends

    # -- paths -----------------------------------------------------------

    def _part_dir(self, part: int) -> str:
        return os.path.join(self.root, f"part-{part}")

    def _manifest_path(self, part: int) -> str:
        return os.path.join(self._part_dir(part), MANIFEST_FILE)

    def _seg_path(self, part: int, seq: int) -> str:
        return os.path.join(self._part_dir(part), _SEG_FMT.format(seq))

    def _offset_path(self, consumer: str) -> str:
        return os.path.join(self.root, OFFSETS_DIR, f"{consumer}.json")

    def _manifest(self, part: int) -> Dict[str, Any]:
        return _read_json(self._manifest_path(part)) or {"segments": []}

    # -- writer ----------------------------------------------------------

    def owned_partitions(self, shard: Optional[Tuple[int, int]] = None
                         ) -> List[int]:
        """The partitions this host writes: all of them on one host. A
        multi-host shard (host i of n owning ``k % n == i``) is
        ROADMAP A8.3."""
        if shard is not None and int(shard[1]) > 1:
            raise NotImplementedError(
                "ingest: partition ownership across hosts is not ported "
                "yet (ROADMAP A8.3)")
        return list(range(self.partitions))

    def append(self, rows: Iterable[str],
               part: Optional[int] = None) -> int:
        """Buffer rows (delimiter-joined lines, no newline) into the
        open segment of `part` (None = round-robin over the owned
        partitions), sealing any segment that crosses the row or age
        threshold. Returns rows accepted. The `ingest.append` fault
        fires before anything is buffered, so an injected fault loses
        no rows — the producer retries the whole batch."""
        fault_point("ingest.append")
        rows = list(rows)
        for line in rows:
            if "\n" in line or "\r" in line:
                raise ValueError("ingest append: a row may not contain "
                                 "a newline (one row per line)")
        if part is None:
            owned = self.owned_partitions()
            for line in rows:
                k = owned[self._rr % len(owned)]
                self._rr += 1
                self._buffer(k, [line])
        else:
            if not 0 <= part < self.partitions:
                raise ValueError(
                    f"ingest append: partition {part} out of range "
                    f"(log has {self.partitions})")
            self._buffer(part, rows)
        self.maybe_seal()
        return len(rows)

    def _buffer(self, part: int, rows: List[str]) -> None:
        buf = self._open_rows.setdefault(part, [])
        if not buf:
            self._open_since[part] = time.monotonic()
        buf.extend(rows)

    def maybe_seal(self) -> List[Tuple[int, int]]:
        """Seal every open segment past its row or age threshold.
        Returns the (part, seq) pairs sealed."""
        sealed = []
        now = time.monotonic()
        for part in sorted(self._open_rows):
            buf = self._open_rows.get(part) or []
            if not buf:
                continue
            age = now - self._open_since.get(part, now)
            if len(buf) >= self.segment_rows or age >= self.segment_age_s:
                sealed.append((part, self.seal(part)))
        return sealed

    def seal_all(self) -> List[Tuple[int, int]]:
        """Force-seal every non-empty open segment (shutdown, tests)."""
        return [(part, self.seal(part))
                for part in sorted(self._open_rows)
                if self._open_rows.get(part)]

    def seal(self, part: int) -> int:
        """Seal partition `part`'s open segment: commit the immutable
        segment file, then the manifest referencing it. A kill before
        commit 1 leaves only a swept dot-temp; between the commits, a
        complete-but-unreferenced segment file and the previous
        manifest (the rerun re-seals `seq` atomically over the orphan).
        Returns the sealed sequence number."""
        buf = self._open_rows.get(part)
        if not buf:
            raise ValueError(f"ingest seal: partition {part} has no "
                             "open rows")
        manifest = self._manifest(part)
        seq = len(manifest["segments"]) + 1
        data = "".join(line + "\n" for line in buf)
        os.makedirs(self._part_dir(part), exist_ok=True)
        # commit 1: the immutable segment file appears atomically
        fault_point("ingest.seal")
        with atomic_write(self._seg_path(part, seq), encoding="utf-8") as f:
            f.write(data)
        sha = hashlib.sha256(data.encode("utf-8")).hexdigest()
        manifest["segments"].append(
            {"name": _SEG_FMT.format(seq), "rows": len(buf),
             "sha256": sha,
             "sealed": time.strftime("%Y-%m-%dT%H:%M:%S")})
        # commit 2: the manifest references it — only now do readers
        # see the segment
        fault_point("ingest.seal")
        _write_json(self._manifest_path(part), manifest)
        self._open_rows[part] = []
        self._open_since.pop(part, None)
        return seq

    def open_rows(self, part: Optional[int] = None) -> int:
        """Buffered-but-unsealed rows (this writer's only volatile
        state)."""
        if part is not None:
            return len(self._open_rows.get(part) or [])
        return sum(len(v) for v in self._open_rows.values())

    # -- reader ----------------------------------------------------------

    def committed_offset(self, consumer: str) -> Dict[str, Dict[str, int]]:
        """partition → {"seq", "row"}: `row` rows of segment `seq`
        consumed (a partition never read starts at seq 1, row 0)."""
        rec = _read_json(self._offset_path(consumer)) or {}
        parts = rec.get("parts", {})
        out = {}
        for k in range(self.partitions):
            p = parts.get(str(k), {})
            out[str(k)] = {"seq": int(p.get("seq", 1)),
                           "row": int(p.get("row", 0))}
        return out

    def _segment_lines(self, part: int, seq: int, seg: Dict[str, Any]
                       ) -> List[str]:
        lines = _read_text(self._seg_path(part, seq)).splitlines()
        if len(lines) != seg["rows"]:
            raise RuntimeError(
                f"ingest: segment part-{part}/{seg['name']} carries "
                f"{len(lines)} rows, manifest says {seg['rows']} — "
                "refusing a corrupt read")
        return lines

    def read_window(self, consumer: str,
                    max_rows: Optional[int] = None) -> Optional[Window]:
        """The next unconsumed rows for `consumer` — deterministic order
        (partitions ascending, then segments ascending), offset NOT
        moved. None when nothing new is sealed."""
        start = self.committed_offset(consumer)
        end = {k: dict(v) for k, v in start.items()}
        lines: List[str] = []
        budget = max_rows if max_rows is not None else float("inf")
        for part in range(self.partitions):
            if budget <= 0:
                break
            key = str(part)
            segments = self._manifest(part)["segments"]
            seq, row = end[key]["seq"], end[key]["row"]
            while budget > 0 and seq <= len(segments):
                seg = segments[seq - 1]
                if row >= seg["rows"]:
                    seq, row = seq + 1, 0
                    continue
                seg_lines = self._segment_lines(part, seq, seg)
                avail = seg["rows"] - row
                take = avail if budget == float("inf") \
                    else min(avail, int(budget))
                lines.extend(seg_lines[row:row + take])
                row += take
                budget -= take
                if row >= seg["rows"] and seq < len(segments):
                    seq, row = seq + 1, 0
            end[key] = {"seq": seq, "row": row}
        if not lines:
            return None
        return Window(lines=lines, start=start, end=end)

    def read_range(self, start: Dict[str, Dict[str, int]],
                   end: Dict[str, Dict[str, int]]) -> List[str]:
        """Re-read a committed (segment, offset) range bitwise —
        segments are immutable, so this returns the exact rows a past
        window delivered (the refresh manifest's audit path)."""
        lines: List[str] = []
        for part in range(self.partitions):
            key = str(part)
            s = start.get(key, {"seq": 1, "row": 0})
            e = end.get(key, s)
            segments = self._manifest(part)["segments"]
            seq, row = int(s["seq"]), int(s["row"])
            e_seq, e_row = int(e["seq"]), int(e["row"])
            while (seq, row) < (e_seq, e_row) and seq <= len(segments):
                seg = segments[seq - 1]
                stop = e_row if seq == e_seq else seg["rows"]
                if stop > row:
                    lines.extend(_read_text(
                        self._seg_path(part, seq)).splitlines()[row:stop])
                seq, row = seq + 1, 0
        return lines

    def commit(self, consumer: str,
               end: Dict[str, Dict[str, int]]) -> None:
        """Atomically commit `consumer`'s offset to `end` — called only
        AFTER the window's downstream effect committed, so a crash
        replays the window rather than skipping it."""
        os.makedirs(os.path.join(self.root, OFFSETS_DIR), exist_ok=True)
        fault_point("ingest.offset")
        _write_json(self._offset_path(consumer),
                    {"consumer": consumer,
                     "parts": {k: {"seq": int(v["seq"]),
                                   "row": int(v["row"])}
                               for k, v in end.items()},
                     "committed": time.strftime("%Y-%m-%dT%H:%M:%S")})

    # -- observability ---------------------------------------------------

    def sealed_rows(self) -> int:
        return sum(seg["rows"] for k in range(self.partitions)
                   for seg in self._manifest(k)["segments"])

    def consumed_rows(self, consumer: str) -> int:
        total = 0
        offset = self.committed_offset(consumer)
        for part in range(self.partitions):
            o = offset[str(part)]
            for i, seg in enumerate(self._manifest(part)["segments"],
                                    start=1):
                if i < o["seq"]:
                    total += seg["rows"]
                elif i == o["seq"]:
                    total += min(int(o["row"]), seg["rows"])
        return total

    def lag(self, consumer: str) -> int:
        """Sealed rows the consumer has not committed yet."""
        return self.sealed_rows() - self.consumed_rows(consumer)

    def consumers(self) -> List[str]:
        try:
            names = os.listdir(os.path.join(self.root, OFFSETS_DIR))
        except OSError:
            return []
        return sorted(n[:-5] for n in names
                      if n.endswith(".json") and not n.startswith("."))

    def inventory(self) -> Dict[str, Any]:
        """The `ingest ls` record: partitions, sealed/open segments,
        per-consumer committed offsets and lag in rows."""
        parts = []
        for k in range(self.partitions):
            segs = self._manifest(k)["segments"]
            parts.append({"partition": k, "sealed_segments": len(segs),
                          "sealed_rows": sum(s["rows"] for s in segs),
                          "open_rows": self.open_rows(k)})
        return {
            "root": self.root, "header": self.header,
            "delimiter": self.delimiter, "partitions": parts,
            "sealed_rows": self.sealed_rows(),
            "consumers": [
                {"name": c, "offset": self.committed_offset(c),
                 "committed_rows": self.consumed_rows(c),
                 "lag_rows": self.lag(c)}
                for c in self.consumers()],
        }
