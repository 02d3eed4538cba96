"""Streaming (>RAM) normalization — a chunked two-pass writer into
memory-mapped `.npy` files, the port of
`shifu_tpu/processor/norm_streaming.py`.

The resident `norm` (`processor/norm.py`) holds the whole table and its
outputs; here raw chunks are read (`data/reader.iter_raw_table` behind
`data/pipeline.prefetch`), normalized on `device` (row-local: every
table comes from ColumnConfig.json) and written straight into
pre-allocated `.npy` memmaps, so host memory holds one chunk.

The validation split needs no global shuffle: a stateless splitmix64
hash of each raw row's global index (`_val_flags`) sends the row to
the train region [0, n_train) or to the trailing validation region
[n_train, R) of the layout, both written in order. The streaming
trainers' trailing validSetRate rows are then an exact uniform split,
and meta.json records ``validSplit`` so they take the written count.
Pass 1 counts the two regions, pass 2 writes them.

It writes the trainOnDisk layout only (`dense.npy`, real f16 under
FLOAT16, `tags.npy`, `weights.npy`, `index.npy` with categoricals,
`task_tags.npy` for MTL; CleanedData's raw values and codes), not
`data.npz`: a set that needs streaming norm trains with
`train#trainOnDisk`. The JAX package's multi-host broadcast stream
(`iter_raw_table_bcast`) is ROADMAP A8.3.
"""

from __future__ import annotations

import json
import logging
import os
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from shifu_tpu_torch.config.inspector import ModelStep
from shifu_tpu_torch.data.dataset import valid_tag_mask
from shifu_tpu_torch.data.pipeline import prefetch
from shifu_tpu_torch.data.purifier import DataPurifier
from shifu_tpu_torch.data.reader import iter_raw_table
from shifu_tpu_torch.data.sampling import splitmix64_uniform
from shifu_tpu_torch.fileio import atomic_write
from shifu_tpu_torch.processor.base import ProcessorContext

log = logging.getLogger("shifu_tpu_torch")


def _val_flags(seed: int, start: int, n: int, rate: float) -> np.ndarray:
    """Stateless validation flags of raw rows start..start+n (splitmix64
    → uniform): the same for every pass and every chunking."""
    if rate <= 0.0:
        return np.zeros(n, bool)
    return splitmix64_uniform(start, n, seed, purpose="val-split") < rate


class _RegionWriter:
    """Sequential writer into the train region [0, n_train) and the
    trailing validation region [n_train, R) of row-aligned memmaps."""

    def __init__(self, n_train: int):
        self.cursors = [0, n_train]
        self.arrays: List = []

    def add(self, mm):
        self.arrays.append(mm)
        return mm

    def write(self, blocks, val_mask: np.ndarray) -> None:
        for region, sel in ((0, ~val_mask), (1, val_mask)):
            n = int(sel.sum())
            if not n:
                continue
            at = self.cursors[region]
            for mm, blk in zip(self.arrays, blocks):
                mm[at:at + n] = blk[sel]
            self.cursors[region] = at + n


def run_streaming(ctx: ProcessorContext, chunk_rows: int,
                  seed: int = 12306, device: "str | torch.device" = "cuda",
                  report: Optional[Dict] = None) -> int:
    """Write the trainOnDisk layouts of NormalizedData and CleanedData
    from two chunked passes. `report`, when given, receives the seconds
    waiting for raw chunks (``read_s``) and writing the layout
    (``write_s``), and ``rows``."""
    from shifu_tpu_torch import resolve_device
    from shifu_tpu_torch.processor import norm as norm_proc
    dev = resolve_device(device)
    t0 = time.time()
    mc = ctx.model_config
    ctx.validate(ModelStep.NORMALIZE)
    ctx.require_columns()
    cols = norm_proc.selected_candidates(ctx.column_configs)
    if not mc.train.trainOnDisk:
        log.warning("streaming norm writes only the .npy layout — set "
                    "train#trainOnDisk=true (resident training needs "
                    "data.npz, which a >RAM set cannot materialize)")
    purifier = DataPurifier(mc.dataSet.filterExpressions) \
        if mc.dataSet.filterExpressions else None
    return _writer_passes(ctx, chunk_rows, seed, t0, mc, norm_proc, cols,
                          purifier, dev, report)


def _add(report: Optional[Dict], key: str, seconds: float) -> None:
    if report is not None:
        report[key] = report.get(key, 0.0) + seconds


def _timed_stream(mc, chunk_rows: int, report: Optional[Dict]):
    """The raw chunks, each wait for one timed into
    ``report["read_s"]``."""
    frames = iter(prefetch(iter_raw_table(mc, chunk_rows=chunk_rows)))
    while True:
        t = time.perf_counter()
        df = next(frames, None)
        _add(report, "read_s", time.perf_counter() - t)
        if df is None:
            return
        yield df


def _keep(mc, norm_proc, df, purifier, seed: int, start: int
          ) -> np.ndarray:
    """The filter and the norm sample of a chunk's raw rows."""
    keep = np.ones(len(df), bool)
    if purifier is not None:
        keep &= purifier.apply(df)
    sf = norm_proc.norm_sample_flags(mc, df, seed, start_row=start)
    if sf is not None:
        keep &= sf
    return keep


def _writer_passes(ctx: ProcessorContext, chunk_rows: int, seed: int,
                   t0: float, mc, norm_proc, cols, purifier,
                   dev: torch.device, report: Optional[Dict]) -> int:
    """Pass 1 sizes the two regions, pass 2 normalizes and writes."""
    val_rate = max(float(mc.train.validSetRate or 0.0), 0.0)

    # ---- pass 1: exact region sizes -----------------------------------
    n_train = n_val = 0
    raw_row = 0
    for df in _timed_stream(mc, chunk_rows, report):
        start = raw_row
        raw_row += len(df)
        keep = _keep(mc, norm_proc, df, purifier, seed, start) \
            & valid_tag_mask(mc, df)
        vf = _val_flags(seed, start, len(df), val_rate)
        n_val += int((keep & vf).sum())
        n_train += int((keep & ~vf).sum())
    n_rows = n_train + n_val
    if n_rows == 0:
        raise ValueError(
            f"no row's {mc.dataSet.targetColumnName!r} value matches "
            f"posTags {mc.pos_tags} / negTags {mc.neg_tags} in any chunk")

    # ---- the output schema, from the first chunk with valid rows -------
    probe = None
    for probe_df in iter_raw_table(mc, chunk_rows=min(chunk_rows, 4096)):
        if purifier is not None:
            probe_df = probe_df.select(purifier.apply(probe_df))
        if not len(probe_df) or not valid_tag_mask(mc, probe_df).any():
            continue
        probe = norm_proc.load_dataset_for_columns(
            mc, ctx.column_configs, cols, apply_filter=False, df=probe_df)
        break
    if probe is None:   # n_rows > 0 should guarantee one valid chunk
        raise RuntimeError("streaming norm: no buildable probe chunk "
                           "despite counted rows — inconsistent input?")
    probe_norm = norm_proc.normalize_columns(mc, cols, probe, device=dev)
    ptype = norm_proc.precision_type(mc)
    f_dense = probe_norm.dense.shape[1]
    k_index = probe_norm.index.shape[1] if probe_norm.index_names else 0
    c_numeric = probe.numeric.shape[1]
    c_codes = probe.cat_codes.shape[1]
    n_tasks = probe.task_tags.shape[1] if probe.task_tags.size else 0
    vlen = np.asarray([len(v) for v in probe.vocabs], np.int32) \
        if c_codes else np.zeros(0, np.int32)

    def _layout(path, spec):
        os.makedirs(path, exist_ok=True)
        w = _RegionWriter(n_train)
        for name, shape, dtype in spec:
            w.add(np.lib.format.open_memmap(
                os.path.join(path, name), mode="w+", dtype=dtype,
                shape=shape))
        return w

    norm_dir = ctx.path_finder.normalized_data_path()
    clean_dir = ctx.path_finder.cleaned_data_path()
    # FLOAT16 lays the normalized block out as real f16 (its values are
    # rounded through half precision anyway); the trainers widen it on
    # the device
    dtype_dense = np.float64 if ptype == "DOUBLE64" else (
        np.float16 if ptype == "FLOAT16" else np.float32)
    norm_spec = [("dense.npy", (n_rows, f_dense), dtype_dense),
                 ("tags.npy", (n_rows,), np.float32),
                 ("weights.npy", (n_rows,), np.float32)]
    if k_index:
        norm_spec.append(("index.npy", (n_rows, k_index), np.int32))
    if n_tasks:
        norm_spec.append(("task_tags.npy", (n_rows, n_tasks), np.float32))
    clean_spec = [("dense.npy", (n_rows, c_numeric), np.float32),
                  ("tags.npy", (n_rows,), np.float32),
                  ("weights.npy", (n_rows,), np.float32)]
    if c_codes:
        clean_spec.append(("index.npy", (n_rows, c_codes), np.int32))
    wn = _layout(norm_dir, norm_spec)
    wc = _layout(clean_dir, clean_spec)

    # ---- pass 2: normalize + write ------------------------------------
    raw_row = 0
    for df in _timed_stream(mc, chunk_rows, report):
        start = raw_row
        raw_row += len(df)
        keep = _keep(mc, norm_proc, df, purifier, seed, start)
        vf = _val_flags(seed, start, len(df), val_rate)[keep]
        df = df.select(keep)
        if not len(df):
            continue
        # build_columnar drops invalid-tag rows: align the flags; only a
        # chunk with no valid row is skipped (any other build error
        # raises rather than truncating the layout)
        tag_ok = valid_tag_mask(mc, df)
        if not tag_ok.any():
            continue
        dset = norm_proc.load_dataset_for_columns(
            mc, ctx.column_configs, cols, apply_filter=False, df=df)
        vf = vf[tag_ok]
        result = norm_proc.normalize_columns(mc, cols, dset, device=dev)
        dense = norm_proc.apply_precision(result.dense, ptype)
        blocks_n = [dense, dset.tags.astype(np.float32),
                    dset.weights.astype(np.float32)]
        if k_index:
            blocks_n.append(result.index.astype(np.int32))
        if n_tasks:
            blocks_n.append(dset.task_tags.astype(np.float32))
        blocks_c = [dset.numeric.astype(np.float32),
                    dset.tags.astype(np.float32),
                    dset.weights.astype(np.float32)]
        if c_codes:
            blocks_c.append(np.where(dset.cat_codes < 0, vlen[None, :],
                                     dset.cat_codes).astype(np.int32))
        t = time.perf_counter()
        wn.write(blocks_n, vf)
        wc.write(blocks_c, vf)
        _add(report, "write_s", time.perf_counter() - t)
    t = time.perf_counter()
    for w in (wn, wc):
        for mm in w.arrays:
            mm.flush()
    _add(report, "write_s", time.perf_counter() - t)
    if wn.cursors != [n_train, n_rows] or wc.cursors != [n_train, n_rows]:
        # a drift between the passes would ship train rows in the
        # validation region: an error, not an assert (-O strips those)
        raise RuntimeError(
            f"streaming norm wrote {wn.cursors}/{wc.cursors} rows but "
            f"counted [{n_train}, {n_rows}] — pass-1/pass-2 drift")

    for path, (dn, ixn, ivs) in (
            (norm_dir, (probe_norm.dense_names, probe_norm.index_names,
                        probe_norm.index_vocab_sizes)),
            (clean_dir, (probe.num_names, probe.cat_names,
                         [int(v) + 1 for v in vlen]))):
        with atomic_write(os.path.join(path, "meta.json")) as f:
            json.dump({"denseNames": list(dn), "indexNames": list(ixn),
                       "indexVocabSizes": list(ivs),
                       "precisionType": ptype, "streaming": True,
                       "streamingNorm": True,
                       # the split is exact: the trailing n_val rows are
                       # a uniform sample (splitmix64 row hash)
                       "validSplit": {"nTrain": n_train, "nVal": n_val,
                                      "seed": seed}}, f, indent=1)
    if report is not None:
        report["rows"] = n_rows
    log.info("streaming norm: %d rows (%d train + %d val regions) → "
             "dense %s in 2 chunked passes, %.2fs", n_rows, n_train,
             n_val, (n_rows, f_dense), time.time() - t0)
    return 0
