"""`shifu norm` — produce the normalized and the cleaned training data.

The port of the resident path of `shifu_tpu/processor/norm.py`
(`NormalizeModelProcessor.java:47-79`, `udf/NormalizeUDF.java:146`):
the raw table is filtered, sampled (`normalize.sampleRate` /
`sampleNegOnly`) and turned into columnar blocks on the host; the
family transforms of `ops/normalize.py` run on the device
(`norm --device cuda`, the default). It writes

- ``tmp/NormalizedData/{data.npz,meta.json}``: the dense block, the
  index block, tags and weights, and the output names;
- ``tmp/CleanedData/{data.npz,meta.json}``: raw numeric values (NaN =
  missing) and category codes (missing → vocab_len), which the tree
  trainers read;

each block through `fileio.atomic_path` and meta.json last through
`atomic_write`, so a reader never sees a meta that points at a
half-written block.

With `train#trainOnDisk` both directories also get the streaming
trainers' `.npy` layout (`save_normalized`). Past the size trigger
(SHIFU_TPU_NORM_CHUNK_ROWS or -Dshifu.norm.chunkRows, or raw files over
SHIFU_TPU_NORM_STREAM_BYTES) `run` hands the step to the chunked
two-pass writer of `processor/norm_streaming.py`, which writes that
layout only.
"""

from __future__ import annotations

import json
import logging
import os
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from shifu_tpu_torch.config.column_config import ColumnConfig
from shifu_tpu_torch.config.inspector import ModelStep
from shifu_tpu_torch.data.dataset import ColumnarDataset, build_columnar
from shifu_tpu_torch.data.purifier import DataPurifier
from shifu_tpu_torch.data.reader import Table, read_raw_table
from shifu_tpu_torch.fileio import atomic_path, atomic_write
from shifu_tpu_torch.ops.normalize import (NormResult,
                                           build_categorical_table,
                                           build_numeric_table,
                                           normalize_dataset)
from shifu_tpu_torch.processor.base import ProcessorContext, step_guard

log = logging.getLogger("shifu_tpu_torch")


def selected_candidates(ccs: List[ColumnConfig]) -> List[ColumnConfig]:
    """Columns that feed the model: finalSelect ones if varselect ran,
    else all candidates (NormalizeUDF column-selection rule)."""
    final = [c for c in ccs if c.finalSelect and c.is_candidate]
    if final:
        return final
    return [c for c in ccs if c.is_candidate]


def norm_sample_flags(mc, df: Table, seed: int,
                      start_row: int = 0) -> Optional[np.ndarray]:
    """normalize.sampleRate row flags (DataSampler; sampleNegOnly keeps
    every positive), stateless per raw row; None when sampling is off.
    Multi-task models reject sampling like the reference."""
    rate = float(mc.normalize.sampleRate)
    if rate >= 1.0:
        return None
    if mc.is_multi_task:
        raise ValueError("normalize.sampleRate < 1 is not supported for "
                         "multi-task models (NormalizeUDF rejects norm "
                         "sampling under MTL)")
    from shifu_tpu_torch.data.sampling import positive_tag_mask, \
        sample_flags
    keep_pos = positive_tag_mask(mc, df) if mc.normalize.sampleNegOnly \
        else None
    return sample_flags(rate, seed, start_row, len(df),
                        purpose="norm-sample", keep_pos=keep_pos)


def read_for_columns(mc, ccs: List[ColumnConfig], ds_conf=None) -> Table:
    """The raw table `load_dataset_for_columns` reads when it is given
    none: the candidate numeric columns through the C parser."""
    return read_raw_table(mc, ds=ds_conf, numeric_columns=[
        c.columnName for c in ccs
        if c.is_candidate and not c.is_categorical and not c.is_segment])


def load_dataset_for_columns(mc, ccs: List[ColumnConfig],
                             cols: List[ColumnConfig],
                             ds_conf=None,
                             apply_filter: bool = True,
                             extra_columns: Optional[List[str]] = None,
                             df: Optional[Table] = None,
                             norm_sampling: bool = False,
                             sample_seed: int = 12306) -> ColumnarDataset:
    """Read raw data (from `ds_conf`, default the model's dataSet) and
    build columnar blocks for `cols`, categorical vocabularies pinned to
    ColumnConfig binCategory so codes line up with the stats step. `df`
    short-circuits the read (a chunk of a chunked read);
    `apply_filter=False` skips the filter for a table already filtered;
    `extra_columns` (champion score columns) land in `meta` as stripped
    strings, aligned with the built rows."""
    if df is None:
        df = read_for_columns(mc, ccs, ds_conf)
    ds_conf = ds_conf or mc.dataSet
    keep = np.ones(len(df), bool)
    if apply_filter and ds_conf.filterExpressions:
        keep &= DataPurifier(ds_conf.filterExpressions).apply(df)
    if norm_sampling:
        # flags key on the raw row index, before the filter
        samp = norm_sample_flags(mc, df, sample_seed)
        if samp is not None:
            keep &= samp
    if not keep.all():
        df = df.select(keep)
    if any(c.is_segment for c in ccs):
        from shifu_tpu_torch.data import segment
        bases = {segment.base_name(c.columnName)
                 for c in cols if c.is_segment}
        df = segment.expand_raw_frame(df, mc,
                                      segment.segment_expressions(mc),
                                      only_bases=bases)
    vocabs = {c.columnNum: (c.columnBinning.binCategory or [])
              for c in cols if c.is_categorical}
    dset = build_columnar(mc, _restrict(ccs, cols), df, vocabs=vocabs)
    if extra_columns:
        from shifu_tpu_torch.data.dataset import valid_tag_mask
        from shifu_tpu_torch.data.reader import string_column
        valid = valid_tag_mask(mc, df)
        for name in extra_columns:
            if name in df:
                dset.meta[name] = string_column(df[name])[valid]
    return dset


def _restrict(ccs: List[ColumnConfig], cols: List[ColumnConfig]):
    """Keep target/weight/meta flags but only `cols` as candidates."""
    keep_nums = {c.columnNum for c in cols}
    return [c for c in ccs if c.is_meta or c.columnNum in keep_nums]


def normalize_columns(mc, cols: List[ColumnConfig], dset: ColumnarDataset,
                      device: "str | torch.device" = "cuda") -> NormResult:
    nums = set(dset.num_column_nums.tolist())
    num_by_num = {c.columnNum: c for c in cols
                  if c.is_numerical and c.columnNum in nums}
    num_ordered = [num_by_num[int(n)] for n in dset.num_column_nums
                   if int(n) in num_by_num]
    cat_by_num = {c.columnNum: c for c in cols if c.is_categorical}
    cat_ordered = [cat_by_num[int(n)] for n in dset.cat_column_nums
                   if int(n) in cat_by_num]
    num_tbl = build_numeric_table(num_ordered, mc.stats.maxNumBin) \
        if num_ordered else None
    cat_tbl = build_categorical_table(cat_ordered) if cat_ordered else None
    return normalize_dataset(
        mc.normalize.normType, mc.normalize.stdDevCutOff,
        dset.numeric, dset.num_names, num_tbl,
        dset.cat_codes, dset.cat_names, cat_tbl, device=device)


def precision_type(mc) -> str:
    """Output precision of normalized values (`PrecisionType.java`):
    FLOAT7 / FLOAT16 / FLOAT32 / DOUBLE64, from -Dshifu.precision.type
    or normalize#precisionType."""
    p = str(os.environ.get("shifu.precision.type")
            or mc.normalize._extras.get("precisionType")
            or mc.normalize.precisionType
            or "FLOAT32").upper()
    if p not in ("FLOAT7", "FLOAT16", "FLOAT32", "DOUBLE64"):
        raise ValueError(f"unknown precisionType {p!r}; expected one of "
                         "FLOAT7/FLOAT16/FLOAT32/DOUBLE64")
    return p


def apply_precision(dense: np.ndarray, ptype: str) -> np.ndarray:
    """Quantize the dense block: FLOAT16 rounds through half precision
    and keeps f32 values; FLOAT7 keeps 6 fraction digits
    (DecimalFormat "#.######")."""
    if ptype == "FLOAT16":
        return dense.astype(np.float16).astype(np.float32)
    if ptype == "DOUBLE64":
        return dense.astype(np.float64)
    if ptype == "FLOAT7":
        return np.round(dense.astype(np.float32), 6)
    return dense.astype(np.float32)


def save_normalized(path: str, result: NormResult, tags: np.ndarray,
                    weights: np.ndarray,
                    task_tags: Optional[np.ndarray] = None,
                    ptype: str = "FLOAT32",
                    streaming: bool = False) -> None:
    """Write ``data.npz`` then ``meta.json`` under `path`. With
    `streaming` (train#trainOnDisk) the rows are first shuffled once by
    ``default_rng(0x5F00D)`` (the streaming trainers take the trailing
    rows as the validation set, so a label-sorted input must not make a
    one-class one), and the blocks are also laid out as raw ``.npy``
    files the trainers memory-map a chunk at a time: ``dense.npy``
    (real f16 bytes under FLOAT16), ``tags.npy``, ``weights.npy``,
    ``index.npy`` when there are categoricals and ``task_tags.npy`` for
    a multi-task set."""
    os.makedirs(path, exist_ok=True)
    index = result.index
    shuffle_seed = None
    if streaming:
        shuffle_seed = 0x5F00D
        perm = np.random.default_rng(shuffle_seed).permutation(
            result.dense.shape[0] if result.dense.size else tags.shape[0])
        result = NormResult(
            dense=result.dense[perm] if result.dense.size else result.dense,
            dense_names=result.dense_names,
            index=index[perm] if index.size else index,
            index_names=result.index_names,
            index_vocab_sizes=result.index_vocab_sizes)
        index = result.index
        tags = tags[perm]
        weights = weights[perm]
        if task_tags is not None and task_tags.size:
            task_tags = task_tags[perm]
    extra = {}
    if task_tags is not None and task_tags.size:
        extra["task_tags"] = task_tags.astype(np.float32)
    dense = apply_precision(result.dense, ptype)
    # every block goes through a temporary name and a rename, meta.json
    # last: a reader never sees a meta that points at a half-written
    # block
    with atomic_path(os.path.join(path, "data.npz")) as tmp:
        np.savez_compressed(
            tmp, dense=dense, index=index,
            tags=tags.astype(np.float32),
            weights=weights.astype(np.float32), **extra)
    if streaming:
        blocks = {"dense": dense.astype(np.float16) if ptype == "FLOAT16"
                  else dense,
                  "tags": tags.astype(np.float32),
                  "weights": weights.astype(np.float32)}
        if index.size:
            blocks["index"] = index.astype(np.int32)
        if "task_tags" in extra:
            blocks["task_tags"] = extra["task_tags"]
        for name, block in blocks.items():
            with atomic_path(os.path.join(path, f"{name}.npy")) as tmp:
                np.save(tmp, np.ascontiguousarray(block))
    with atomic_write(os.path.join(path, "meta.json")) as f:
        json.dump({"denseNames": result.dense_names,
                   "indexNames": result.index_names,
                   "indexVocabSizes": result.index_vocab_sizes,
                   "precisionType": ptype,
                   "streaming": bool(streaming),
                   "shuffleSeed": shuffle_seed}, f, indent=1)


def load_normalized_meta(path: str) -> Dict:
    """Read only meta.json (denseNames/indexNames)."""
    with open(os.path.join(path, "meta.json")) as f:
        return json.load(f)


def load_normalized(path: str) -> Tuple[Dict[str, np.ndarray], Dict]:
    data = dict(np.load(os.path.join(path, "data.npz")))
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    return data, meta


def norm_chunk_rows(ctx: ProcessorContext) -> int:
    """0 = resident: the JAX package's norm streaming trigger."""
    from shifu_tpu_torch.processor.chunking import chunk_rows_for
    return chunk_rows_for(ctx, ("shifu.norm.chunkRows",
                                "SHIFU_TPU_NORM_CHUNK_ROWS"),
                          "SHIFU_TPU_NORM_STREAM_BYTES",
                          ctx.model_config.dataSet.dataPath, "norm")


def run(ctx: ProcessorContext, dataset: Optional[ColumnarDataset] = None,
        device: "str | torch.device" = "cuda",
        report: Optional[Dict[str, float]] = None) -> int:
    """Write NormalizedData and CleanedData under the ``norm`` manifest
    (`step_guard`). `report`, when given, receives the seconds spent
    reading the raw table (``read_s``) and the rows the step computed
    over (``rows``)."""
    with step_guard(ctx, "norm", outputs=[
            os.path.join(ctx.path_finder.normalized_data_path(),
                         "meta.json")]) as go:
        if not go:
            return 0
        return _run(ctx, dataset, device, report)


def _run(ctx: ProcessorContext, dataset: Optional[ColumnarDataset],
         device: "str | torch.device",
         report: Optional[Dict[str, float]]) -> int:
    from shifu_tpu_torch import resolve_device
    dev = resolve_device(device)
    t0 = time.time()
    mc = ctx.model_config
    ctx.validate(ModelStep.NORMALIZE)
    ctx.require_columns()
    cols = selected_candidates(ctx.column_configs)
    if dataset is None:
        chunk = norm_chunk_rows(ctx)
        if chunk:
            from shifu_tpu_torch.processor import norm_streaming
            return norm_streaming.run_streaming(ctx, chunk, device=dev,
                                                report=report)
        t_read = time.perf_counter()
        dataset = load_dataset_for_columns(mc, ctx.column_configs, cols,
                                           norm_sampling=True)
        if report is not None:
            report["read_s"] = time.perf_counter() - t_read
    result = normalize_columns(mc, cols, dataset, device=dev)
    save_normalized(ctx.path_finder.normalized_data_path(), result,
                    dataset.tags, dataset.weights,
                    task_tags=dataset.task_tags, ptype=precision_type(mc),
                    streaming=mc.train.trainOnDisk)

    # cleaned data for tree algorithms: raw numeric (NaN = missing) +
    # category codes with missing → the vocab_len slot
    clean = NormResult(
        dense=dataset.numeric, dense_names=dataset.num_names,
        index=dataset.cleaned_codes(), index_names=dataset.cat_names,
        index_vocab_sizes=[len(v) + 1 for v in dataset.vocabs])
    save_normalized(ctx.path_finder.cleaned_data_path(), clean,
                    dataset.tags, dataset.weights,
                    task_tags=dataset.task_tags,
                    streaming=mc.train.trainOnDisk)
    if report is not None:
        report["rows"] = dataset.num_rows
    log.info("norm: %d rows → dense %s, index %s in %.2fs",
             dataset.num_rows, result.dense.shape, result.index.shape,
             time.time() - t0)
    return 0
