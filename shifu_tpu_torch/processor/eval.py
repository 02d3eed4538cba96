"""`shifu eval` — score eval sets, confusion matrix, perf curves, charts.

The port of the binary-model paths of `shifu_tpu/processor/eval.py`
(`EvalModelProcessor.java`): the eval set is read, normalized on
`device` and scored by the whole ensemble in one `Scorer.score` call
(NN/LR over a ZSCALE set through the fused normalize + first-layer
kernel K1, GBT/RF through the ensemble kernel K2); the metrics sort the
final scores once on the device (`ops/metrics.py`). Outputs under
``evals/<name>/``: EvalScore.csv, EvalPerformance.json (plus one per
champion score column), EvalConfusionMatrix.csv, gainchart.{html,csv};
`-norm` writes EvalNorm.csv and `-audit` ``tmp/<set>_<eval>_audit.data``.

Each entry point takes a `report` dict that receives the rows scored
(``rows``), the seconds spent reading the raw set (``read_s``), in
`Scorer.score` (``score_s``) and, streaming, writing EvalScore.csv and
the score dump (``write_s``); `cli.py` prints them.

A multi-class model set (more than two tags) is scored by
`Scorer.score_multiclass` on the resident path: `eval -run` writes the
per-class EvalScore.csv, the weighted C×C EvalConfusionMatrix.csv and
the accuracy and per-class precision/recall/F1 in
EvalPerformance.json; `-score` and `-audit` write its class columns;
`-confmat`/`-perf` refuse it (binary-model steps).

Past the size trigger (SHIFU_TPU_EVAL_CHUNK_ROWS, -Dshifu.eval.chunkRows,
the eval section's `chunkRows`, or files over
SHIFU_TPU_EVAL_STREAM_BYTES) `eval -run` streams: chunks are built on
the pipeline's worker threads (`data/pipeline.map_stream`), scored
through `Scorer.score` on this thread and appended to EvalScore.csv;
the binary metrics come from a 2^20-bucket `ScoreHistogram` over a
float32 dump of (score, tag, weight), the multi-class ones from the
summed C×C matrix. The port is one
process, so every output is written by it
(the JAX package's `_opath` multi-host writers are A8), and it writes
no `step_guard` manifest (A8). A binary eval writes its guardrail
metrics (`eval.auc`, `eval.weighted_auc`) into the workspace's metrics
store (`obs/health/store.eval_metrics`; inert unless SHIFU_TPU_METRICS=1).
"""

from __future__ import annotations

import contextlib
import copy
import json
import logging
import os
import time
from typing import Dict, Iterator, List, Optional

import numpy as np
import torch

from shifu_tpu_torch import resolve_device
from shifu_tpu_torch.config.environment import knob_raw
from shifu_tpu_torch.config.inspector import ModelStep
from shifu_tpu_torch.config.model_config import EvalConfig, ModelConfig
from shifu_tpu_torch.data.dataset import valid_tag_mask
from shifu_tpu_torch.data.pipeline import map_stream
from shifu_tpu_torch.data.purifier import DataPurifier
from shifu_tpu_torch.data.reader import (Table, iter_raw_table, read_header,
                                         simple_column_name, to_numeric)
from shifu_tpu_torch.eval import csv_out, gain_chart
from shifu_tpu_torch.eval.scorer import Scorer, resolve_generic_models
from shifu_tpu_torch.fileio import atomic_write
from shifu_tpu_torch.ops.metrics import (confusion_matrix_table,
                                         host_cumulatives,
                                         performance_result)
from shifu_tpu_torch.processor import norm as norm_proc
from shifu_tpu_torch.processor.base import ProcessorContext
from shifu_tpu_torch.processor.chunking import chunk_rows_for

log = logging.getLogger("shifu_tpu_torch")

Report = Dict[str, float]


@contextlib.contextmanager
def _clock(report: Optional[Report], key: str) -> Iterator[None]:
    """Add the seconds of the block to ``report[key]``."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        if report is not None:
            report[key] = report.get(key, 0.0) + time.perf_counter() - t0


def _count_rows(report: Optional[Report], n: int) -> None:
    if report is not None:
        report["rows"] = report.get("rows", 0) + int(n)


def _eval_by_name(ctx, eval_name):
    mc = ctx.model_config
    evals = [e for e in mc.evals
             if eval_name is None or e.name == eval_name]
    if not evals:
        raise ValueError(f"no eval set named {eval_name!r}; have "
                         f"{[e.name for e in mc.evals]}")
    return evals


def run(ctx: ProcessorContext, eval_name: Optional[str] = None,
        device: "str | torch.device" = "cuda",
        report: Optional[Report] = None) -> int:
    dev = resolve_device(device)
    ctx.validate(ModelStep.EVAL)
    ctx.require_columns()
    for ec in _eval_by_name(ctx, eval_name):
        run_one(ctx, ec, dev, report)
    return 0


def effective_dataset_conf(mc: ModelConfig, ec: EvalConfig):
    """Eval dataSet inherits target/tags from the model dataSet when
    unset (`EvalConfig.java` falls back to ModelConfig's dataSet)."""
    ds = copy.copy(ec.dataSet)
    base = mc.dataSet
    if not ds.targetColumnName:
        ds.targetColumnName = base.targetColumnName
    if not ds.posTags:
        ds.posTags = base.posTags
    if not ds.negTags:
        ds.negTags = base.negTags
    if not ds.missingOrInvalidValues:
        ds.missingOrInvalidValues = base.missingOrInvalidValues
    if "segExpressionFile" not in ds._extras and \
            base._extras.get("segExpressionFile"):
        # segment expansion applies to eval data too (EvalScoreUDF segs)
        ds._extras = dict(ds._extras,
                          segExpressionFile=base._extras["segExpressionFile"])
    return ds


def score_meta_columns(ctx: ProcessorContext, ec: EvalConfig) -> List[str]:
    """Champion/benchmark score column names
    (`EvalConfig#scoreMetaColumnNameFile`, capped at 5 —
    EvalModelProcessor.java:686-691)."""
    names = ctx.model_config.column_names_from_file(
        ec.scoreMetaColumnNameFile)
    if len(names) > 5:
        raise ValueError("scoreMetaColumns is limited to at most 5 "
                         "benchmark score columns")
    return names


def _score_dataset(mc: ModelConfig, scorer: Scorer, dset, cols,
                   report: Optional[Report] = None
                   ) -> Dict[str, np.ndarray]:
    """Normalize + ensemble-score one built ColumnarDataset (`cols` =
    the selected-candidate ColumnConfigs the normalization runs over),
    on the scorer's device. A multi-class set → {"class<c>": (N,)
    scores, "final": the predicted class index}."""
    result = norm_proc.normalize_columns(mc, cols, dset,
                                         device=scorer.device)
    if mc.is_multi_classification:
        with _clock(report, "score_s"):
            probs, pred = scorer.score_multiclass(
                result.dense, result.index if result.index.size else None,
                raw_dense=dset.numeric, raw_codes=dset.cleaned_codes())
        _count_rows(report, dset.num_rows)
        scores = {f"class{c}": probs[:, c] for c in range(probs.shape[1])}
        scores["final"] = pred.astype(np.float32)
        return scores
    # plain-zscore runs advertise (mean, std) so the NN path fuses
    # normalize + first matmul over the raw block (kernel K1)
    norm = None
    if result.zscore_params is not None:
        norm = {"mean": result.zscore_params[0],
                "std": result.zscore_params[1],
                "cutoff": mc.normalize.stdDevCutOff}
    with _clock(report, "score_s"):
        scores = scorer.score(
            result.dense, result.index if result.index.size else None,
            raw_dense=dset.numeric, raw_codes=dset.cleaned_codes(),
            norm=norm)
    _count_rows(report, dset.num_rows)
    return scores


def _build_eval_dataset(ctx: ProcessorContext, ec: EvalConfig,
                        df: Optional[Table] = None,
                        apply_filter: bool = True,
                        want_meta: bool = True,
                        report: Optional[Report] = None):
    """Build (a chunk of) the eval set as a ColumnarDataset; returns
    (dataset, selected-candidate cols) for _score_dataset. With no `df`
    the whole set is read (timed into ``report["read_s"]``).
    `apply_filter=False` for callers that already ran the purifier on
    `df` (the audit head-read). `want_meta=False` skips the champion
    score-meta columns."""
    mc = ctx.model_config
    ds = effective_dataset_conf(mc, ec)
    cols = norm_proc.selected_candidates(ctx.column_configs)
    eval_mc = copy.copy(mc)
    eval_mc.dataSet = ds
    if df is None:
        with _clock(report, "read_s"):
            df = norm_proc.read_for_columns(eval_mc, ctx.column_configs, ds)
    dset = norm_proc.load_dataset_for_columns(
        eval_mc, ctx.column_configs, cols, ds_conf=ds,
        extra_columns=(score_meta_columns(ctx, ec) if want_meta else None),
        df=df, apply_filter=apply_filter)
    return dset, cols


def _chunks(ctx: ProcessorContext, ec: EvalConfig, chunk_rows: int,
            report: Optional[Report]) -> Iterator[Table]:
    """The eval set's raw chunks, each read timed into
    ``report["read_s"]``."""
    mc = ctx.model_config
    frames = iter_raw_table(mc, ds=effective_dataset_conf(mc, ec),
                            chunk_rows=chunk_rows)
    while True:
        with _clock(report, "read_s"):
            df = next(frames, None)
        if df is None:
            return
        yield df


def _make_scorer(ctx: ProcessorContext, ec: EvalConfig,
                 device: torch.device) -> Scorer:
    # customPaths modelsPath / genericModelsPath pull external models
    # into the ensemble (EvalConfig#customPaths, core/GenericModel.java)
    extra: List[str] = []
    for key in ("modelsPath", "genericModelsPath"):
        p = (ec.customPaths or {}).get(key)
        if p:
            found = resolve_generic_models(ctx.model_config.resolve_path(p))
            if not found:
                log.warning("eval[%s]: customPaths.%s=%r matched no "
                            "models", ec.name, key, p)
            extra.extend(found)
    return Scorer.from_dir(ctx.path_finder.models_path(),
                           extra_paths=extra,
                           score_selector=ec.performanceScoreSelector,
                           gbt_convert=ec.gbtScoreConvertStrategy,
                           device=device)


def score_eval_set(ctx: ProcessorContext, ec: EvalConfig,
                   device: "str | torch.device" = "cuda",
                   report: Optional[Report] = None):
    """Read + normalize + ensemble-score one eval set (resident).
    Returns (scores dict, tags, weights, dataset)."""
    dev = resolve_device(device)
    mc = ctx.model_config
    dset, cols = _build_eval_dataset(ctx, ec, report=report)
    scores = _score_dataset(mc, _make_scorer(ctx, ec, dev), dset, cols,
                            report)
    return scores, dset.tags, dset.weights, dset


def eval_chunk_rows(ctx: ProcessorContext, ec: EvalConfig) -> int:
    """Streaming-eval chunk size: 0 = resident (whole set in RAM).
    Explicit via -Dshifu.eval.chunkRows / SHIFU_TPU_EVAL_CHUNK_ROWS or
    the eval section's `chunkRows`; automatic when the eval files
    exceed SHIFU_TPU_EVAL_STREAM_BYTES (default 2 GB) on disk."""
    v = ec._extras.get("chunkRows")
    if v is not None and str(v).strip() != "" \
            and not os.environ.get("shifu.eval.chunkRows") \
            and not knob_raw("SHIFU_TPU_EVAL_CHUNK_ROWS"):
        try:
            return max(int(float(v)), 0)   # explicit 0 = resident mode
        except (TypeError, ValueError):
            raise ValueError(
                f"eval {ec.name}: chunkRows must be an integer, "
                f"got {v!r}")
    ds = effective_dataset_conf(ctx.model_config, ec)
    return chunk_rows_for(ctx, ("shifu.eval.chunkRows",
                                "SHIFU_TPU_EVAL_CHUNK_ROWS"),
                          "SHIFU_TPU_EVAL_STREAM_BYTES",
                          ds.dataPath, f"eval {ec.name}")


def _empty_table(ctx: ProcessorContext, ds) -> Table:
    """A row-less table under the eval set's column names: a fully
    filtered or empty set still yields the output names."""
    mc = ctx.model_config
    hdr = read_header(ds, mc.resolve_path)
    simple = [simple_column_name(c) for c in hdr]
    names = simple if len(set(simple)) == len(simple) else hdr
    return Table({c: np.zeros(0, dtype="<U1") for c in names}, 0)


def run_norm(ctx: ProcessorContext, eval_name: Optional[str] = None,
             device: "str | torch.device" = "cuda",
             report: Optional[Report] = None) -> int:
    """`shifu eval -norm` — write the eval set's normalized matrix as
    CSV (`EvalModelProcessor` NORM step / `udf/EvalNormUDF.java`),
    resident or, past the size trigger, chunk by chunk
    (normalization is row-local; all tables come from ColumnConfig)."""
    dev = resolve_device(device)
    mc = ctx.model_config
    ctx.require_columns()
    for ec in mc.evals:
        if eval_name is not None and ec.name != eval_name:
            continue
        ds = effective_dataset_conf(mc, ec)
        chunk = eval_chunk_rows(ctx, ec)
        out = ctx.path_finder.eval_norm_path(ec.name)
        os.makedirs(os.path.dirname(out), exist_ok=True)
        n_rows = 0

        def _write_chunk(f, dset, cols, first):
            result = norm_proc.normalize_columns(mc, cols, dset, device=dev)
            if first:
                f.write(",".join(
                    ["tag", "weight"] + list(result.dense_names)
                    + list(result.index_names)) + "\n")
            k_idx = result.index.shape[1] if result.index_names else 0
            columns = [dset.tags.astype(np.int64), dset.weights] \
                + [result.dense[:, j]
                   for j in range(result.dense.shape[1])] \
                + [result.index[:, j].astype(np.int64)
                   for j in range(k_idx)]
            fmts = ["%d", "%.6g"] + ["%.6f"] * result.dense.shape[1] \
                + ["%d"] * k_idx
            csv_out.write_rows(f, columns, fmts)
            _count_rows(report, len(dset.tags))
            return len(dset.tags)

        with atomic_write(out) as f:
            if not chunk:
                dset, cols = _build_eval_dataset(ctx, ec, want_meta=False,
                                                 report=report)
                n_rows = _write_chunk(f, dset, cols, True)
            else:
                for df in _chunks(ctx, ec, chunk, report):
                    dset, cols = _build_eval_dataset(ctx, ec, df=df,
                                                     want_meta=False)
                    if not len(dset.tags):
                        continue
                    n_rows += _write_chunk(f, dset, cols, n_rows == 0)
                if n_rows == 0:
                    dset, cols = _build_eval_dataset(
                        ctx, ec, df=_empty_table(ctx, ds), want_meta=False)
                    _write_chunk(f, dset, cols, True)
        log.info("eval[%s] -norm → %s (%d rows)", ec.name, out, n_rows)
    return 0


def run_audit(ctx: ProcessorContext, eval_name: Optional[str] = None,
              n_records: int = 100, device: "str | torch.device" = "cuda",
              report: Optional[Report] = None) -> int:
    """`shifu eval -audit [-n N]` — score the eval set and write the
    first N records WITH every final-select variable's raw value, the
    meta columns, and the model scores
    (`EvalModelProcessor.doGenAuditData:1296-1356`). It reads chunks
    until N scorable rows survive the filter and the tag mask, then
    scores just those."""
    dev = resolve_device(device)
    mc = ctx.model_config
    ctx.require_columns()
    for ec in _eval_by_name(ctx, eval_name):
        ds = effective_dataset_conf(mc, ec)
        purifier = DataPurifier(ds.filterExpressions) \
            if ds.filterExpressions else None
        eval_mc = copy.copy(mc)
        eval_mc.dataSet = ds
        frames, have = [], 0
        for df in _chunks(ctx, ec, max(4 * n_records, 4096), report):
            if purifier is not None:
                df = df.select(purifier.apply(df))
            frames.append(df)
            have += int(valid_tag_mask(eval_mc, df).sum())
            if have >= n_records:
                break
        head_df = Table.concat(frames) if frames else None
        dset, norm_cols = _build_eval_dataset(ctx, ec, df=head_df,
                                              apply_filter=False,
                                              report=report)
        scores = _score_dataset(mc, _make_scorer(ctx, ec, dev), dset,
                                norm_cols, report)
        tags, weights = dset.tags, dset.weights
        prefix = "class" if mc.is_multi_classification else "model"
        score_cols = sorted(k for k in scores if k.startswith(prefix))

        n = min(n_records, len(tags))
        tmp_dir = os.path.join(ctx.path_finder.root, "tmp")
        os.makedirs(tmp_dir, exist_ok=True)
        out = os.path.join(tmp_dir,
                           f"{mc.model_set_name}_{ec.name}_audit.data")
        var_names = list(dset.num_names) + list(dset.cat_names)
        meta_names = sorted(dset.meta.keys())
        with atomic_write(out) as f:
            f.write("|".join(["tag", "weight"] + var_names + meta_names
                             + score_cols + ["finalScore"]) + "\n")
            for i in range(n):
                row = [str(dset.tags[i]), f"{weights[i]:.6g}"]
                row += [f"{v:.6g}" for v in dset.numeric[i]]
                row += [str(dset.vocabs[j][dset.cat_codes[i, j]])
                        if 0 <= dset.cat_codes[i, j] < len(dset.vocabs[j])
                        else "" for j in range(dset.cat_codes.shape[1])]
                row += [str(dset.meta[m][i]) for m in meta_names]
                row += [f"{float(scores[c][i]):.6f}" for c in score_cols]
                row.append(f"{float(scores['final'][i]):.6f}")
                f.write("|".join(row) + "\n")
        log.info("eval[%s] -audit → %s (%d records, %d variables)",
                 ec.name, out, n, len(var_names))
    return 0


class _ScoreCsvWriter:
    """The EvalScore.csv protocol, in ONE place for every producer
    (run_one, run_score chunked and resident): model columns are
    discovered from the first non-empty chunk, the header is written
    exactly once, then each chunk appends vectorized rows with the same
    column ordering."""

    def __init__(self, f):
        self.f = f
        self.model_cols: List[str] = []
        self.chunks = 0

    def write(self, scores: Dict[str, np.ndarray], tags: np.ndarray,
              weights: np.ndarray) -> None:
        if self.chunks == 0:
            self.model_cols = sorted(k for k in scores
                                     if k.startswith("model"))
            self.f.write("tag,weight," + ",".join(self.model_cols)
                         + ",mean,max,min,median\n")
        columns = [tags.astype(np.int64), weights] \
            + [scores[c] for c in self.model_cols] \
            + [scores["mean"], scores["max"], scores["min"],
               scores["median"]]
        fmts = ["%d", "%.6g"] + ["%.6f"] * (len(self.model_cols) + 4)
        csv_out.write_rows(self.f, columns, fmts)
        self.chunks += 1


def _write_perf_outputs(ctx: ProcessorContext, ec: EvalConfig,
                        perf: Dict) -> None:
    """EvalPerformance.json and the gain charts."""
    mc = ctx.model_config
    with atomic_write(ctx.path_finder.eval_performance_path(ec.name)) as f:
        json.dump(perf, f, indent=1)
    gain_chart.write_html(ctx.path_finder.gain_chart_path(ec.name, "html"),
                          perf, f"{mc.model_set_name} — {ec.name}")
    gain_chart.write_csv(ctx.path_finder.gain_chart_path(ec.name, "csv"),
                         perf)


def run_one(ctx: ProcessorContext, ec: EvalConfig,
            device: "str | torch.device" = "cuda",
            report: Optional[Report] = None) -> Dict:
    t0 = time.time()
    dev = resolve_device(device)
    mc = ctx.model_config
    chunk_rows = eval_chunk_rows(ctx, ec)
    if chunk_rows and mc.is_multi_classification:
        return _run_multiclass_streaming(ctx, ec, chunk_rows, t0, dev,
                                         report)
    if chunk_rows:
        return _run_one_streaming(ctx, ec, chunk_rows, t0, dev, report)
    scores, tags, weights, dset = score_eval_set(ctx, ec, dev, report)
    if mc.is_multi_classification:
        return _finish_multiclass(ctx, ec, scores, tags, weights, t0)
    final = scores["final"]

    base = ctx.path_finder.eval_base_path(ec.name)
    os.makedirs(base, exist_ok=True)

    # EvalScore.csv: tag | weight | per-model scores | ensemble
    with atomic_write(ctx.path_finder.eval_score_path(ec.name)) as f:
        _ScoreCsvWriter(f).write(scores, tags, weights)

    # one sort and one copy serve the buckets and the confusion table
    cum = host_cumulatives(final, tags, weights, dev)
    perf = performance_result(final, tags, weights,
                              n_buckets=ec.performanceBucketNum,
                              score_scale=float(ec.scoreScale), device=dev,
                              cum=cum)

    # dynamic score capture (`EvalModelProcessor.java:473,1114-1165`
    # ScoreStatus): the scores are in memory, so it is a reduction
    pos = tags > 0.5
    perf["scoreStatus"] = {
        "records": int(len(final)),
        "posCount": int(pos.sum()),
        "negCount": int((~pos).sum()),
        "weightedPos": float(weights[pos].sum()),
        "weightedNeg": float(weights[~pos].sum()),
        "maxScore": float(np.max(final)) if len(final) else 0.0,
        "minScore": float(np.min(final)) if len(final) else 0.0,
    }

    # champion/challenger: each benchmark score column in the eval data
    # gets its own PerformanceResult next to the challenger model's
    # (EvalModelProcessor.java:965-1004)
    champions = {}
    for col, raw in sorted(dset.meta.items()):
        vals = to_numeric(raw)
        ok = np.isfinite(vals)
        if not ok.any():
            log.warning("champion column %r has no numeric scores", col)
            continue
        cperf = performance_result(vals[ok], tags[ok], weights[ok],
                                   n_buckets=ec.performanceBucketNum,
                                   score_scale=float(ec.scoreScale),
                                   device=dev)
        champions[col] = cperf
        with atomic_write(os.path.join(
                base, f"EvalPerformance-{col}.json")) as f:
            json.dump(cperf, f, indent=1)
        log.info("eval[%s] champion %s: AUC=%.4f (challenger %.4f)",
                 ec.name, col, cperf["areaUnderRoc"],
                 perf["areaUnderRoc"])
    if champions:
        perf["championAuc"] = {c: p["areaUnderRoc"]
                               for c, p in champions.items()}

    cm = confusion_matrix_table(final, tags, weights, device=dev, cum=cum)
    _write_confusion_csv(ctx.path_finder.eval_confusion_path(ec.name), cm)
    _write_perf_outputs(ctx, ec, perf)

    log.info("eval[%s]: %d rows, AUC=%.4f (weighted %.4f) in %.2fs",
             ec.name, len(final), perf["areaUnderRoc"],
             perf["weightedAreaUnderRoc"], time.time() - t0)
    _health_metrics(ctx, ec, perf)
    return perf


def _health_metrics(ctx: ProcessorContext, ec: EvalConfig,
                    perf: Dict) -> None:
    """The eval guardrail metrics into the workspace's metrics store
    (`eval.auc` and friends; inert unless SHIFU_TPU_METRICS=1)."""
    from shifu_tpu_torch.obs.health import store as health_store
    health_store.eval_metrics(ctx.path_finder.root, ec.name, perf,
                              model=ctx.model_config.model_set_name)


def _built_chunks(ctx: ProcessorContext, ec: EvalConfig, chunk_rows: int,
                  report: Optional[Report]):
    """The eval set's chunks built into (dataset, cols) on the pipeline's
    worker threads (`map_stream`: host work only; the caller scores on
    its own thread), in file order."""
    return map_stream(lambda df: _build_eval_dataset(ctx, ec, df=df),
                      _chunks(ctx, ec, chunk_rows, report))


def _run_one_streaming(ctx: ProcessorContext, ec: EvalConfig,
                       chunk_rows: int, t0: float, dev: torch.device,
                       report: Optional[Report]) -> Dict:
    """Bounded-memory eval: raw chunks → score (`Scorer.score`: K1 for
    NN/LR over a ZSCALE set, K2 for trees) → EvalScore.csv appended a
    chunk at a time, and (score, tag, weight) appended to a float32
    side file; the metrics then come from a 2^20-bucket
    `ScoreHistogram` over that file (exact up to a 1e-6-of-range score
    quantization, the precision EvalScore.csv prints). Replaces the
    reference's eval job and on-disk score re-sort
    (`EvalModelProcessor.java:942-1110`, `ConfusionMatrix.java:255-284`)
    for sets larger than RAM."""
    mc = ctx.model_config
    scorer = _make_scorer(ctx, ec, dev)
    base = ctx.path_finder.eval_base_path(ec.name)
    os.makedirs(base, exist_ok=True)
    champ_names = score_meta_columns(ctx, ec)
    dump_path = os.path.join(base, ".scores.bin")   # (final, tag, w) f32
    champ_dumps = {c: os.path.join(base, f".champ{i}.bin")
                   for i, c in enumerate(champ_names)}
    status = {"records": 0, "posCount": 0, "negCount": 0,
              "weightedPos": 0.0, "weightedNeg": 0.0,
              "maxScore": -np.inf, "minScore": np.inf}
    n_chunks = 0
    try:
        # the score file is published only when every chunk is in: a
        # failure leaves no truncated EvalScore.csv
        with atomic_write(ctx.path_finder.eval_score_path(ec.name)) \
                as score_f, open(dump_path, "wb") as dump_f, \
                contextlib.ExitStack() as stack:
            score_w = _ScoreCsvWriter(score_f)
            champ_fs = {c: stack.enter_context(open(p, "wb"))
                        for c, p in champ_dumps.items()}
            for dset, cols in _built_chunks(ctx, ec, chunk_rows, report):
                if not len(dset.tags):
                    continue
                scores = _score_dataset(mc, scorer, dset, cols, report)
                final = scores["final"]
                tags, weights = dset.tags, dset.weights
                with _clock(report, "write_s"):
                    score_w.write(scores, tags, weights)
                    np.stack([final.astype(np.float32),
                              tags.astype(np.float32),
                              weights.astype(np.float32)],
                             axis=1).tofile(dump_f)
                    for c, fh in champ_fs.items():
                        raw = dset.meta.get(c)
                        vals = np.full(len(tags), np.nan, np.float32) \
                            if raw is None or len(raw) != len(tags) \
                            else to_numeric(raw).astype(np.float32)
                        np.stack([vals, tags.astype(np.float32),
                                  weights.astype(np.float32)],
                                 axis=1).tofile(fh)
                pos = tags > 0.5
                status["records"] += int(len(final))
                status["posCount"] += int(pos.sum())
                status["negCount"] += int((~pos).sum())
                status["weightedPos"] += float(weights[pos].sum())
                status["weightedNeg"] += float(weights[~pos].sum())
                if len(final):
                    status["maxScore"] = max(status["maxScore"],
                                             float(final.max()))
                    status["minScore"] = min(status["minScore"],
                                             float(final.min()))
                n_chunks += 1
            if status["records"] == 0:
                raise ValueError(f"eval set {ec.name}: no scorable rows")
        return _finish_streaming(ctx, ec, chunk_rows, t0, status, n_chunks,
                                 dump_path, champ_dumps, champ_names, dev)
    finally:
        # the dumps are scratch of this call: removed on every exit
        for p in (dump_path, *champ_dumps.values()):
            if os.path.exists(p):
                os.remove(p)


def _hist_from_dump(path: str, dev: torch.device):
    """`ScoreHistogram` over a (score, tag, weight) f32 dump, or None
    when it holds no finite score (a champion column that never parsed:
    the resident path warns and skips it too). The min/max scan and the
    adds go a block at a time, so memory stays bounded."""
    from shifu_tpu_torch.ops.metrics import ScoreHistogram
    mm = np.memmap(path, np.float32, mode="r").reshape(-1, 3)
    step = 16_000_000
    lo, hi = np.inf, -np.inf
    for a in range(0, len(mm), step):
        s = mm[a:a + step, 0]
        s = s[np.isfinite(s)]
        if s.size:
            lo = min(lo, float(s.min()))
            hi = max(hi, float(s.max()))
    if not np.isfinite(lo):
        return None
    h = ScoreHistogram(lo, hi, device=dev)
    for a in range(0, len(mm), step):
        blk = np.asarray(mm[a:a + step])
        m = np.isfinite(blk[:, 0])
        h.add(blk[m, 0], (blk[m, 1] > 0.5).astype(np.float64), blk[m, 2])
    return h


def _finish_streaming(ctx, ec, chunk_rows, t0, status, n_chunks,
                      dump_path, champ_dumps, champ_names,
                      dev: torch.device) -> Dict:
    """The metrics and outputs of a streaming eval from its dumps."""
    from shifu_tpu_torch.ops.metrics import ScoreHistogram
    mc = ctx.model_config
    base = ctx.path_finder.eval_base_path(ec.name)
    hist = _hist_from_dump(dump_path, dev)
    if hist is None:
        raise ValueError(f"eval set {ec.name}: no finite model scores")
    perf = hist.performance_result(n_buckets=ec.performanceBucketNum,
                                   score_scale=float(ec.scoreScale))
    status["maxScore"] = float(status["maxScore"])
    status["minScore"] = float(status["minScore"])
    perf["scoreStatus"] = status
    perf["streaming"] = {"chunkRows": chunk_rows, "chunks": n_chunks,
                         "scoreQuantBuckets": ScoreHistogram.N_BUCKETS}
    champions = {}
    for c in champ_names:
        ch = _hist_from_dump(champ_dumps[c], dev)
        if ch is None:
            log.warning("champion column %r has no numeric scores", c)
            continue
        cperf = ch.performance_result(n_buckets=ec.performanceBucketNum,
                                      score_scale=float(ec.scoreScale))
        champions[c] = cperf
        with atomic_write(os.path.join(
                base, f"EvalPerformance-{c}.json")) as f:
            json.dump(cperf, f, indent=1)
        log.info("eval[%s] champion %s: AUC=%.4f (challenger %.4f)",
                 ec.name, c, cperf["areaUnderRoc"], perf["areaUnderRoc"])
    if champions:
        perf["championAuc"] = {c: p["areaUnderRoc"]
                               for c, p in champions.items()}
    _write_confusion_csv(ctx.path_finder.eval_confusion_path(ec.name),
                         hist.confusion_table())
    _write_perf_outputs(ctx, ec, perf)
    log.info("eval[%s] streaming: %d rows in %d chunks, AUC=%.4f "
             "(weighted %.4f) in %.2fs", ec.name, status["records"],
             n_chunks, perf["areaUnderRoc"], perf["weightedAreaUnderRoc"],
             time.time() - t0)
    _health_metrics(ctx, ec, perf)
    return perf


def _run_multiclass_streaming(ctx: ProcessorContext, ec: EvalConfig,
                              chunk_rows: int, t0: float,
                              dev: torch.device,
                              report: Optional[Report]) -> Dict:
    """Bounded-memory multi-class eval: the weighted C×C confusion
    matrix is a sum over rows, so chunks merge exactly and every metric
    derives from the merged matrix (the reference's streaming confusion
    matrix, `ConfusionMatrix.java:255-284`); EvalScore.csv grows a chunk
    at a time."""
    mc = ctx.model_config
    scorer = _make_scorer(ctx, ec, dev)
    os.makedirs(ctx.path_finder.eval_base_path(ec.name), exist_ok=True)
    n_c = len(mc.class_tags)
    class_cols = [f"class{c}" for c in range(n_c)]
    cm = np.zeros((n_c, n_c), np.float64)
    records = 0
    with atomic_write(ctx.path_finder.eval_score_path(ec.name)) as score_f:
        score_f.write("tag,weight," + ",".join(class_cols)
                      + ",predicted\n")
        for dset, cols in _built_chunks(ctx, ec, chunk_rows, report):
            if not len(dset.tags):
                continue
            scores = _score_dataset(mc, scorer, dset, cols, report)
            pred = scores["final"].astype(np.int32)
            true = dset.tags.astype(np.int32)
            with _clock(report, "write_s"):
                csv_out.write_rows(
                    score_f,
                    [true, dset.weights] + [scores[c] for c in class_cols]
                    + [pred], ["%d", "%.6g"] + ["%.6f"] * n_c + ["%d"])
            np.add.at(cm, (true, pred), dset.weights)
            records += int(len(pred))
    log.info("eval[%s]: multi-class streamed in %d-row chunks", ec.name,
             chunk_rows)
    return _write_multiclass_outputs(ctx, ec, cm, records, t0)


def _finish_multiclass(ctx: ProcessorContext, ec: EvalConfig,
                       scores: Dict[str, np.ndarray], tags: np.ndarray,
                       weights: np.ndarray, t0: float) -> Dict:
    """Multi-class eval outputs: per-class score columns, the weighted
    C×C confusion matrix, accuracy and per-class precision/recall/F1
    (`ConfusionMatrix.computeConfusionMatixForMultipleClassification`)."""
    n_c = len(ctx.model_config.class_tags)
    true = tags.astype(np.int32)
    os.makedirs(ctx.path_finder.eval_base_path(ec.name), exist_ok=True)
    pred = _write_class_scores(ctx.path_finder.eval_score_path(ec.name),
                               scores, [f"class{c}" for c in range(n_c)],
                               tags, weights)
    # weighted C×C confusion matrix: rows = actual, cols = predicted
    cm = np.zeros((n_c, n_c), np.float64)
    np.add.at(cm, (true, pred), weights)
    return _write_multiclass_outputs(ctx, ec, cm, int(len(pred)), t0)


def _write_class_scores(path: str, scores: Dict[str, np.ndarray],
                        class_cols: List[str], tags: np.ndarray,
                        weights: np.ndarray) -> np.ndarray:
    """A multi-class EvalScore.csv: tag, weight, the class columns and
    the predicted class; returns the predictions."""
    pred = scores["final"].astype(np.int32)
    csv_out.write_csv(
        path, ["tag", "weight"] + class_cols + ["predicted"],
        [tags.astype(np.int32), weights] + [scores[c] for c in class_cols]
        + [pred], ["%d", "%.6g"] + ["%.6f"] * len(class_cols) + ["%d"])
    return pred


def _write_multiclass_outputs(ctx: ProcessorContext, ec: EvalConfig,
                              cm: np.ndarray, records: int,
                              t0: float) -> Dict:
    """Confusion csv + performance json from the weighted C×C matrix."""
    classes = ctx.model_config.class_tags
    n_c = len(classes)
    with atomic_write(ctx.path_finder.eval_confusion_path(ec.name)) as f:
        f.write("actual\\predicted," + ",".join(str(c) for c in classes)
                + "\n")
        for a in range(n_c):
            f.write(str(classes[a]) + ","
                    + ",".join(f"{v:.6g}" for v in cm[a]) + "\n")
    total = float(cm.sum())
    acc = float(np.trace(cm) / max(total, 1e-12))
    per_class = []
    for c in range(n_c):
        tp = float(cm[c, c])
        fp = float(cm[:, c].sum() - tp)
        fn = float(cm[c].sum() - tp)
        prec = tp / max(tp + fp, 1e-12)
        rec = tp / max(tp + fn, 1e-12)
        per_class.append({
            "tag": str(classes[c]), "precision": prec, "recall": rec,
            "f1": 2 * prec * rec / max(prec + rec, 1e-12),
            "support": float(cm[c].sum())})
    perf = {"accuracy": acc, "records": records,
            "classes": [str(c) for c in classes], "perClass": per_class}
    with atomic_write(ctx.path_finder.eval_performance_path(ec.name)) as f:
        json.dump(perf, f, indent=1)
    log.info("eval[%s]: %d rows, multi-class accuracy=%.4f in %.2fs",
             ec.name, records, acc, time.time() - t0)
    return perf


def _write_confusion_csv(path: str, cm: np.ndarray) -> None:
    with atomic_write(path) as f:
        f.write("threshold,tp,fp,tn,fn,weightedTp,weightedFp,weightedTn,"
                "weightedFn\n")
        if len(cm):
            csv_out.write_rows(f, [cm[:, j] for j in range(cm.shape[1])],
                               ["%.6g"] * cm.shape[1])


# ---------------------------------------------------------------------------
# Eval-set management + split steps (ShifuCLI eval -list/-new/-delete/
# -score/-confmat/-perf — EvalModelProcessor.java:165-196)
# ---------------------------------------------------------------------------

def run_list(ctx: ProcessorContext) -> int:
    """`shifu eval -list` (EvalModelProcessor.listEvalSet)."""
    names = [e.name for e in ctx.model_config.evals]
    log.info("%d eval set(s) configured", len(names))
    for n in names:
        print(n)
    return 0


def run_new(ctx: ProcessorContext, name: str) -> int:
    """`shifu eval -new <name>` — clone the model dataSet into a fresh
    EvalConfig + empty meta/score-meta name files
    (EvalModelProcessor.createNewEval:639-668)."""
    mc = ctx.model_config
    if any(e.name == name for e in mc.evals):
        raise ValueError(f"EvalSet - {name} already exists in "
                         "ModelConfig. Please use another evalset name")
    ec = EvalConfig()
    ec.name = name
    ec.dataSet = copy.deepcopy(mc.dataSet)
    cols_dir = os.path.join(ctx.path_finder.root, "columns")
    os.makedirs(cols_dir, exist_ok=True)
    meta = os.path.join("columns", f"{name}.meta.column.names")
    score_meta = os.path.join("columns", f"{name}Score.meta.column.names")
    ec.dataSet.metaColumnNameFile = meta
    ec.scoreMetaColumnNameFile = score_meta
    mc.evals.append(ec)
    for rel in (meta, score_meta):
        p = os.path.join(ctx.path_finder.root, rel)
        if not os.path.exists(p):
            open(p, "a").close()
    mc.save(ctx.path_finder.root)
    log.info("Create Eval - %s", name)
    return 0


def run_delete(ctx: ProcessorContext, name: str) -> int:
    """`shifu eval -delete <name>` (EvalModelProcessor.deleteEvalSet)."""
    mc = ctx.model_config
    before = len(mc.evals)
    mc.evals = [e for e in mc.evals if e.name != name]
    if len(mc.evals) == before:
        raise ValueError(f"no eval set named {name!r}; have "
                         f"{[e.name for e in mc.evals]}")
    mc.save(ctx.path_finder.root)
    log.info("Delete Eval - %s", name)
    return 0


def run_score(ctx: ProcessorContext, eval_name: Optional[str] = None,
              device: "str | torch.device" = "cuda",
              report: Optional[Report] = None) -> int:
    """`shifu eval -score [name]` — scoring ONLY (EvalScore.csv), no
    metrics pass (EvalModelProcessor.runScore): resident, or chunk by
    chunk past the size trigger."""
    dev = resolve_device(device)
    mc = ctx.model_config
    ctx.validate(ModelStep.EVAL)
    ctx.require_columns()
    for ec in _eval_by_name(ctx, eval_name):
        os.makedirs(ctx.path_finder.eval_base_path(ec.name), exist_ok=True)
        chunk_rows = eval_chunk_rows(ctx, ec)
        scorer = _make_scorer(ctx, ec, dev)
        if mc.is_multi_classification:
            # per-class probability columns + argmax, like run_one's
            # score block (resident: no mean/max ensemble columns)
            dset, cols = _build_eval_dataset(ctx, ec, want_meta=False,
                                             report=report)
            scores = _score_dataset(mc, scorer, dset, cols, report)
            pred = _write_class_scores(
                ctx.path_finder.eval_score_path(ec.name), scores,
                sorted(k for k in scores if k.startswith("class")),
                dset.tags, dset.weights)
            log.info("eval[%s] -score → %s (%d rows, multi-class)",
                     ec.name, ctx.path_finder.eval_score_path(ec.name),
                     len(pred))
            continue
        n = 0
        with atomic_write(ctx.path_finder.eval_score_path(ec.name)) as f:
            w = _ScoreCsvWriter(f)
            if chunk_rows:
                for df in _chunks(ctx, ec, chunk_rows, report):
                    dset, cols = _build_eval_dataset(ctx, ec, df=df,
                                                     want_meta=False)
                    if not len(dset.tags):
                        continue
                    scores = _score_dataset(mc, scorer, dset, cols, report)
                    w.write(scores, dset.tags, dset.weights)
                    n += len(dset.tags)
            else:
                dset, cols = _build_eval_dataset(ctx, ec, want_meta=False,
                                                 report=report)
                scores = _score_dataset(mc, scorer, dset, cols, report)
                w.write(scores, dset.tags, dset.weights)
                n = len(dset.tags)
        if n == 0:
            raise ValueError(f"eval set {ec.name}: no scorable rows")
        log.info("eval[%s] -score → %s (%d rows)", ec.name,
                 ctx.path_finder.eval_score_path(ec.name), n)
    return 0


def _read_scores_csv(ctx, ec):
    """(final, tags, weights) from a previously-written EvalScore.csv —
    the input of the -confmat/-perf split steps."""
    if ctx.model_config.is_multi_classification:
        raise ValueError(
            "eval -confmat/-perf are binary-model steps (the multiclass "
            "score file has per-class columns, and the CxC confusion "
            "matrix is produced by `eval -run`)")
    p = ctx.path_finder.eval_score_path(ec.name)
    if not os.path.exists(p):
        raise FileNotFoundError(
            f"{p} not found; run `eval -score {ec.name}` (or -run) first")
    with open(p) as f:
        header = f.readline().strip().split(",")
    data = np.loadtxt(p, delimiter=",", skiprows=1, ndmin=2,
                      dtype=np.float64).reshape(-1, len(header))
    sel = str(ec.performanceScoreSelector or "mean").lower()
    col = header.index(sel if sel in header else "mean")
    return (data[:, col], data[:, header.index("tag")],
            data[:, header.index("weight")])


def run_confmat(ctx: ProcessorContext, eval_name: Optional[str] = None,
                device: "str | torch.device" = "cuda",
                report: Optional[Report] = None) -> int:
    """`shifu eval -confmat [name]` — confusion matrix from the score
    file (EvalModelProcessor.runConfusionMatrix)."""
    dev = resolve_device(device)
    ctx.require_columns()
    for ec in _eval_by_name(ctx, eval_name):
        with _clock(report, "read_s"):
            final, tags, weights = _read_scores_csv(ctx, ec)
        _count_rows(report, len(final))
        cm = confusion_matrix_table(final, tags, weights, device=dev)
        _write_confusion_csv(ctx.path_finder.eval_confusion_path(ec.name),
                             cm)
        log.info("eval[%s] -confmat → %s", ec.name,
                 ctx.path_finder.eval_confusion_path(ec.name))
    return 0


def run_perf(ctx: ProcessorContext, eval_name: Optional[str] = None,
             device: "str | torch.device" = "cuda",
             report: Optional[Report] = None) -> int:
    """`shifu eval -perf [name]` — PR/ROC/gains + charts from the score
    file (EvalModelProcessor.runPerformance)."""
    dev = resolve_device(device)
    ctx.require_columns()
    for ec in _eval_by_name(ctx, eval_name):
        with _clock(report, "read_s"):
            final, tags, weights = _read_scores_csv(ctx, ec)
        _count_rows(report, len(final))
        perf = performance_result(final, tags, weights,
                                  n_buckets=ec.performanceBucketNum,
                                  score_scale=float(ec.scoreScale),
                                  device=dev)
        _write_perf_outputs(ctx, ec, perf)
        log.info("eval[%s] -perf: AUC=%.4f → %s", ec.name,
                 perf["areaUnderRoc"],
                 ctx.path_finder.eval_performance_path(ec.name))
    return 0
