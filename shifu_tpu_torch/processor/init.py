"""`shifu init` — build ColumnConfig.json from the data header.

The port's copy of `shifu_tpu/processor/init.py`
(`InitModelProcessor.java:75-117`): read the header, make one
ColumnConfig per column, set flags from the target/weight/meta/
categorical/forceselect/forceremove settings, and auto-type the rest
from a host-side sample read. `_detect_type` parses with
`reader.to_numeric`, pandas' rules: "nan" does not count as parsed,
"1_000" and hex do not parse, "inf", "1e5", "+.5" and " 3" do. No
device work.
"""

from __future__ import annotations

import logging
from typing import Optional

import numpy as np

from shifu_tpu_torch.config.column_config import (ColumnConfig, ColumnFlag,
                                                  ColumnType)
from shifu_tpu_torch.config.inspector import ModelStep
from shifu_tpu_torch.data.reader import (Table, read_header, read_raw_table,
                                         simple_column_name, string_column,
                                         to_numeric)
from shifu_tpu_torch.processor.base import ProcessorContext

log = logging.getLogger("shifu_tpu_torch")

# auto-type thresholds (AutoTypeDistinctCountReducer semantics)
NUMERIC_PARSE_RATIO = 0.95
AUTOTYPE_SAMPLE_ROWS = 100_000


def run(ctx: ProcessorContext, auto_type: bool = True,
        sample_rows: int = AUTOTYPE_SAMPLE_ROWS,
        report: Optional[dict] = None) -> int:
    """Write ColumnConfig.json; `report`, when given, receives the
    rows of the type-detection sample (``rows``)."""
    mc = ctx.model_config
    ctx.validate(ModelStep.INIT)
    header = read_header(mc.dataSet, mc.resolve_path)

    targets = {simple_column_name(t)
               for t in mc.dataSet.targetColumnName.split("|") if t.strip()}
    target = simple_column_name(mc.dataSet.targetColumnName.split("|")[0])
    weight = simple_column_name(mc.dataSet.weightColumnName) \
        if mc.dataSet.weightColumnName else ""
    meta = {simple_column_name(n) for n in
            mc.column_names_from_file(mc.dataSet.metaColumnNameFile)}
    categorical = {simple_column_name(n) for n in
                   mc.column_names_from_file(
                       mc.dataSet.categoricalColumnNameFile)}
    force_sel = {simple_column_name(n) for n in
                 mc.column_names_from_file(
                     mc.varSelect.forceSelectColumnNameFile)}
    force_rem = {simple_column_name(n) for n in
                 mc.column_names_from_file(
                     mc.varSelect.forceRemoveColumnNameFile)}

    sample: Optional[Table] = None
    if auto_type:
        sample = read_raw_table(mc, max_rows=sample_rows)
        if report is not None:
            report["rows"] = len(sample)

    ccs = []
    for i, name in enumerate(header):
        sname = simple_column_name(name)
        cc = ColumnConfig(columnNum=i, columnName=sname,
                          version=mc.basic.version)
        if sname in targets:
            cc.columnFlag = ColumnFlag.Target
        elif weight and sname == weight:
            cc.columnFlag = ColumnFlag.Weight
        elif sname in meta:
            cc.columnFlag = ColumnFlag.Meta
        elif sname in force_rem:
            cc.columnFlag = ColumnFlag.ForceRemove
        elif sname in force_sel:
            cc.columnFlag = ColumnFlag.ForceSelect
            cc.finalSelect = True
        if sname in categorical:
            cc.columnType = ColumnType.C
        elif auto_type and sample is not None and sname in sample \
                and cc.columnFlag not in (ColumnFlag.Target,
                                          ColumnFlag.Weight):
            cc.columnType = _detect_type(sample[sname], mc)
        ccs.append(cc)

    ctx.column_configs = ccs
    ctx.save_column_configs()
    log.info("init: %d columns (%d categorical), target=%s", len(ccs),
             sum(1 for c in ccs if c.is_categorical), target)
    return 0


def _detect_type(values: np.ndarray, mc) -> ColumnType:
    """Numeric-parse-ratio auto-typing (the distinct-count job's
    decision rule): categorical when under 95 % of the non-missing
    tokens parse as numbers."""
    s = string_column(values)
    miss = np.isin(s, [str(m) for m in mc.dataSet.missingOrInvalidValues])
    valid = s[~miss]
    if len(valid) == 0:
        return ColumnType.N
    ratio = float((~np.isnan(to_numeric(valid))).mean())
    if ratio < NUMERIC_PARSE_RATIO:
        return ColumnType.C
    return ColumnType.N
