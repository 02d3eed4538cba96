"""`shifu encode` — tree-leaf-path encoding of a dataset, the port of
`shifu_tpu/processor/encode.py` (`core/processor/
ModelDataEncodeProcessor.java` + `udf/EncodeDataUDF.java`): every record
is pushed through the trained tree ensemble and each tree's landing
leaf id becomes one categorical output column ("tree_<i>"), a learned
feature cross for a downstream model set. The binning and the walk
(`gbdt.leaf_indices`) run on `device` as plain PyTorch; the rows are
written on the host.
"""

from __future__ import annotations

import logging
import os
import time
from typing import Any, Dict, Optional

import numpy as np
import torch

from shifu_tpu_torch import resolve_device
from shifu_tpu_torch.fileio import atomic_write
from shifu_tpu_torch.models import gbdt
from shifu_tpu_torch.models.spec import load_model
from shifu_tpu_torch.processor import norm as norm_proc
from shifu_tpu_torch.processor.base import ProcessorContext

log = logging.getLogger("shifu_tpu_torch")


def run(ctx: ProcessorContext, out_dir: Optional[str] = None,
        device: "str | torch.device" = "cuda",
        report: Optional[Dict[str, Any]] = None) -> int:
    """Write ``encoded/part-00000`` and its ``.pig_header``. `report`,
    when given, receives the rows (``rows``) and trees (``trees``)."""
    dev = resolve_device(device)
    t0 = time.time()
    mc = ctx.model_config
    ctx.require_columns()
    model_path = None
    for ext in ("gbt", "rf"):
        p = ctx.path_finder.model_path(0, ext)
        if os.path.exists(p):
            model_path = p
            break
    if model_path is None:
        raise FileNotFoundError(
            "encode needs a trained tree model (models/model0.gbt|rf); "
            "train with algorithm GBT/RF first")
    _, meta, params = load_model(model_path)
    cfg_meta = meta["treeConfig"]
    n_bins = int(cfg_meta["n_bins"])

    cols = norm_proc.selected_candidates(ctx.column_configs)
    dset = norm_proc.load_dataset_for_columns(mc, ctx.column_configs, cols)
    codes = dset.cleaned_codes()
    tables = {"num_cuts": np.asarray(params["tables"]["num_cuts"]),
              "cat_map": np.asarray(params["tables"]["cat_map"])}
    bins = gbdt.bin_dataset(tables, dset.numeric, codes, n_bins, dev)
    binsT = torch.as_tensor(np.ascontiguousarray(bins.T), device=dev)
    leaves = gbdt.leaf_indices(gbdt._trees_on(params["trees"], dev), binsT,
                               int(cfg_meta["max_depth"]),
                               n_bins).T.cpu().numpy()     # (R, T)

    out_dir = out_dir or os.path.join(ctx.path_finder.root, "encoded")
    os.makedirs(out_dir, exist_ok=True)
    n_trees = leaves.shape[1]
    header = ["tag", "weight"] + [f"tree_{i}" for i in range(n_trees)]
    with atomic_write(os.path.join(out_dir, ".pig_header"), "w") as f:
        f.write("|".join(header) + "\n")
    text = leaves.astype(str)
    with atomic_write(os.path.join(out_dir, "part-00000"), "w") as f:
        for i in range(leaves.shape[0]):
            f.write(f"{int(dset.tags[i])}|{dset.weights[i]:.6g}|"
                    + "|".join(text[i]) + "\n")
    if report is not None:
        report.update(rows=int(leaves.shape[0]), trees=int(n_trees))
    log.info("encode: %d rows × %d trees → %s in %.2fs", leaves.shape[0],
             n_trees, out_dir, time.time() - t0)
    return 0
