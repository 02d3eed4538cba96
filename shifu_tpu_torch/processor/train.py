"""`shifu train` — the tree branch of `shifu_tpu/processor/train.py`
(`run`, lines 35-88).

GBT, RF and DT train on the port (`processor/train_tree`). The dense
family (NN, LR, SVM, TENSORFLOW) and WDL/MTL raise until their slices
land; so do the config probe (`validate`), the step manifests and the
supervised restart loop of the JAX package's `run`.
"""

from __future__ import annotations

import logging
import time

import torch

from shifu_tpu_torch.config.model_config import Algorithm
from shifu_tpu_torch.processor.base import ProcessorContext

log = logging.getLogger("shifu_tpu_torch")


def run(ctx: ProcessorContext, seed: int = 12306,
        device: "str | torch.device" = "cuda") -> int:
    t0 = time.time()
    mc = ctx.model_config
    ctx.require_columns()
    alg = mc.train.algorithm

    if mc.is_multi_classification and \
            alg not in (Algorithm.NN, Algorithm.LR, Algorithm.SVM):
        raise ValueError(
            f"multi-class (>2 tags) is supported for NN/LR/SVM, not "
            f"{alg.value}; the reference likewise restricts "
            f"multiClassifyMethod to its NN-family trainers")
    if alg.is_tree:
        from shifu_tpu_torch.processor import train_tree
        train_tree.run_tree(ctx, seed, device)
    elif alg in (Algorithm.NN, Algorithm.LR, Algorithm.SVM,
                 Algorithm.TENSORFLOW):
        raise NotImplementedError(
            f"training {alg.value} is not ported yet: it comes with the "
            "NN training slice (ROADMAP A1)")
    elif alg in (Algorithm.WDL, Algorithm.MTL):
        raise NotImplementedError(
            f"training {alg.value} is not ported yet: it comes with the "
            "WDL/MTL slice (ROADMAP A3)")
    else:
        raise ValueError(f"unsupported algorithm {alg}")
    log.info("train[%s] done in %.2fs", alg.value, time.time() - t0)
    return 0
