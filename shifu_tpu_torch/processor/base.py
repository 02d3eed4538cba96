"""Shared processor lifecycle — the port of `shifu_tpu/processor/base.py`:
`ProcessorContext` (`load`, `validate`, `save_column_configs`,
`require_columns`) and the per-step completion manifests.

`step_guard` brackets a step: on entry it points the abort scope at
the model set's ``tmp/``, removes the step's manifest, clears the
abort and preempt markers, sweeps the outputs' directories of temp
residue and fires the ``step.<name>`` fault site; on a clean exit it
writes ``tmp/manifests/<step>.json`` atomically (the inputs'
fingerprint, taken after the body, and the outputs) and counts the
step in the metrics store. A kill mid-step leaves no manifest, so the
next run redoes the step; its outputs were staged through
`fileio.atomic_write` / `atomic_path` and never half-published. With
``SHIFU_TPU_RESUME=1``, a manifest that matches the inputs and whose
outputs all exist skips the step. `_inputs_fingerprint` hashes the same
bytes in the same order as the JAX package's, so both packages give
one hex digest for one model set.
"""

from __future__ import annotations

import hashlib
import json
import logging
import os
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import List, Sequence

from shifu_tpu_torch.config.column_config import (ColumnConfig,
                                                  load_column_configs,
                                                  save_column_configs)
from shifu_tpu_torch.config.inspector import ModelStep, probe
from shifu_tpu_torch.config.model_config import ModelConfig
from shifu_tpu_torch.config.environment import knob_bool
from shifu_tpu_torch.config.path_finder import PathFinder
from shifu_tpu_torch.fileio import atomic_write

log = logging.getLogger("shifu_tpu_torch")


@dataclass
class ProcessorContext:
    model_config: ModelConfig
    column_configs: List[ColumnConfig] = field(default_factory=list)
    path_finder: PathFinder = None  # type: ignore[assignment]

    @classmethod
    def load(cls, model_set_dir: str, need_columns: bool = True
             ) -> "ProcessorContext":
        mc = ModelConfig.load(model_set_dir)
        pf = PathFinder(mc, root=model_set_dir if os.path.isdir(model_set_dir)
                        else os.path.dirname(model_set_dir))
        ccs: List[ColumnConfig] = []
        cc_path = pf.column_config_path()
        if need_columns and os.path.exists(cc_path):
            ccs = load_column_configs(cc_path)
        return cls(model_config=mc, column_configs=ccs, path_finder=pf)

    def validate(self, step: ModelStep) -> None:
        res = probe(self.model_config, step)
        for w in res.warnings:
            log.warning("config: %s", w)
        if not res.status:
            raise ValueError(
                f"ModelConfig validation failed for step {step.value}: "
                + "; ".join(res.causes))

    def save_column_configs(self) -> None:
        save_column_configs(self.column_configs,
                            self.path_finder.column_config_path())

    def require_columns(self) -> None:
        if not self.column_configs:
            raise FileNotFoundError(
                f"ColumnConfig.json not found under {self.path_finder.root}; "
                "run `init` first")


# ---------------------------------------------------------------------------
# per-step completion manifests
# ---------------------------------------------------------------------------

def _inputs_fingerprint(ctx: ProcessorContext) -> str:
    """sha256 of ModelConfig.json and ColumnConfig.json (each followed
    by a NUL, ``<missing>`` for an absent file), then ``path:size`` of
    each data file in `expand_data_files` order — the raw data's
    identity, not its contents."""
    h = hashlib.sha256()
    for path in (ctx.path_finder.model_config_path(),
                 ctx.path_finder.column_config_path()):
        try:
            with open(path, "rb") as f:
                h.update(f.read())
        except OSError:
            h.update(b"<missing>")
        h.update(b"\x00")
    try:
        from shifu_tpu_torch.data import reader
        dp = ctx.model_config.resolve_path(ctx.model_config.dataSet.dataPath)
        for p in reader.expand_data_files(dp):
            h.update(f"{p}:{os.path.getsize(p)}".encode())
    except Exception:  # noqa: BLE001 — data identity is best-effort
        h.update(b"<no-data-stat>")
    return h.hexdigest()


def manifest_complete(ctx: ProcessorContext, step: str) -> bool:
    """True when `step`'s manifest matches the current inputs'
    fingerprint and every recorded output still exists: the
    SHIFU_TPU_RESUME skip test."""
    mpath = ctx.path_finder.manifest_path(step)
    if not os.path.exists(mpath):
        return False
    try:
        with open(mpath) as f:
            man = json.load(f)
    except (OSError, ValueError):
        return False
    return bool(man) \
        and man.get("fingerprint") == _inputs_fingerprint(ctx) \
        and all(os.path.exists(p) for p in man.get("outputs", []))


@contextmanager
def step_guard(ctx: ProcessorContext, step: str,
               outputs: Sequence[str] = ()):
    """Crash-safe step bracketing (module docstring). Yields True when
    the step should run; False (skip) only under SHIFU_TPU_RESUME=1
    with a complete, matching manifest. A declared output missing after
    the body gets a log line and no manifest."""
    from shifu_tpu_torch import resilience
    pf = ctx.path_finder
    mpath = pf.manifest_path(step)
    if knob_bool("SHIFU_TPU_RESUME") and os.path.exists(mpath):
        if manifest_complete(ctx, step):
            log.info("step %s: complete (manifest matches inputs and all "
                     "outputs present) — skipping; unset "
                     "SHIFU_TPU_RESUME to force a re-run", step)
            yield False
            return
        log.info("step %s: stale/mismatched manifest — re-running", step)
    resilience.set_abort_scope(os.path.join(pf.root, "tmp"))
    if os.path.exists(mpath):
        os.remove(mpath)
    resilience.clear_abort()
    resilience.clear_preempt_marker()
    for d in {os.path.dirname(p) for p in outputs if p}:
        resilience.sweep_stale(d)
    resilience.fault_point(f"step.{step}")
    yield True
    # reaching here means the step body finished without raising
    missing = [p for p in outputs if not os.path.exists(p)]
    if missing:
        log.warning("step %s: declared output(s) missing after run (%s) "
                    "— manifest not written", step, ", ".join(missing))
        return
    os.makedirs(os.path.dirname(mpath), exist_ok=True)
    # fingerprint after the body: a step that rewrites its own inputs
    # (stats fills ColumnConfig.json) records what a re-run would see
    with atomic_write(mpath) as f:
        json.dump({"step": step, "fingerprint": _inputs_fingerprint(ctx),
                   "outputs": list(outputs)}, f, indent=1)
    from shifu_tpu_torch.obs.health import store as health_store
    health_store.step_completed(pf.root, step)
