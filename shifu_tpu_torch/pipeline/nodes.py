"""The DAG's step registry and node builders — the port of
`shifu_tpu/pipeline/nodes.py`.

`STEP_REGISTRY` holds the pipeline's dependency structure: one entry a
`step_guard` manifest name (family entries like ``eval`` cover the
per-instance ``eval.<name>`` guards), plus the unguarded ``init`` root
whose completion marker is ColumnConfig.json itself. It is the JAX
package's registry; `tests/test_torch_pipeline_dag.py` checks both
directions against the port's `step_guard` call sites.

Node bodies are CLI subprocesses (``python -m shifu_tpu_torch --dir
<root> <cmd> [--device D]``, the log in ``tmp/dag_logs/<node>.log``):
a step a process keeps the abort scope, the kernels' launch counters
and the fault counters as isolated as a sequential run keeps them.
Every builder takes ``device`` (default ``"cuda"``) and appends
``--device <device>`` to the steps whose verb has the flag (stats,
norm, train, posttrain, eval). Multi-algorithm and grid-search fan-outs
train siblings in clone workspaces under ``tmp/dag_models/<name>`` that
share the parent's normalized data by symlink; the kernels they build
are shared through the package's ``build/`` directory.

Fan-out siblings declare a demand, an equal split of the card pool
(`_sibling_demand`), so the scheduler leases them disjoint cards when
the host has more than one; on one card they share it.
"""

from __future__ import annotations

import json
import logging
import os
import shutil
import subprocess
import sys
from typing import Callable, Dict, List, NamedTuple, Optional, Sequence, Tuple

from shifu_tpu_torch.config.environment import knob_bool, knob_int
from shifu_tpu_torch.pipeline.scheduler import Node

log = logging.getLogger("shifu_tpu_torch")


class StepSpec(NamedTuple):
    """Registry entry of one pipeline step.

    ``manifest``: the step brackets itself with `step_guard` and owns
    ``tmp/manifests/<name>.json``. ``family``: the guard name is
    per-instance (``<name>.<instance>``, e.g. ``eval.Eval1``).
    ``device``: contends for a lease (timeshared: the
    SHIFU_TPU_DAG_WORKERS slots); host-only steps bypass both.
    ``devices`` is the step's demand in cards (None = the whole pool);
    fan-out builders give each sibling an equal split."""

    deps: Tuple[str, ...]
    device: bool
    manifest: bool
    family: bool = False
    doc: str = ""
    devices: Optional[int] = None


STEP_REGISTRY: Dict[str, StepSpec] = {
    "init":      StepSpec((), False, False, False,
                          "raw header → ColumnConfig.json"),
    "stats":     StepSpec(("init",), True, True, False,
                          "column stats, binning, KS/IV"),
    "stats.seg": StepSpec(("stats",), True, True, True,
                          "one segment expression's stats partial"),
    "stats.segmerge": StepSpec(("stats.seg",), False, True, False,
                               "merge base + segment partials"),
    "norm":      StepSpec(("stats",), True, True, False,
                          "normalized + cleaned training data"),
    "varselect": StepSpec(("norm",), True, True, False,
                          "sensitivity-based feature selection"),
    "train":     StepSpec(("norm",), True, True, False,
                          "model training (NN/GBT/WDL/…)"),
    "posttrain": StepSpec(("train",), False, True, False,
                          "bin-avg scores + feature importance"),
    "eval":      StepSpec(("train",), True, True, True,
                          "per-eval-set scoring + metrics"),
    "export":    StepSpec(("train",), False, True, True,
                          "pmml/columnstats/encoder export"),
}

# the verbs whose port CLI takes `--device`
_DEVICE_VERBS = ("stats", "norm", "train", "posttrain", "eval")


def _with_device(cmd: Sequence[str], device: str) -> List[str]:
    cmd = list(cmd)
    return cmd + ["--device", device] if cmd[0] in _DEVICE_VERBS else cmd


def run_logged(argv: Sequence[str], root: str, node: str,
               env_extra: Optional[Dict[str, str]] = None) -> None:
    """`argv` as a subprocess, its stdout and stderr in
    ``<root>/tmp/dag_logs/<node>.log``. Raises RuntimeError with the
    log's tail on a non-zero exit."""
    log_dir = os.path.join(root, "tmp", "dag_logs")
    os.makedirs(log_dir, exist_ok=True)
    log_path = os.path.join(log_dir, f"{node.replace('/', '_')}.log")
    env = dict(os.environ)
    env.update(env_extra or {})
    # the log is tailed while the step runs, so it is written in place
    with open(log_path, "w") as lf:
        rc = subprocess.call(list(argv), stdout=lf,
                             stderr=subprocess.STDOUT, env=env)
    if rc != 0:
        try:
            with open(log_path, errors="replace") as lf:
                tail = "".join(lf.readlines()[-15:])
        except OSError:
            tail = "<log unavailable>"
        raise RuntimeError(f"DAG node {node}: `{' '.join(argv[1:])}` "
                           f"exited {rc} (log: {log_path})\n{tail}")


def _run_cli(root: str, cmd: Sequence[str], node: str,
             env_extra: Optional[Dict[str, str]] = None) -> None:
    """One pipeline step as a CLI subprocess of the port (`run_logged`)."""
    run_logged([sys.executable, "-m", "shifu_tpu_torch", "--dir", root,
                *cmd], root, node, env_extra)


def _manifest_done(root: str, step: str) -> Callable[[], bool]:
    """The RESUME test of a node: the step's manifest matches the
    inputs a fresh run would fingerprint and its outputs exist (the
    test `step_guard` applies, without loading the processor)."""
    def check() -> bool:
        from shifu_tpu_torch.processor.base import (ProcessorContext,
                                                    manifest_complete)
        return manifest_complete(
            ProcessorContext.load(root, need_columns=False), step)
    return check


def _column_config_done(root: str) -> Callable[[], bool]:
    def check() -> bool:
        from shifu_tpu_torch.config.model_config import ModelConfig
        from shifu_tpu_torch.config.path_finder import PathFinder
        mc = ModelConfig.load(root)
        return os.path.exists(PathFinder(mc, root=root).column_config_path())
    return check


def _resume_enabled(resume: Optional[bool]) -> bool:
    return knob_bool("SHIFU_TPU_RESUME") if resume is None else bool(resume)


def _merge_env(base: Optional[Dict[str, str]],
               lease: Optional[Dict[str, str]]) -> Optional[Dict[str, str]]:
    if not lease:
        return base
    out = dict(base or {})
    out.update(lease)
    return out


def _sibling_demand(n_siblings: int) -> Optional[int]:
    """A fan-out sibling's demand: an equal split of the card pool, one
    card at least. None (the whole pool) for a single sibling or a pool
    of one card or none: the scheduler then timeshares."""
    if n_siblings <= 1:
        return None
    total = knob_int("SHIFU_TPU_DAG_DEVICES")
    if not total:
        from shifu_tpu_torch.pipeline.scheduler import _card_count
        total = _card_count()
    if total and int(total) > 1:
        return max(1, int(total) // n_siblings)
    return None


def _node(root: str, step: str, cmd: Sequence[str], deps: Tuple[str, ...],
          resume: bool, name: Optional[str] = None,
          env_extra: Optional[Dict[str, str]] = None,
          devices: Optional[int] = None) -> Node:
    # the longest registered dotted prefix: "eval.Eval1" → "eval",
    # "stats.seg.3" → "stats.seg"
    key = step
    while key not in STEP_REGISTRY and "." in key:
        key = key.rsplit(".", 1)[0]
    spec = STEP_REGISTRY[key]
    name = name or step
    if not resume:
        done = None
    elif step == "init":
        done = _column_config_done(root)
    else:
        done = _manifest_done(root, step)
    return Node(name=name,
                fn=lambda lease_env=None: _run_cli(
                    root, cmd, name, _merge_env(env_extra, lease_env)),
                deps=deps, device=spec.device, done_check=done,
                devices=devices if devices is not None else spec.devices)


# ---------------------------------------------------------------------------
# builders
# ---------------------------------------------------------------------------

def _segment_count(root: str) -> int:
    try:
        from shifu_tpu_torch.config.model_config import ModelConfig
        from shifu_tpu_torch.data import segment
        return len(segment.segment_expressions(ModelConfig.load(root)))
    except Exception:  # noqa: BLE001 — no config yet: no segment fan-out
        return 0


def _stats_nodes(root: str, res: bool, device: str
                 ) -> Tuple[List[Node], str]:
    """Stats as DAG nodes: without segment expressions the one inline
    node; with K of them `stats -base-only`, then a ``stats.seg.<k>``
    sibling an expression (each fills only its block, into a tmp
    partial), then the host-only ``stats.segmerge`` that stitches base
    and partials into ColumnConfig.json, equal to the inline expansion.
    Returns the nodes and the name downstream steps depend on."""
    n_seg = _segment_count(root)
    if not n_seg:
        return [_node(root, "stats", _with_device(["stats"], device),
                      ("init",), res)], "stats"
    nodes = [_node(root, "stats", _with_device(["stats", "-base-only"],
                                               device), ("init",), res)]
    for k in range(1, n_seg + 1):
        nodes.append(_node(root, f"stats.seg.{k}", _with_device(
            ["stats", "-seg", str(k)], device), ("stats",), res))
    nodes.append(_node(root, "stats.segmerge",
                       _with_device(["stats", "-seg-merge"], device),
                       tuple(f"stats.seg.{k}"
                             for k in range(1, n_seg + 1)), res))
    return nodes, "stats.segmerge"


def _head_nodes(root: str, res: bool, device: str) -> List[Node]:
    stats_nodes, stats_dep = _stats_nodes(root, res, device)
    return [_node(root, "init", ["init"], (), res), *stats_nodes,
            _node(root, "norm", _with_device(["norm"], device),
                  (stats_dep,), res)]


def pipeline_nodes(root: str, eval_sets: Sequence[str] = (),
                   algorithms: Sequence[str] = (),
                   posttrain: bool = False,
                   resume: Optional[bool] = None,
                   device: str = "cuda") -> List[Node]:
    """The pipeline as a DAG: init → stats → norm → train, then every
    eval set as a sibling node. With ``algorithms`` (e.g. ``["GBT",
    "RF"]``) training fans out: the first algorithm trains in the model
    set, the rest in clone workspaces sharing its normalized data."""
    res = _resume_enabled(resume)
    nodes = _head_nodes(root, res, device)
    train_cmd = _with_device(["train"], device)
    algorithms = list(algorithms)
    if len(algorithms) > 1:
        share = _sibling_demand(len(algorithms))
        train_name = f"train.{algorithms[0]}"
        nodes.append(_node(root, "train", train_cmd, ("norm",), res,
                           name=train_name, devices=share))
        for alg in algorithms[1:]:
            nodes.append(variant_node(root, f"train.{alg}", ("norm",),
                                      algorithm=alg, resume=res,
                                      devices=share, device=device))
    else:
        train_name = "train"
        nodes.append(_node(root, "train", train_cmd, ("norm",), res))
    ev_share = _sibling_demand(len(eval_sets))
    for ev in eval_sets:
        nodes.append(_node(root, f"eval.{ev}",
                           _with_device(["eval", "-run", ev], device),
                           (train_name,), res, devices=ev_share))
    if posttrain:
        nodes.append(_node(root, "posttrain",
                           _with_device(["posttrain"], device),
                           (train_name,), res))
    return nodes


def grid_nodes(root: str, grid_params: Sequence[Dict],
               resume: Optional[bool] = None,
               device: str = "cuda") -> List[Node]:
    """Grid-search fan-out: one sibling ``train.grid<i>`` node a
    parameter dict (see `train.grid_search.expand`), each in its own
    clone workspace off the shared norm output."""
    res = _resume_enabled(resume)
    nodes = _head_nodes(root, res, device)
    share = _sibling_demand(len(grid_params))
    for i, params in enumerate(grid_params):
        nodes.append(variant_node(root, f"train.grid{i}", ("norm",),
                                  params=params, resume=res,
                                  devices=share, device=device))
    return nodes


def variant_node(root: str, name: str, deps: Tuple[str, ...],
                 algorithm: Optional[str] = None,
                 params: Optional[Dict] = None,
                 resume: bool = False,
                 env_extra: Optional[Dict[str, str]] = None,
                 devices: Optional[int] = None,
                 device: str = "cuda") -> Node:
    """A sibling trainer in a clone workspace under
    ``tmp/dag_models/<name>``: the same data and ColumnConfig, another
    algorithm and/or train params. The clone is prepared inside the
    node's body, once the parent's norm has finished."""
    clone = variant_dir(root, name)

    def fn(lease_env: Optional[Dict[str, str]] = None) -> None:
        prepare_variant(root, clone, algorithm=algorithm, params=params)
        _run_cli(clone, _with_device(["train"], device), name,
                 _merge_env(env_extra, lease_env))

    done = _manifest_done(clone, "train") if resume else None
    return Node(name=name, fn=fn, deps=deps, device=True,
                done_check=done, devices=devices)


def variant_dir(root: str, name: str) -> str:
    return os.path.join(root, "tmp", "dag_models",
                        name.replace("/", "_"))


def _absolutize(obj, base: str):
    """Every relative local path-valued field (``*Path``/``*File``) of
    a raw ModelConfig dict, resolved against the parent model set: a
    clone lives under tmp/ and must keep reading the parent's files."""
    from shifu_tpu_torch.fileio import has_scheme
    if isinstance(obj, dict):
        out = {}
        for k, v in obj.items():
            if isinstance(v, str) and v and \
                    (k.endswith("Path") or k.endswith("File")) and \
                    not has_scheme(v) and not os.path.isabs(v):
                out[k] = os.path.join(base, v)
            else:
                out[k] = _absolutize(v, base)
        return out
    if isinstance(obj, list):
        return [_absolutize(v, base) for v in obj]
    return obj


def prepare_variant(root: str, clone: str, algorithm: Optional[str] = None,
                    params: Optional[Dict] = None) -> str:
    """Make a clone workspace: the parent's ModelConfig with the
    algorithm/params switched (paths absolutized), the parent's
    ColumnConfig copied, normalized and cleaned data shared by symlink
    so the fan-out never re-reads or re-normalizes."""
    from shifu_tpu_torch.fileio import atomic_write
    os.makedirs(os.path.join(clone, "tmp"), exist_ok=True)
    with open(os.path.join(root, "ModelConfig.json")) as f:
        raw = json.load(f)
    raw = _absolutize(raw, root)
    if algorithm:
        raw["train"]["algorithm"] = algorithm
    if params:
        raw["train"]["params"] = params
    name = raw.get("basic", {}).get("name", "model")
    raw.setdefault("basic", {})["name"] = \
        f"{name}:{os.path.basename(clone)}"
    with atomic_write(os.path.join(clone, "ModelConfig.json")) as f:
        json.dump(raw, f, indent=2)
    cc_src = os.path.join(root, "ColumnConfig.json")
    if os.path.exists(cc_src):
        shutil.copyfile(cc_src, os.path.join(clone, "ColumnConfig.json"))
    for d in ("NormalizedData", "CleanedData"):
        src = os.path.join(root, "tmp", d)
        dst = os.path.join(clone, "tmp", d)
        if os.path.isdir(src) and not os.path.lexists(dst):
            os.symlink(src, dst)
    return clone
