"""Command line of the port — the verbs of `shifu_tpu/cli.py` (the DAG
verbs, `ingest`, `ckpt`, `top` and `trace` come later: ROADMAP A7.4,
A8).

    python -m shifu_tpu_torch --dir <dir> new <name>
    python -m shifu_tpu_torch --dir <model-set> init
    python -m shifu_tpu_torch --dir <model-set> stats [--device cuda|cpu]
        [-correlation | -psi | -rebin [-vars a,b] [-n N] [-ivr R]
         [-bic C]]
    python -m shifu_tpu_torch --dir <model-set> norm [--device cuda|cpu]
    python -m shifu_tpu_torch --dir <model-set> varsel [-r N]
        [-reset | -list | -f FILE] [--device cuda|cpu]
    python -m shifu_tpu_torch --dir <model-set> train [--device cuda|cpu]
    python -m shifu_tpu_torch --dir <model-set> posttrain
        [--device cuda|cpu]
    python -m shifu_tpu_torch --dir <model-set> eval [-run NAME]
        [-list | -new NAME | -delete NAME | -norm | -audit [-n N]
         | -score [NAME] | -confmat [NAME] | -perf [NAME]]
        [--device cuda|cpu]
    python -m shifu_tpu_torch --dir <model-set> export [-t TYPE]
        [--device cuda|cpu]
    python -m shifu_tpu_torch --dir <model-set> encode [--device cuda|cpu]
    python -m shifu_tpu_torch --dir <model-set> convert SRC OUT
    python -m shifu_tpu_torch --dir <model-set> save [NAME] | switch NAME
        | show
    python -m shifu_tpu_torch --dir <model-set> serve [--port P]
        [--no-http] [--duration-s S] [--device cuda|cpu]
        [--registry DIR [--models NAME,NAME]]
    python -m shifu_tpu_torch --dir <workspace> registry
        publish|ls|rollback|gc [--registry DIR] [--name NAME]
        [--models DIR] [--priority high|low] [--max-delay-ms MS]
        [--to vNNN] [--keep K]
    python -m shifu_tpu_torch --dir <model-set> watch --monitor-only
        [--interval-s S] [--iterations N] [--device cuda|cpu]
    python -m shifu_tpu_torch --dir <model-set> health [--trend N]
    python -m shifu_tpu_torch knobs [--all] [--markdown]
    python -m shifu_tpu_torch version

`new` writes a model-set scaffold; `init` writes ColumnConfig.json from
the header and a sample read (no device work); `stats` fills it with
binning and statistics (and DateStats when `dataSet#dateColumnName` is
set), `stats -correlation` writes correlation.csv, `stats -psi` each
column's PSI over the `stats#psiColumnName` cohorts, and `stats -rebin`
merges the recorded bins (host only); `norm` writes
`tmp/NormalizedData` and `tmp/CleanedData`. Each prints one JSON line:
the step, the device, the rows, the wall seconds, and for `stats`/`norm`
the seconds spent reading the raw table. Past its size trigger, or with
SHIFU_TPU_{STATS,NORM}_CHUNK_ROWS set, `stats` and `norm` read the raw
set in chunks (the streaming steps); likewise `eval` past
SHIFU_TPU_EVAL_CHUNK_ROWS and `stats -correlation`/`-psi` and varselect
past SHIFU_TPU_ANALYSIS_CHUNK_ROWS. The `stats` variants `-seg`,
`-seg-merge` and `-base-only` (the DAG's per-segment siblings) are not
ported yet and raise, naming their ROADMAP item.

`varsel` sets `finalSelect` by the model set's `varSelect#filterBy`:
KS/IV/MIX/PARETO on the host; SE/ST/SC (quick NN training and column
ablations), V (the voted wrapper's population training) and FI (a tree
model trained through `norm` and `train`, kernels K3/K4 and K5) on
`--device`. Its JSON line adds the filter, the columns selected, V's
best validation error a generation, and the tree kernels' launches.
`-reset`, `-list` and `-f` edit the selection on the host.

`posttrain` writes `binAvgScore` into ColumnConfig.json and
`featureimportance.csv`; `eval` scores the eval sets and writes their
outputs under `evals/<name>/` (the flags pick one step, in the JAX
package's order). Both print one JSON line: the step, the device, the
rows, the wall seconds, the seconds reading the raw set and in
`Scorer.score`, and the launches of the scoring kernels (`fused_score`,
`fused_trees`) during the run. `eval -list`, `-new` and `-delete` do no
device work and report the device as "host".

`export -t` writes columnstats, woemapping, woe, pmml, baggingpmml,
bagging and the ume types on the host, and correlation on `--device`;
`-t tf` raises (it needs tensorflow). `encode` writes the tree-leaf encoding of
the training set (`encoded/`) on `--device`; `convert` turns a model
spec into an open zip bundle and back; `save`, `switch` and `show` keep
versions of the model set under `.shifu-versions/`. `combo` and `test`
run through the pipeline DAG, which is not ported yet: they raise
(ROADMAP A8).

`serve` serves every model spec under ``<model-set>/models`` (the
`PathFinder.models_path()` rule) until SIGTERM/SIGINT or `--duration-s`,
then prints the service stats as one JSON line; on the card each (model,
bucket) is one captured CUDA graph. With `--registry` it hosts a model
fleet instead: every published model (or `--models`) behind `POST
/score/<model>`, LRU-evicted under SHIFU_TPU_FLEET_HBM_MB and shedding
low-priority load past SHIFU_TPU_FLEET_SLO_P99_MS. With
SHIFU_TPU_METRICS=1 it flushes `serve.*` points into the model set's
`tmp/metrics/metrics.jsonl`, and `/healthz` reports the SLO state.
`registry` publishes a model set's specs as an immutable version
(atomic HEAD flip), lists, rolls HEAD back and gc's old versions (host
only). `watch --monitor-only` tails the training dataPath, bins each
new window on `--device` against the frozen training bins (rolling
PSI/KS), evaluates the SLO guardrails and writes everything to the
metrics store; without `--monitor-only`, and with `--ingest`, it raises
(ROADMAP A7.4). `health` prints each SLO's state with a sparkline of
its metric, the canary arms' lines and the recent events, and exits 1
on a breach. `train` trains the
model set's algorithm — GBT/RF/DT from `tmp/CleanedData` into
``models/model<bag>.{gbt,rf}``, NN/LR/SVM/TENSORFLOW, WDL and MTL from
`tmp/NormalizedData` into ``models/model<bag>.{nn,lr,wdl,mtl}``; with
`train#trainOnDisk` from the `.npy` layout `norm` wrote, a chunk at a
time — and prints one JSON line: the algorithm, the device, the wall
seconds and the launches of each tree-training kernel during the run;
for the dense families also the training rows, the bags, the epochs,
the trainer's seconds and each saved model's best validation error,
best epoch and per-epoch train and validation errors; its clock starts
once the card's context exists.
`--device` defaults to the card and raises when there is none.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
from typing import List, Optional

log = logging.getLogger("shifu_tpu_torch")


def models_path(model_set_dir: str) -> str:
    """`PathFinder.models_path()`: ``models/`` under the model-set
    root."""
    return os.path.join(os.path.abspath(model_set_dir), "models")


def cmd_serve(args) -> int:
    """Serve the model set (or, with --registry, a fleet) until
    SIGTERM/SIGINT or --duration-s; then print the stats as one JSON
    line."""
    import time

    from shifu_tpu_torch import resilience
    from shifu_tpu_torch.serve.http import HttpFrontEnd
    workspace = os.path.abspath(args.dir)
    front = None
    if args.registry:
        from shifu_tpu_torch.serve.fleet import FleetService
        names = [n for n in (args.models or "").split(",") if n] or None
        owner = FleetService(args.registry, names=names,
                             workspace_root=workspace,
                             device=args.device).start()
        log.info("fleet warm: %s", owner.stats()["fleet"])
        if not args.no_http:
            front = HttpFrontEnd(fleet=owner, port=args.port).start()
            log.info("serving fleet HTTP on %s:%d", *front.address)
    else:
        from shifu_tpu_torch.serve.service import ScorerService
        owner = ScorerService(models_dir=models_path(args.dir),
                              device=args.device,
                              workspace_root=workspace).start()
        log.info("scorer service warm: %s", owner.stats())
        if not args.no_http:
            front = HttpFrontEnd(owner, port=args.port).start()
            log.info("serving HTTP on %s:%d", *front.address)
    deadline = time.monotonic() + args.duration_s if args.duration_s \
        else None
    try:
        with resilience.graceful_shutdown("serving"):
            while not resilience.preempt_requested():
                if deadline is not None and time.monotonic() >= deadline:
                    break
                time.sleep(min(0.2, max(0.0, deadline - time.monotonic()))
                           if deadline is not None else 0.2)
    except KeyboardInterrupt:
        pass
    finally:
        if front is not None:
            front.close()
        owner.close()
    print(json.dumps(owner.stats()))
    return 0


def cmd_registry(args) -> int:
    """Versioned model publishing (host only): publish the model set's
    trained specs as an immutable version (atomic HEAD flip), list what
    is registered, roll HEAD back, or gc old versions."""
    from shifu_tpu_torch import registry as reg
    root = args.registry or os.path.join(args.dir or ".", "registry")
    if args.action == "publish":
        if not args.name:
            raise SystemExit("registry publish: --name is required")
        version = reg.publish(root, args.name,
                              args.models or models_path(args.dir),
                              priority=args.priority,
                              max_delay_ms=args.max_delay_ms)
        print(json.dumps({"name": args.name, "version": version,
                          "head": reg.head(root, args.name)}))
        return 0
    if args.action == "ls":
        print(json.dumps(reg.ls(root), indent=1))
        return 0
    if args.action == "rollback":
        if not args.name:
            raise SystemExit("registry rollback: --name is required")
        version = reg.rollback(root, args.name, to=args.to)
        print(json.dumps({"name": args.name, "head": version}))
        return 0
    # gc; no --name sweeps every registered model
    names = [args.name] if args.name else \
        [row["name"] for row in reg.ls(root)]
    out = [{"name": name, "removed": reg.gc(root, name, keep=args.keep),
            "versions": reg.versions(root, name)} for name in names]
    print(json.dumps(out if args.name is None else out[0]))
    return 0


def cmd_watch(args) -> int:
    """`watch --monitor-only`: rolling drift over the data arriving at
    the training dataPath and the SLO guardrails, into the metrics
    store. Full mode (the refresh loop) and --ingest are ROADMAP A7.4."""
    from shifu_tpu_torch import resolve_device
    from shifu_tpu_torch.obs.health import watch as watch_mod
    from shifu_tpu_torch.processor.base import ProcessorContext
    if args.ingest:
        raise NotImplementedError(f"watch --ingest {watch_mod.A74}")
    if not args.monitor_only:
        raise NotImplementedError(
            f"watch without --monitor-only {watch_mod.A74}")
    return watch_mod.run_monitor(
        ProcessorContext.load(os.path.abspath(args.dir)),
        interval_s=args.interval_s,
        iterations=args.iterations if args.iterations > 0 else None,
        device=resolve_device(args.device))


_SPARK_BARS = "▁▂▃▄▅▆▇█"


def _spark(values) -> str:
    """Unicode sparkline over a value series (empty-safe)."""
    vals = [float(v) for v in values]
    if not vals:
        return "-"
    lo, hi = min(vals), max(vals)
    if hi <= lo:
        return _SPARK_BARS[0] * len(vals)
    scale = (len(_SPARK_BARS) - 1) / (hi - lo)
    return "".join(_SPARK_BARS[int((v - lo) * scale)] for v in vals)


def _last_values(st, name: str, key: str) -> dict:
    """{tags[key] (and tags["arm"] when present): the newest value} of
    metric `name` in the store; rollups give their last sample."""
    out = {}
    for p in st.read_points(names=[name]):
        t = p.get("tags") or {}
        v = p.get("value")
        if isinstance(v, dict):
            v = v.get("last")
        if isinstance(v, (int, float)) and t.get(key):
            out[(t[key], t.get("arm"))] = float(v)
    return out


def _canary_lines(st) -> list:
    """Live-promotion status lines from the metrics store: the last
    canary phase transition per model plus the newest per-arm p99 and
    between-arms PSI gauges the fleet flushed. Empty when no arm ever
    started."""
    phases = {}
    for ev in st.events(limit=50, names=["canary"]):
        tags = ev.get("tags") or {}
        if tags.get("model"):
            phases[tags["model"]] = tags
    if not phases:
        return []
    p99 = _last_values(st, "serve.arm_p99_ms", "model")
    psi = _last_values(st, "canary.arm_psi", "model")
    lines = ["canary arms:"]
    for model, tags in sorted(phases.items()):
        bits = [f"phase={tags.get('phase', '?')}"]
        bits += [f"{k}={tags[k]}" for k in ("run", "version", "shadow_pct",
                                             "canary_pct") if k in tags]
        bits += [f"p99[{arm}]={v:.3f}ms"
                 for (m, arm), v in sorted(p99.items(), key=str)
                 if m == model and arm]
        if (model, None) in psi:
            bits.append(f"arm_psi={psi[(model, None)]:.4f}")
        lines.append(f"  {model}: " + " ".join(bits))
    return lines


def cmd_health(args) -> int:
    """Current SLO state over the metrics store: each rule's status with
    a sparkline of its metric, the canary arms, the recent events. Read
    only; rc 1 on a breach."""
    import time

    from shifu_tpu_torch.obs.health import slo as slo_mod
    from shifu_tpu_torch.obs.health import store as health_store
    root = os.path.abspath(args.dir)
    state = slo_mod.health_state(root)
    st = health_store.store(root)
    print(f"status: {state['status'].upper()}  ({root})")
    name_w = max([len(s["name"]) for s in state["slos"]] + [4])
    met_w = max([len(s["metric"]) for s in state["slos"]] + [6])
    print(f"{'slo':<{name_w}}  {'state':<6} {'value':>10}  "
          f"{'metric':<{met_w}}  trend")
    for s in state["slos"]:
        series = st.series(s["metric"], limit=args.trend)
        val = "-" if s["value"] is None else f"{s['value']:.4g}"
        print(f"{s['name']:<{name_w}}  {s['state']:<6} {val:>10}  "
              f"{s['metric']:<{met_w}}  "
              f"{_spark([v for _, v in series])}")
    for line in _canary_lines(st):
        print(line)
    events = state["recent_events"]
    if events:
        print("recent events:")
        for ev in events:
            tags = ev.get("tags") or {}
            ts = time.strftime("%m-%d %H:%M:%S",
                               time.localtime(ev.get("ts", 0)))
            detail = " ".join(f"{k}={v}" for k, v in sorted(tags.items()))
            print(f"  {ts}  {ev.get('name', '?'):<16} {detail}")
    return 0 if state["status"] != "breach" else 1


def _step_line(step: str, device: str, report: dict, t0: float,
               **extra) -> None:
    """One JSON line: the step, the device, the rows, the wall seconds,
    the read seconds (``read_s``) and whatever else the step reported,
    then `extra`."""
    import time
    line = {"step": step, "device": device, "rows": report.get("rows"),
            "seconds": time.perf_counter() - t0}
    if "read_s" in report:
        line["read_seconds"] = report["read_s"]
    line.update({k: v for k, v in report.items()
                 if k not in ("rows", "read_s")}, **extra)
    print(json.dumps(line))


def _host_step(step: str, fn, args, load: bool = True) -> int:
    """Run a host-only step (its arguments the loaded context, or None,
    and a report dict) and print its JSON line with the device "host",
    the step's rc and what it reported."""
    import time

    from shifu_tpu_torch.processor.base import ProcessorContext
    t0 = time.perf_counter()
    report: dict = {}
    rc = fn(ProcessorContext.load(os.path.abspath(args.dir))
            if load else None, report)
    _step_line(step, "host", report, t0, rc=rc)
    return rc


def _card_clock(dev) -> None:
    """Make the card's context before a step's clock starts."""
    import torch
    if dev.type == "cuda":
        torch.zeros(1, device=dev)
        torch.cuda.synchronize(dev)


def cmd_init(args) -> int:
    import time

    from shifu_tpu_torch.processor import init as init_proc
    from shifu_tpu_torch.processor.base import ProcessorContext
    t0 = time.perf_counter()
    report: dict = {}
    rc = init_proc.run(ProcessorContext.load(os.path.abspath(args.dir)),
                       report=report)
    _step_line("init", "host", report, t0)
    return rc


def _device_step(step: str, run, args) -> int:
    """Run a step on `--device` (its clock starts once the card's
    context exists) and print its JSON line."""
    import time

    import torch

    from shifu_tpu_torch import resolve_device
    from shifu_tpu_torch.processor.base import ProcessorContext
    dev = resolve_device(args.device)
    _card_clock(dev)
    t0 = time.perf_counter()
    report: dict = {}
    rc = run(ProcessorContext.load(os.path.abspath(args.dir)), device=dev,
             report=report)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    _step_line(step, str(dev), report, t0)
    return rc


_STATS_LEFT_OUT = ("seg", "seg_merge", "base_only")


def cmd_stats(args) -> int:
    from shifu_tpu_torch.processor import correlation, psi
    from shifu_tpu_torch.processor import stats as stats_proc
    for flag in _STATS_LEFT_OUT:
        if getattr(args, flag) not in (None, False):
            raise NotImplementedError(
                f"stats -{flag.replace('_', '-')} (the pipeline DAG's "
                "per-segment siblings) is not ported yet (ROADMAP A8)")
    if args.correlation:
        return _device_step("stats -correlation", correlation.run, args)
    if args.psi:
        return _device_step("stats -psi", psi.run, args)
    if args.rebin:
        return _host_step("stats -rebin", lambda ctx, _: stats_proc.run_rebin(
            ctx, request_vars=args.vars, expect_bin_num=args.n,
            iv_keep_ratio=args.ivr, min_inst_cnt=args.bic), args)
    return _device_step("stats", stats_proc.run, args)


def cmd_norm(args) -> int:
    from shifu_tpu_torch.processor import norm as norm_proc
    return _device_step("norm", norm_proc.run, args)


def _tree_kernel_counts() -> dict:
    from shifu_tpu_torch.ops import best_splits, level_hist
    return {"level_hist": level_hist.launches,
            "level_hist_fused": level_hist.fused_launches,
            "best_splits": best_splits.launches}


_DEVICE_FILTERS = ("SE", "ST", "SC", "V", "FI")


def cmd_varselect(args) -> int:
    """`varsel`: the host edits (-reset, -list, -f) and the statistical
    filters report the device "host"; SE/ST/SC, V and FI run on
    `--device`, their line with the tree kernels' launches (FI)."""
    import time

    import torch

    from shifu_tpu_torch import resolve_device
    from shifu_tpu_torch.processor import varselect as p
    from shifu_tpu_torch.processor.base import ProcessorContext
    ctx = ProcessorContext.load(os.path.abspath(args.dir))
    by = ctx.model_config.varSelect.filterBy.upper()
    edit = args.reset or args.list or args.file
    on_device = not edit and ctx.model_config.varSelect.filterEnable \
        and by in _DEVICE_FILTERS
    dev = resolve_device(args.device) if on_device else None
    if dev is not None:
        _card_clock(dev)
    before = _tree_kernel_counts()
    report: dict = {}
    t0 = time.perf_counter()
    rc = p.run(ctx, recursive=args.recursive, reset=args.reset,
               list_only=args.list, select_file=args.file,
               device=dev if dev is not None else "cpu", report=report)
    if dev is not None and dev.type == "cuda":
        torch.cuda.synchronize(dev)
    _step_line("varselect", str(dev) if dev is not None else "host",
               report, t0, filterBy=None if edit else by,
               launches={k: v - before[k]
                         for k, v in _tree_kernel_counts().items()})
    return rc


def cmd_export(args) -> int:
    """`export -t TYPE`: correlation on `--device`, every other type a
    host-side conversion (the ume types return 3 without their hook)."""
    from shifu_tpu_torch.processor import export as p
    if (args.type or "").lower() == "correlation":
        return _device_step("export -t correlation", lambda ctx, device,
                            report: p.run(ctx, "correlation", device=device,
                                          report=report), args)
    return _host_step(f"export -t {args.type}",
                      lambda ctx, _: p.run(ctx, args.type), args)


def cmd_encode(args) -> int:
    from shifu_tpu_torch.processor import encode as p
    return _device_step("encode", lambda ctx, device, report: p.run(
        ctx, device=device, report=report), args)


def cmd_convert(args) -> int:
    """`convert SRC OUT` — model spec ↔ open zip bundle
    (IndependentTreeModelUtils zip↔binary converter)."""
    from shifu_tpu_torch.models.spec import bundle_to_spec, spec_to_bundle

    def convert(_ctx, report) -> int:
        src, dst = args.src, args.out
        if src.endswith(".zip"):
            report["out"] = bundle_to_spec(src, dst)
        else:
            report["out"] = spec_to_bundle(
                src, dst if dst.endswith(".zip") else dst + ".zip")
        log.info("convert: %s → %s", src, report["out"])
        return 0
    return _host_step("convert", convert, args, load=False)


def cmd_new(args) -> int:
    """`new <name>` — scaffold ModelConfig.json + columns/ under
    ``--dir`` (CreateModelProcessor)."""
    import time

    from shifu_tpu_torch.config.model_config import ModelConfig

    def new(_ctx, report) -> int:
        root = os.path.join(args.dir, args.name)
        if os.path.exists(os.path.join(root, "ModelConfig.json")):
            log.error("model set %s already exists", args.name)
            return 1
        os.makedirs(os.path.join(root, "columns"), exist_ok=True)
        mc = ModelConfig()
        mc.basic.name = args.name
        mc.basic.author = os.environ.get("USER", "user")
        mc.basic.description = \
            f"Created at {time.strftime('%Y-%m-%d %H:%M:%S')}"
        mc.dataSet.dataPath = "./data"
        mc.dataSet.metaColumnNameFile = "columns/meta.column.names"
        mc.dataSet.categoricalColumnNameFile = \
            "columns/categorical.column.names"
        mc.varSelect.forceSelectColumnNameFile = \
            "columns/forceselect.column.names"
        mc.varSelect.forceRemoveColumnNameFile = \
            "columns/forceremove.column.names"
        mc.train.params = {"NumHiddenLayers": 1, "NumHiddenNodes": [50],
                           "ActivationFunc": ["tanh"], "LearningRate": 0.1,
                           "Propagation": "Q", "RegularizedConstant": 0.0}
        mc.save(root)
        for f in ("meta", "categorical", "forceselect", "forceremove"):
            open(os.path.join(root, "columns", f + ".column.names"),
                 "a").close()
        log.info("created model set %s", root)
        return 0
    return _host_step("new", new, args, load=False)


def cmd_save(args) -> int:
    from shifu_tpu_torch.processor import manage
    return _host_step("save", lambda ctx, _: manage.save(ctx, args.name),
                      args)


def cmd_switch(args) -> int:
    from shifu_tpu_torch.processor import manage
    return _host_step("switch", lambda ctx, _: manage.switch(ctx, args.name),
                      args)


def cmd_show(args) -> int:
    from shifu_tpu_torch.processor import manage

    def show(ctx, report) -> int:
        report["versions"] = manage.list_versions(ctx)
        return manage.show(ctx)
    return _host_step("show", show, args)


def cmd_version(args) -> int:
    import shifu_tpu_torch
    print(f"shifu-tpu-torch {shifu_tpu_torch.__version__}")
    return 0


def cmd_knobs(args) -> int:
    """Print the SHIFU_TPU_* knob registry of the port: every tunable it
    reads, with type, documented default, current value and doc (as a
    markdown table with `--markdown`). The port's knobs are all its
    own, so `--all` shows the same table."""
    import sys
    from shifu_tpu_torch.config.environment import knobs_rows
    rows = knobs_rows()
    try:
        if getattr(args, "markdown", False):
            print("| Knob | Type | Default | Doc |\n|---|---|---|---|")
            for r in rows:
                dflt = f"`{r['default']}`" if r["default"] else "*(unset)*"
                print(f"| `{r['name']}` | {r['type']} | {dflt} | "
                      f"{r['doc']} |")
            return 0
        name_w = max(len(r["name"]) for r in rows)
        type_w = max(len(r["type"]) for r in rows)
        dflt_w = max(max(len(r["default"]) for r in rows), len("default"))
        cur_w = max(max(len(r["current"]) for r in rows), len("current"))
        print(f"{'knob':<{name_w}}  {'type':<{type_w}}  "
              f"{'default':<{dflt_w}}  {'current':<{cur_w}}  doc")
        for r in rows:
            cur = r["current"] or "-"
            dflt = r["default"] or "-"
            print(f"{r['name']:<{name_w}}  {r['type']:<{type_w}}  "
                  f"{dflt:<{dflt_w}}  {cur:<{cur_w}}  {r['doc']}")
    except BrokenPipeError:
        # a pager closed the pipe: send stdout to devnull so the
        # interpreter's last flush does not raise again
        devnull = os.open(os.devnull, os.O_WRONLY)
        os.dup2(devnull, sys.stdout.fileno())
    return 0


def cmd_dag_verb(args) -> int:
    raise NotImplementedError(
        f"`{args.command}` runs through the pipeline DAG (`run_dag`), "
        "which is not ported yet (ROADMAP A8)")


def cmd_train(args) -> int:
    import time

    import torch

    from shifu_tpu_torch import resolve_device
    from shifu_tpu_torch.processor import train as train_proc
    from shifu_tpu_torch.processor.base import ProcessorContext
    counts = _tree_kernel_counts
    dev = resolve_device(args.device)
    ctx = ProcessorContext.load(os.path.abspath(args.dir))
    _card_clock(dev)
    before = counts()
    report: dict = {}
    t0 = time.perf_counter()
    rc = train_proc.run(ctx, device=dev, report=report)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    line = {"algorithm": ctx.model_config.train.algorithm.value,
            "device": str(dev), "seconds": time.perf_counter() - t0,
            "launches": {k: v - before[k] for k, v in counts().items()}}
    line.update(report)
    print(json.dumps(line))
    return rc


def _scoring_step(step: str, run, args) -> int:
    """Run a `posttrain` or `eval` step on `--device` (its clock starts
    once the card's context exists) and print its JSON line, with the
    rise of the scoring kernels' launch counters."""
    import time

    import torch

    from shifu_tpu_torch import resolve_device
    from shifu_tpu_torch.ops import fused_score, fused_trees
    from shifu_tpu_torch.processor.base import ProcessorContext

    def counts():
        return {"fused_score": fused_score.launches,
                "fused_trees": fused_trees.launches}

    dev = resolve_device(args.device)
    _card_clock(dev)
    before = counts()
    t0 = time.perf_counter()
    report: dict = {}
    rc = run(ProcessorContext.load(os.path.abspath(args.dir)), dev, report)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    print(json.dumps({
        "step": step, "device": str(dev), "rows": report.get("rows"),
        "seconds": time.perf_counter() - t0,
        "read_seconds": report.get("read_s", 0.0),
        "score_seconds": report.get("score_s", 0.0),
        "write_seconds": report.get("write_s", 0.0),
        "launches": {k: v - before[k] for k, v in counts().items()}}))
    return rc


def cmd_posttrain(args) -> int:
    from shifu_tpu_torch.processor import posttrain as p
    return _scoring_step(
        "posttrain", lambda ctx, dev, rep: p.run(ctx, device=dev,
                                                 report=rep), args)


def cmd_eval(args) -> int:
    """The flags' dispatch order of `shifu_tpu/cli.py`'s `cmd_eval`."""
    import time

    from shifu_tpu_torch.processor import eval as p
    from shifu_tpu_torch.processor.base import ProcessorContext
    for flag, fn in (("list", lambda ctx: p.run_list(ctx)),
                     ("new", lambda ctx: p.run_new(ctx, args.new)),
                     ("delete", lambda ctx: p.run_delete(ctx, args.delete))):
        if getattr(args, flag):
            t0 = time.perf_counter()
            rc = fn(ProcessorContext.load(os.path.abspath(args.dir)))
            _step_line(f"eval -{flag}", "host", {}, t0)
            return rc
    if args.norm:
        step, name, fn = "eval -norm", args.run, p.run_norm
    elif args.audit:
        step, name = "eval -audit", args.run

        def fn(ctx, eval_name, device, report):
            return p.run_audit(ctx, eval_name, n_records=args.n,
                               device=device, report=report)
    elif args.score is not False:
        step, name, fn = "eval -score", args.score or args.run, p.run_score
    elif args.confmat is not False:
        step, name, fn = ("eval -confmat", args.confmat or args.run,
                          p.run_confmat)
    elif args.perf is not False:
        step, name, fn = "eval -perf", args.perf or args.run, p.run_perf
    else:
        step, name, fn = "eval", args.run, p.run
    return _scoring_step(step, lambda ctx, dev, rep: fn(
        ctx, name, device=dev, report=rep), args)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="shifu_tpu_torch")
    ap.add_argument("--dir", default=".", help="model-set directory")
    sub = ap.add_subparsers(dest="command", required=True)

    def device_flag(p, what):
        p.add_argument("--device", default="cuda",
                       help=f"torch device {what} (default cuda)")

    p = sub.add_parser("new", help="create a model set")
    p.add_argument("name")
    p.set_defaults(fn=cmd_new)
    sub.add_parser("init", help="build ColumnConfig from header") \
        .set_defaults(fn=cmd_init)
    p = sub.add_parser("stats", help="column stats + binning")
    p.add_argument("-correlation", "--correlation", action="store_true",
                   help="Pearson correlation of the selected columns")
    p.add_argument("-psi", "--psi", action="store_true",
                   help="PSI over the stats#psiColumnName cohorts")
    p.add_argument("-rebin", "--rebin", action="store_true",
                   help="merge existing bins for higher-IV coarse binning")
    p.add_argument("-vars", "--vars", default=None,
                   help="comma-separated columns to rebin")
    p.add_argument("-n", type=int, default=-1,
                   help="expected max bin number after rebin")
    p.add_argument("-ivr", type=float, default=1.0,
                   help="IV keep ratio while shrinking bins")
    p.add_argument("-bic", type=int, default=0,
                   help="minimum instance count per bin")
    for flag in ("seg-merge", "base-only"):
        p.add_argument(f"-{flag}", f"--{flag}", action="store_true",
                       help="not ported yet (raises)")
    p.add_argument("-seg", type=int, default=None,
                   help="not ported yet (raises)")
    device_flag(p, "for the column math")
    p.set_defaults(fn=cmd_stats)
    for alias in ("varsel", "varselect"):
        p = sub.add_parser(alias, help="variable selection")
        p.add_argument("-r", "--recursive", type=int, default=0)
        p.add_argument("-reset", "--reset", action="store_true",
                       help="reset all variables to finalSelect=false")
        p.add_argument("-list", "--list", action="store_true",
                       help="print currently selected variables")
        p.add_argument("-f", "--file", default=None, metavar="FILE",
                       help="select exactly the variables named in FILE")
        device_flag(p, "for SE/ST/SC, V and FI")
        p.set_defaults(fn=cmd_varselect)
    p = sub.add_parser("export", help="export model/stats")
    p.add_argument("-t", "--type", default="columnstats",
                   choices=["columnstats", "correlation", "woemapping",
                            "pmml", "tf", "bagging", "baggingpmml",
                            "woe", "ume", "baggingume", "normume"])
    device_flag(p, "for -t correlation")
    p.set_defaults(fn=cmd_export)
    p = sub.add_parser("encode", help="tree-leaf-path encode the dataset")
    device_flag(p, "for the tree walk")
    p.set_defaults(fn=cmd_encode)
    p = sub.add_parser("convert", help="model spec ↔ open zip bundle")
    p.add_argument("src", help="a model spec file or a .zip bundle")
    p.add_argument("out", help="output path (.zip for bundles)")
    p.set_defaults(fn=cmd_convert)
    p = sub.add_parser("save", help="snapshot the model set")
    p.add_argument("name", nargs="?", default=None)
    p.set_defaults(fn=cmd_save)
    p = sub.add_parser("switch", help="restore a model-set snapshot")
    p.add_argument("name")
    p.set_defaults(fn=cmd_switch)
    sub.add_parser("show", help="list model-set snapshots") \
        .set_defaults(fn=cmd_show)
    p = sub.add_parser("combo", help="not ported yet (raises: the "
                                     "pipeline DAG, ROADMAP A8)")
    p.add_argument("-new", "--new", default=None, metavar="ALG1,ALG2,...")
    for flag in ("init", "run", "eval", "resume"):
        p.add_argument(f"-{flag}", f"--{flag}", action="store_true")
    p.set_defaults(fn=cmd_dag_verb)
    p = sub.add_parser("test", help="not ported yet (raises: the "
                                    "pipeline DAG, ROADMAP A8)")
    p.add_argument("-n", type=int, default=100)
    p.set_defaults(fn=cmd_dag_verb)
    for alias in ("norm", "normalize"):
        p = sub.add_parser(alias, help="normalize data")
        p.add_argument("--device", default="cuda",
                       help="torch device for the transforms (default "
                            "cuda)")
        p.set_defaults(fn=cmd_norm)
    p = sub.add_parser("posttrain", help="bin-average scores + feature "
                                         "importance")
    p.add_argument("--device", default="cuda",
                   help="torch device to score on (default cuda)")
    p.set_defaults(fn=cmd_posttrain)
    p = sub.add_parser("eval", help="evaluate models")
    p.add_argument("-run", "--run", default=None, metavar="EVAL_NAME")
    p.add_argument("-list", "--list", action="store_true",
                   help="list configured eval sets")
    p.add_argument("-new", "--new", default=None, metavar="EVAL_NAME",
                   help="create a new eval set")
    p.add_argument("-delete", "--delete", default=None,
                   metavar="EVAL_NAME", help="delete an eval set")
    p.add_argument("-score", "--score", nargs="?", const=None,
                   default=False, metavar="EVAL_NAME",
                   help="scoring only (EvalScore.csv, no metrics)")
    p.add_argument("-confmat", "--confmat", nargs="?", const=None,
                   default=False, metavar="EVAL_NAME",
                   help="confusion matrix from an existing score file")
    p.add_argument("-perf", "--perf", nargs="?", const=None,
                   default=False, metavar="EVAL_NAME",
                   help="performance curves from an existing score file")
    p.add_argument("-norm", "--norm", action="store_true",
                   help="export normalized eval data instead of scoring")
    p.add_argument("-audit", "--audit", action="store_true",
                   help="score and write an audit sample with raw "
                        "variable values (eval -audit)")
    p.add_argument("-n", "--n", type=int, default=100,
                   help="audit record count (eval -audit -n N)")
    p.add_argument("--device", default="cuda",
                   help="torch device to score on (default cuda)")
    p.set_defaults(fn=cmd_eval)
    p = sub.add_parser("serve", help="low-latency scorer service")
    p.add_argument("--port", type=int, default=None,
                   help="HTTP port (default SHIFU_TPU_SERVE_PORT; "
                        "0 = ephemeral)")
    p.add_argument("--no-http", action="store_true",
                   help="in-process service only, no listener")
    p.add_argument("--duration-s", type=float, default=0.0,
                   help="exit after this many seconds (0 = run until "
                        "SIGTERM/SIGINT)")
    p.add_argument("--device", default="cuda",
                   help="torch device to serve on (default cuda)")
    p.add_argument("--registry", default=None, metavar="DIR",
                   help="serve a model fleet from this registry root "
                        "(POST /score/<model>) instead of the model set")
    p.add_argument("--models", default=None, metavar="NAME,NAME",
                   help="fleet mode: host only these registry models "
                        "(default: every published model)")
    p.set_defaults(fn=cmd_serve)
    p = sub.add_parser("registry", help="versioned model registry: "
                                        "publish/ls/rollback/gc")
    p.add_argument("action", choices=["publish", "ls", "rollback", "gc"])
    p.add_argument("--registry", default=None, metavar="DIR",
                   help="registry root (default <workspace>/registry)")
    p.add_argument("--name", default=None,
                   help="registered model name (publish/rollback/gc)")
    p.add_argument("--models", default=None, metavar="DIR",
                   help="publish: model-spec dir (default the model "
                        "set's models/)")
    p.add_argument("--priority", default="high", choices=["high", "low"],
                   help="publish: admission class for fleet serving")
    p.add_argument("--max-delay-ms", type=float, default=None,
                   help="publish: pin this model's micro-batch "
                        "admission deadline")
    p.add_argument("--to", default=None, metavar="vNNN",
                   help="rollback: target version (default: the one "
                        "before HEAD)")
    p.add_argument("--keep", type=int, default=None,
                   help="gc: versions to keep (default "
                        "SHIFU_TPU_REGISTRY_KEEP)")
    p.set_defaults(fn=cmd_registry)
    p = sub.add_parser("watch", help="model health monitor (rolling "
                                     "drift + SLO guardrails)")
    p.add_argument("--monitor-only", action="store_true",
                   help="drift/SLO monitoring without the retrain loop "
                        "(the loop raises: ROADMAP A7.4)")
    p.add_argument("--registry", default=None,
                   help="full mode only (raises: ROADMAP A7.4)")
    p.add_argument("--model-name", default=None,
                   help="full mode only (raises: ROADMAP A7.4)")
    p.add_argument("--eval-set", default=None,
                   help="full mode only (raises: ROADMAP A7.4)")
    p.add_argument("--interval-s", type=float, default=None,
                   help="tick period (default SHIFU_TPU_WATCH_INTERVAL_S)")
    p.add_argument("--iterations", type=int, default=0,
                   help="stop after N ticks (0 = run until "
                        "SIGTERM/SIGINT)")
    p.add_argument("--ingest", default=None, metavar="LOG",
                   help="durable row log (raises: ROADMAP A7.4)")
    p.add_argument("--device", default="cuda",
                   help="torch device the windows are binned on "
                        "(default cuda)")
    p.set_defaults(fn=cmd_watch)
    p = sub.add_parser("health", help="SLO health over the metrics store: "
                                      "status, trends, recent breaches")
    p.add_argument("--trend", type=int, default=30,
                   help="points per sparkline trend")
    p.set_defaults(fn=cmd_health)
    p = sub.add_parser("train", help="train the model set's algorithm")
    p.add_argument("--device", default="cuda",
                   help="torch device to train on (default cuda)")
    p.set_defaults(fn=cmd_train)
    p = sub.add_parser("knobs", help="list every SHIFU_TPU_* knob (type/"
                                     "default/current/doc)")
    p.add_argument("--all", action="store_true",
                   help="every knob (the port's knobs are all shown)")
    p.add_argument("--markdown", action="store_true",
                   help="emit the table as markdown")
    p.set_defaults(fn=cmd_knobs)
    sub.add_parser("version").set_defaults(fn=cmd_version)
    return ap


def main(argv: Optional[List[str]] = None) -> int:
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(levelname)s %(message)s")
    args = build_parser().parse_args(argv)
    return args.fn(args)
