"""Command line of the port — the 26 verbs of `shifu_tpu/cli.py`.

    python -m shifu_tpu_torch [--profile] --dir <dir> <verb> ...

    python -m shifu_tpu_torch --dir <dir> new <name>
    python -m shifu_tpu_torch --dir <model-set> init
    python -m shifu_tpu_torch --dir <model-set> stats [--device cuda|cpu]
        [-correlation | -psi | -rebin [-vars a,b] [-n N] [-ivr R]
         [-bic C] | -base-only | -seg K | -seg-merge]
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
    python -m shifu_tpu_torch --dir <model-set> combo -new ALG1,ALG2,ALG3
        | -init | -run [-resume] | -eval  [--device cuda|cpu]
    python -m shifu_tpu_torch --dir <model-set> test [-n N]
    python -m shifu_tpu_torch --dir <model-set> save [NAME] | switch NAME
        | show
    python -m shifu_tpu_torch --dir <model-set> serve [--port P]
        [--no-http] [--duration-s S] [--device cuda|cpu]
        [--registry DIR [--models NAME,NAME]]
    python -m shifu_tpu_torch --dir <workspace> registry
        publish|ls|rollback|gc [--registry DIR] [--name NAME]
        [--models DIR] [--priority high|low] [--max-delay-ms MS]
        [--to vNNN] [--keep K]
    python -m shifu_tpu_torch --dir <model-set> watch [--monitor-only]
        [--registry DIR --model-name NAME] [--eval-set NAME]
        [--ingest LOG] [--interval-s S] [--iterations N]
        [--device cuda|cpu]
    python -m shifu_tpu_torch ingest ls --log DIR
    python -m shifu_tpu_torch --dir <model-set> health [--trend N]
    python -m shifu_tpu_torch --dir <model-set> ckpt
    python -m shifu_tpu_torch --dir <model-set> top [--watch]
        [--interval S]
    python -m shifu_tpu_torch --dir <model-set> trace ls
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
past SHIFU_TPU_ANALYSIS_CHUNK_ROWS. `stats -base-only`, `-seg K` and
`-seg-merge` are the pipeline DAG's per-segment siblings: the base
columns, segment expression K's partial under `tmp/stats_seg/`, and
the merge into ColumnConfig.json (host only), equal to the inline
`stats` byte for byte.

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
`-t tf` writes a TensorFlow SavedModel of the first NN/LR spec to
``tfmodel/`` on the host (it needs tensorflow). `encode` writes the tree-leaf encoding of
the training set (`encoded/`) on `--device`; `convert` turns a model
spec into an open zip bundle and back; `save`, `switch` and `show` keep
versions of the model set under `.shifu-versions/`. `combo` and `test`
run through the pipeline DAG (`pipeline/scheduler.run_dag`): `combo
-new` writes ComboTrain.json (three algorithms or more, the last the
assemble model), `-init` scaffolds the sub-model workspaces, `-run
[-resume]` trains the sub-models as sibling processes on `--device`
(`-resume` parks trained ones as cached) and then the assemble model
over their scores, `-eval` writes `evals/<name>_combo/`; `test -n N`
checks the config, the filters over N sampled rows of the training and
eval sets and the pipeline's DAG as host-only nodes. `combo -run` and
`test` print the DAG's report as the `dag` key of their JSON line.

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
only). `watch` tails the training dataPath (or, with `--ingest LOG`,
consumes the durable row log exactly once), bins each new window on
`--device` against the frozen training bins (rolling PSI/KS), evaluates
the SLO guardrails and writes everything to the metrics store; without
`--monitor-only` a breach schedules the refresh controller's warm-start
retrain, guardrail, promotion into `--registry`/`--model-name` and swap,
all on `--device`, after `CanaryController.recover` has resolved a
canary run a crash interrupted. `ingest ls` prints a row log's
partitions, segments and per-consumer offsets and lag (host only).
`health` prints each SLO's state with a sparkline of its metric, the
canary arms' lines and the recent events (breaches, refresh, canary and
fleet-drift), and exits 1 on a breach. `train` trains the
model set's algorithm — GBT/RF/DT from `tmp/CleanedData` into
``models/model<bag>.{gbt,rf}``, NN/LR/SVM/TENSORFLOW, WDL and MTL from
`tmp/NormalizedData` into ``models/model<bag>.{nn,lr,wdl,mtl}``; with
`train#trainOnDisk` from the `.npy` layout `norm` wrote, a chunk at a
time — and prints one JSON line: the algorithm, the device, the wall
seconds and the launches of each tree-training kernel during the run;
for the dense families also the training rows, the bags, the epochs,
the trainer's seconds and each saved model's best validation error,
best epoch and per-epoch train and validation errors; its clock starts
once the card's context exists. With `CheckpointInterval` > 0 the NN/LR,
WDL and MTL trainers checkpoint their state; a preempted `train`
(SIGTERM, or a ``preempt`` fault) saves and exits with rc 75
(`resilience.PREEMPT_RC`), and a rerun resumes at the saved epoch;
``SHIFU_TPU_MAX_RESTARTS`` restarts it in process. Every step writes
its completion manifest under `tmp/manifests/`, and with
``SHIFU_TPU_RESUME=1`` a step whose manifest matches its inputs is
skipped. `ckpt` prints the checkpoint inventory (the latest step of
each bag's directory and its sharding sidecar) as the JAX package's
verb does, without touching the card.
`--device` defaults to the card and raises when there is none.

Every command appends one record to `tmp/metrics/steps.jsonl`
(`profiling.step_metrics`: the step, rc, wall seconds, the card's
memory when the step used it, the stage timers, retries, the `roofline`
or `dag` block a layer queued). With SHIFU_TPU_TRACE=1 the command runs
inside a trace run (`obs/trace.trace_run`): its spans are merged into
`tmp/trace/<run_id>.trace.json` and summarized in the record's `trace`
block. `--profile` adds a `torch.profiler` trace under
`tmp/profile/<run_id>/`. `top` prints the last step records with their
trace summaries, the trace runs still in flight and the health plane's
recent events (`--watch` redraws every `--interval` seconds); `trace
ls` pairs each run's merged span trace with its profile.
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


def cmd_ingest(args) -> int:
    """`ingest ls`: a JSON inventory of one row log — partitions with
    sealed/open segment counts, sealed rows, and every consumer's
    committed offset and lag in rows. Host only."""
    from shifu_tpu_torch.data.ingest import RowLog
    if args.action == "ls":
        print(json.dumps(RowLog(args.log).inventory(), indent=1))
        return 0
    raise SystemExit(f"ingest: unknown action {args.action!r}")


def cmd_watch(args) -> int:
    """`watch`: rolling drift over the arriving data (the dataPath tail,
    or `--ingest LOG`) and the SLO guardrails, into the metrics store.
    Without `--monitor-only` every breach schedules the refresh
    controller (warm-start retrain, guardrail, promotion into
    `--registry`/`--model-name`, in-place swap) on `--device`."""
    from shifu_tpu_torch import resolve_device
    from shifu_tpu_torch.obs.health import watch as watch_mod
    from shifu_tpu_torch.processor.base import ProcessorContext
    device = resolve_device(args.device)
    ctx = ProcessorContext.load(os.path.abspath(args.dir))
    ingest_log = None
    if args.ingest:
        from shifu_tpu_torch.data.ingest import RowLog
        ingest_log = RowLog(args.ingest)
    refresh = None
    if not args.monitor_only:
        from shifu_tpu_torch.obs.health.refresh import RefreshController
        refresh = RefreshController(
            ctx, registry_root=args.registry, model_name=args.model_name,
            eval_name=args.eval_set, ingest_log=ingest_log, device=device)
    if args.registry and args.model_name:
        # a canary run a SIGKILL interrupted left its state file in a
        # non-terminal phase — roll it back to the recorded baseline
        # before this watch can breach into a new refresh
        from shifu_tpu_torch.obs.health.canary import CanaryController
        CanaryController.recover(args.registry, args.model_name,
                                 store_root=ctx.path_finder.root)
    return watch_mod.run_monitor(
        ctx, interval_s=args.interval_s,
        iterations=args.iterations if args.iterations > 0 else None,
        refresh=refresh, ingest_log=ingest_log, device=device)


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


def _top_render(root: str) -> str:
    """One frame of `top`: the last steps.jsonl records (step, rc, wall,
    trace block when present) plus any live span files from a trace
    run still in flight, and the health plane's canary arms and recent
    events."""
    import glob as _glob
    import time

    from shifu_tpu_torch.resilience import absorbed
    lines = []
    steps_path = os.path.join(root, "tmp", "metrics", "steps.jsonl")
    recs = []
    try:
        with open(steps_path, encoding="utf-8") as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    recs.append(json.loads(line))
                except ValueError:
                    continue
    except OSError as e:
        absorbed("cli.steps-read", e)
    recs = recs[-10:]
    if not recs:
        lines.append(f"no step records yet ({steps_path})")
    else:
        lines.append(f"{'step':<12} {'rc':>3} {'wall_s':>9} "
                     f"{'spans':>6} {'drop':>5}  top self-time")
        for rec in recs:
            tr = rec.get("trace") or {}
            top = ", ".join(
                f"{t['name']}={t['self_s']:.3f}s"
                for t in tr.get("top_self", [])) or "-"
            lines.append(
                f"{str(rec.get('step', '?')):<12} "
                f"{str(rec.get('rc', '-')):>3} "
                f"{float(rec.get('wallSeconds', 0.0)):>9.2f} "
                f"{str(tr.get('span_count', '-')):>6} "
                f"{str(tr.get('dropped_spans', '-')):>5}  {top}")
    live = []
    for d in sorted(_glob.glob(os.path.join(root, "tmp", "trace", "*"))):
        if not os.path.isdir(d):
            continue
        rid = os.path.basename(d)
        merged = os.path.join(root, "tmp", "trace", rid + ".trace.json")
        if os.path.exists(merged):
            continue   # finished run, already merged
        n = len(_glob.glob(os.path.join(d, "spans.*.jsonl")))
        live.append(f"  {rid}: {n} span file(s), not yet merged")
    if live:
        lines.append("live trace runs:")
        lines.extend(live)
    # the health plane's tail (absorbed — a corrupt store must not
    # break the monitor)
    try:
        from shifu_tpu_torch.obs.health import store as health_store
        st = health_store.store(root)
        lines.extend(_canary_lines(st))
        events = st.events(
            limit=5, names=["drift", "breach", "warn", "recovered",
                            "refresh", "canary", "fleet_drift"])
        if events:
            lines.append("health/drift events:")
            for ev in events:
                tags = ev.get("tags") or {}
                ts = time.strftime("%H:%M:%S",
                                   time.localtime(ev.get("ts", 0)))
                detail = " ".join(f"{k}={v}"
                                  for k, v in sorted(tags.items()))
                lines.append(f"  {ts}  {ev.get('name', '?'):<16} {detail}")
    except Exception as e:  # noqa: BLE001 — monitoring must not fail top
        absorbed("cli.status-events", e)
    return "\n".join(lines)


def cmd_top(args) -> int:
    """Step and trace monitor over steps.jsonl and the trace workspace.
    Single shot by default; --watch redraws every --interval seconds
    until interrupted."""
    import sys
    import time
    root = args.dir
    if not args.watch:
        print(_top_render(root))
        return 0
    try:
        while True:
            # ANSI clear + home, as top(1) does
            sys.stdout.write("\x1b[2J\x1b[H")
            print(time.strftime("%H:%M:%S"), "shifu top —", root)
            print(_top_render(root))
            sys.stdout.flush()
            time.sleep(args.interval)
    except KeyboardInterrupt:
        pass
    return 0


def cmd_trace(args) -> int:
    """`trace ls`: pair merged span traces (tmp/trace/) with profiler
    traces (tmp/profile/) by their shared run id."""
    from shifu_tpu_torch.obs import trace as obs_trace
    if args.action != "ls":
        raise SystemExit(f"trace: unknown action {args.action!r}")
    rows = obs_trace.trace_ls(args.dir)
    if not rows:
        print("no trace artifacts under tmp/trace or tmp/profile")
        return 0
    rid_w = max(len(r["run_id"]) for r in rows)
    print(f"{'run_id':<{rid_w}}  {'spans':>5}  trace / profile")
    for r in rows:
        paths = [p for p in (r["trace"], r["profile"]) if p]
        print(f"{r['run_id']:<{rid_w}}  {r['span_files']:>5}  "
              + (" + ".join(paths) or "-"))
    return 0


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


def cmd_stats(args) -> int:
    from shifu_tpu_torch.processor import correlation, psi
    from shifu_tpu_torch.processor import stats as stats_proc
    if args.correlation:
        return _device_step("stats -correlation", correlation.run, args)
    if args.psi:
        return _device_step("stats -psi", psi.run, args)
    if args.rebin:
        return _host_step("stats -rebin", lambda ctx, _: stats_proc.run_rebin(
            ctx, request_vars=args.vars, expect_bin_num=args.n,
            iv_keep_ratio=args.ivr, min_inst_cnt=args.bic), args)
    if args.seg is not None:
        return _device_step(f"stats -seg {args.seg}", lambda ctx, **kw:
                            stats_proc.run_segment(ctx, args.seg, **kw),
                            args)
    if args.seg_merge:
        return _host_step("stats -seg-merge", lambda ctx, _:
                          stats_proc.run_segment_merge(ctx), args)
    if args.base_only:
        return _device_step("stats -base-only", lambda ctx, **kw:
                            stats_proc.run(ctx, base_only=True, **kw), args)
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


def cmd_test(args) -> int:
    """Dry-run the model set through the pipeline DAG
    (ShifuTestProcessor): the config check, the training data's filter
    over `-n` sampled rows, one node an eval set and the pipeline's DAG
    validated without running it, as host-only nodes, then the I/O
    retries of the run. The JSON line carries the DAG's report
    (``dag``)."""
    import time

    from shifu_tpu_torch.data.purifier import DataPurifier
    from shifu_tpu_torch.data.reader import read_raw_table
    from shifu_tpu_torch.pipeline.nodes import STEP_REGISTRY, pipeline_nodes
    from shifu_tpu_torch.pipeline.scheduler import Node, _validate, run_dag
    from shifu_tpu_torch.processor.base import ProcessorContext
    from shifu_tpu_torch.resilience import retry_stats
    t0 = time.perf_counter()
    ctx = ProcessorContext.load(os.path.abspath(args.dir))
    mc = ctx.model_config
    root = ctx.path_finder.root

    def check_filter():
        df = read_raw_table(mc, max_rows=args.n)
        keep = DataPurifier(mc.dataSet.filterExpressions).apply(df)
        log.info("filter %r keeps %d / %d sampled records",
                 mc.dataSet.filterExpressions, int(keep.sum()), len(df))

    def check_eval(ec):
        def fn():
            df = read_raw_table(mc, ds=ec.dataSet, max_rows=args.n)
            keep = DataPurifier(ec.dataSet.filterExpressions).apply(df)
            log.info("eval %s: filter %r keeps %d / %d sampled records",
                     ec.name, ec.dataSet.filterExpressions,
                     int(keep.sum()), len(df))
        return fn

    def check_plan():
        # the model set's pipeline, validated (unique names, known deps,
        # acyclic) without running anything
        plan = pipeline_nodes(root, eval_sets=[e.name for e in mc.evals])
        _validate(plan)
        log.info("pipeline DAG: %d nodes over %d registered steps "
                 "validate clean", len(plan), len(STEP_REGISTRY))

    def check_config():
        log.info("config: model set %s, algorithm %s, %d eval set(s)",
                 mc.model_set_name, mc.train.algorithm.value,
                 len(mc.evals))

    nodes = [Node("test.config", check_config, (), device=False)]
    nodes.append(Node("test.filter", check_filter, ("test.config",),
                      device=False))
    for ec in mc.evals:
        nodes.append(Node(f"test.eval.{ec.name}", check_eval(ec),
                          ("test.config",), device=False))
    nodes.append(Node("test.plan", check_plan, ("test.config",),
                      device=False))
    report = {"dag": run_dag(nodes, root=root, label="test")}
    retries = retry_stats()
    if retries:
        for site, d in sorted(retries.items()):
            log.warning("resilience: %s retried %d time(s), last error: "
                        "%s", site, d["attempts"], d["lastError"])
    else:
        log.info("resilience: no I/O retries")
    _step_line("test", "host", report, t0, rc=0)
    return 0


def cmd_combo(args) -> int:
    """`combo -new`, `-init` (host), `-run [-resume]` and `-eval` (on
    `--device`, their line with the scoring and tree kernels' launches
    in this process; `-run`'s with the DAG's report)."""
    import time

    import torch

    from shifu_tpu_torch import resolve_device
    from shifu_tpu_torch.ops import fused_score, fused_trees
    from shifu_tpu_torch.processor import combo as p
    from shifu_tpu_torch.processor.base import ProcessorContext
    if args.new:
        return _host_step("combo -new",
                          lambda ctx, _: p.new(ctx, args.new), args)
    if args.init:
        return _host_step("combo -init", lambda ctx, _: p.init(ctx), args)
    if not (args.run or args.eval):
        raise SystemExit("combo: pass one of -new ALGS / -init / -run / "
                         "-eval")

    def counts():
        return {"fused_score": fused_score.launches,
                "fused_trees": fused_trees.launches,
                **_tree_kernel_counts()}

    dev = resolve_device(args.device)
    _card_clock(dev)
    before = counts()
    t0 = time.perf_counter()
    report: dict = {}
    ctx = ProcessorContext.load(os.path.abspath(args.dir))
    if args.run:
        step = "combo -run"
        rc = p.run(ctx, resume=args.resume, device=dev, report=report)
    else:
        step = "combo -eval"
        rc = p.evaluate(ctx, device=dev, report=report)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    _step_line(step, str(dev), report, t0, rc=rc, launches={
        k: v - before[k] for k, v in counts().items()})
    return rc


def cmd_ckpt(args) -> int:
    """Checkpoint inventory: one JSON record a bag with its latest
    restorable step and the sharding sidecar's provenance (the mesh
    that wrote it, its rules, how many leaves were sharded). Host
    only."""
    from shifu_tpu_torch.processor.base import ProcessorContext
    from shifu_tpu_torch.train import checkpoint as ckpt_mod
    ctx = ProcessorContext.load(args.dir, need_columns=False)
    n_bags = max(ctx.model_config.train.baggingNum, 1)
    records = []
    for bag in range(n_bags):
        d = ctx.path_finder.checkpoint_path(bag)
        step = ckpt_mod.latest_step(d)
        if step is None:
            continue
        rec = {"bag": bag, "dir": d, "latestStep": step}
        meta = ckpt_mod.load_sharding_meta(d, step)
        if meta is None:
            rec["sharding"] = None   # restores onto the caller's placement
        else:
            rec["sharding"] = {
                "mesh": meta.get("mesh"),
                "rules": meta.get("rules"),
                "shardedLeaves": sum(1 for v in meta.get("leaves",
                                                         {}).values() if v),
                "deviceLeaves": len(meta.get("leaves", {}))}
        records.append(rec)
    print(json.dumps({"checkpoints": records}, indent=1))
    return 0


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
    ap.add_argument("--profile", action="store_true",
                    help="capture a torch.profiler trace for this command "
                         "under tmp/profile/<run_id>/ (open in "
                         "ui.perfetto.dev)")
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
    p.add_argument("-seg", type=int, default=None,
                   help="compute stats for ONE segment expression "
                        "(1-based index) into a tmp partial — a DAG "
                        "sibling of the base stats step")
    p.add_argument("-seg-merge", "--seg-merge", action="store_true",
                   help="merge base + per-segment partials into "
                        "ColumnConfig.json")
    p.add_argument("-base-only", "--base-only", action="store_true",
                   help="skip segment expansion (the DAG runs segments "
                        "as sibling -seg steps)")
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
    p = sub.add_parser("combo", help="assembled multi-algorithm models")
    p.add_argument("-new", "--new", default=None, metavar="ALG1,ALG2,...",
                   help="create ComboTrain.json (last alg = assemble "
                        "model)")
    p.add_argument("-init", "--init", action="store_true",
                   help="scaffold sub-model workspaces")
    p.add_argument("-run", "--run", action="store_true",
                   help="train sub-models + assemble model")
    p.add_argument("-eval", "--eval", action="store_true",
                   help="evaluate the assembled model")
    p.add_argument("-resume", "--resume", action="store_true",
                   help="skip already-trained sub-models")
    device_flag(p, "for -run and -eval")
    p.set_defaults(fn=cmd_combo)
    p = sub.add_parser("test", help="dry-run filter expressions")
    p.add_argument("-n", type=int, default=100)
    p.set_defaults(fn=cmd_test)
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
                                     "drift + SLO guardrails) and the "
                                     "drift-triggered retrain loop")
    p.add_argument("--monitor-only", action="store_true",
                   help="drift/SLO monitoring without the drift-triggered "
                        "retrain loop")
    p.add_argument("--registry", default=None,
                   help="registry root to promote refreshed models into "
                        "(with --model-name)")
    p.add_argument("--model-name", default=None,
                   help="registry model name bound to this model set")
    p.add_argument("--eval-set", default=None,
                   help="eval set for the refresh guardrail (default: "
                        "first configured)")
    p.add_argument("--interval-s", type=float, default=None,
                   help="tick period (default SHIFU_TPU_WATCH_INTERVAL_S)")
    p.add_argument("--iterations", type=int, default=0,
                   help="stop after N ticks (0 = run until "
                        "SIGTERM/SIGINT)")
    p.add_argument("--ingest", default=None, metavar="LOG",
                   help="consume drift windows from this durable row log "
                        "(data/ingest.py) with exactly-once offset "
                        "commits instead of the dataPath tail")
    p.add_argument("--device", default="cuda",
                   help="torch device the windows are binned and the "
                        "challenger trained and scored on (default cuda)")
    p.set_defaults(fn=cmd_watch)
    p = sub.add_parser("ingest", help="streaming row-log tooling: `ingest "
                                      "ls` prints partitions, segments "
                                      "and per-consumer offsets/lag as "
                                      "JSON")
    p.add_argument("action", choices=["ls"])
    p.add_argument("--log", required=True, metavar="DIR",
                   help="row-log root (a local path)")
    p.set_defaults(fn=cmd_ingest)
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
    p = sub.add_parser("top",
                       help="live step/trace monitor (steps.jsonl + "
                            "in-flight span files)")
    p.add_argument("--watch", action="store_true",
                   help="redraw continuously until interrupted")
    p.add_argument("--interval", type=float, default=2.0,
                   help="redraw period in seconds (with --watch)")
    p.set_defaults(fn=cmd_top)
    p = sub.add_parser("trace",
                       help="trace artifacts: `trace ls` pairs span "
                            "traces with profiler traces by run_id")
    p.add_argument("action", choices=["ls"])
    p.set_defaults(fn=cmd_trace)
    sub.add_parser("ckpt",
                   help="checkpoint inventory: latest step + the mesh "
                        "topology that wrote it (sharding sidecar)") \
        .set_defaults(fn=cmd_ckpt)
    sub.add_parser("version").set_defaults(fn=cmd_version)
    return ap


def main(argv: Optional[List[str]] = None) -> int:
    from shifu_tpu_torch import resilience
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(levelname)s %(message)s")
    args = build_parser().parse_args(argv)
    from shifu_tpu_torch.obs.trace import trace_run
    from shifu_tpu_torch.profiling import maybe_profile, step_metrics
    root = getattr(args, "dir", ".") or "."
    try:
        # every command writes one steps.jsonl record; trace_run sits
        # inside step_metrics (its exit attaches the span summary to the
        # record before the record is written) and outside maybe_profile
        # (so the profile is named after the live trace run's id)
        with step_metrics(root, args.command) as rec, \
                trace_run(root, args.command), \
                maybe_profile(root, args.command, args.profile):
            rc = args.fn(args)
            rec["rc"] = int(rc or 0)
        return rc
    except resilience.Preempted as e:
        # a checkpointed preemption: the distinct rc tells a supervisor
        # (systemd, a shell loop, k8s) to rerun with SHIFU_TPU_RESUME=1
        log.warning("preempted: %s — exiting rc=%d; rerun with "
                    "SHIFU_TPU_RESUME=1 to resume", e,
                    resilience.PREEMPT_RC)
        return resilience.PREEMPT_RC
