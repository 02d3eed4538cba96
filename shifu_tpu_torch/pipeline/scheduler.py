"""Card-leasing DAG scheduler over pipeline nodes — the port of
`shifu_tpu/pipeline/scheduler.py`.

The calling thread is the dispatcher; every node that becomes ready
(all its dependencies done) is handed to a fresh worker thread, subject
to admission control. On a host with more than one card the admission
unit is a **lease**: each ``device=True`` node declares a demand
(``devices=k``, default "all"), the allocator leases it a disjoint set
of pool indices (first fit over the smallest free indices, the largest
demands dispatched first) and exports the lease into the node's
subprocess as ``CUDA_VISIBLE_DEVICES`` narrowed to those cards — so
concurrent trainers run on different cards
at once. A node whose demand cannot be met yet waits for leases to
return; a demand larger than the pool raises up front (a lease never
shrinks silently). On one card (or with ``SHIFU_TPU_DAG_SLICE=0``) the
device nodes share ``SHIFU_TPU_DAG_WORKERS`` admission slots on it
instead. Host-only nodes (posttrain, config checks) are admitted at
once either way and never queue behind a trainer. The card inventory is
``SHIFU_TPU_DAG_DEVICES`` when set, else ``torch.cuda.device_count()``,
read only for a DAG that holds a device node.

Node bodies are usually CLI subprocesses (`pipeline.nodes`): one
process a step keeps the process-wide state (abort scope, kernel launch
counters, fault counters) as isolated as a sequential run keeps it.

Failure: the FIRST failing node publishes an abort marker
(`resilience.publish_abort("dag.<node>")`); the failure poisons only
the node's descendants, every independent branch still runs to the end,
and `DagError` is raised at the end naming the first failure with the
per-node report.

Resume: a node's ``done_check`` (usually
`processor.base.manifest_complete`) is evaluated at dispatch time,
after its dependencies finished, so the inputs' fingerprint it hashes
is the one a sequential resume would see; a complete manifest parks the
node as ``cached`` without running it.

`run_dag` returns the report (`DAG_SUMMARY_FIELDS`, a record of
`DAG_FIELDS` a node); the CLI prints it as the ``dag`` key of a step
line, and it is queued as the ``dag`` block of the step's
``steps.jsonl`` record (`profiling.set_step_extra`). Under a trace run
every node that started leaves a ``dag.node`` span (parent: the calling
thread's open span, the run root for a CLI verb) with ``dag.queue``
(ready → dispatch) and ``dag.run`` (dispatch → done) children, cut from
the same timestamps as the report; the node processes inherit
``SHIFU_TPU_TRACE_DIR`` and add their own span files to the merge.
"""

from __future__ import annotations

import inspect
import logging
import os
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Set, Tuple

from shifu_tpu_torch import profiling, resilience
from shifu_tpu_torch.config.environment import knob_int, knob_str
from shifu_tpu_torch.obs import trace as obs_trace
from shifu_tpu_torch.profiling import DAG_FIELDS, DAG_SUMMARY_FIELDS
from shifu_tpu_torch.resilience import fault_point

log = logging.getLogger("shifu_tpu_torch")

# terminal node states, as they appear in the report's node records
DONE, CACHED, FAILED, POISONED = "done", "cached", "failed", "poisoned"


class DagError(RuntimeError):
    """The first node failure, raised after every independent branch
    has had its chance to run; carries the per-node report."""

    def __init__(self, message: str, report: Dict):
        super().__init__(message)
        self.report = report


@dataclass
class Node:
    """One schedulable unit: a callable and its dependency edges.

    ``device=True`` nodes contend for leases (timeshared: the
    SHIFU_TPU_DAG_WORKERS slots); host-only nodes bypass both.
    ``devices`` is the node's demand in cards (None = the whole pool).
    ``done_check`` is the RESUME test (True → ``cached``), evaluated
    only once the dependencies completed. A ``fn`` that accepts a
    ``lease_env`` keyword receives the lease's environment to merge
    into its subprocess."""

    name: str
    fn: Callable[..., None]
    deps: Tuple[str, ...] = ()
    device: bool = True
    done_check: Optional[Callable[[], bool]] = None
    devices: Optional[int] = None


def _validate(nodes: Sequence[Node]):
    by: Dict[str, Node] = {}
    for n in nodes:
        if n.name in by:
            raise ValueError(f"duplicate DAG node {n.name!r}")
        by[n.name] = n
    children: Dict[str, List[str]] = {n.name: [] for n in nodes}
    for n in nodes:
        for d in n.deps:
            if d not in by:
                raise ValueError(
                    f"DAG node {n.name!r} depends on unknown node {d!r}")
            children[d].append(n.name)
    # Kahn's algorithm: whatever keeps an in-degree is on a cycle
    indeg = {n.name: len(n.deps) for n in nodes}
    frontier = [k for k, v in indeg.items() if v == 0]
    seen = 0
    while frontier:
        k = frontier.pop()
        seen += 1
        for c in children[k]:
            indeg[c] -= 1
            if indeg[c] == 0:
                frontier.append(c)
    if seen != len(by):
        cyc = sorted(k for k, v in indeg.items() if v > 0)
        raise ValueError(f"DAG has a cycle through {cyc}")
    return by, children


def _descendants(name: str, children: Dict[str, List[str]]) -> set:
    out, stack = set(), [name]
    while stack:
        for c in children[stack.pop()]:
            if c not in out:
                out.add(c)
                stack.append(c)
    return out


def _critical_path(order, by, run_s) -> Tuple[List[str], float]:
    """The longest run_s chain through the dependency edges (queue time
    excluded: what an unlimited scheduler could not go below)."""
    cp: Dict[str, float] = {}
    back: Dict[str, Optional[str]] = {}
    for name in order:                       # topological order
        best, arg = 0.0, None
        for d in by[name].deps:
            if cp.get(d, 0.0) > best:
                best, arg = cp[d], d
        cp[name] = best + run_s.get(name, 0.0)
        back[name] = arg
    if not cp:
        return [], 0.0
    tail = max(cp, key=lambda k: cp[k])
    chain: List[str] = []
    cur: Optional[str] = tail
    while cur is not None:
        chain.append(cur)
        cur = back[cur]
    return chain, cp[tail]


@dataclass
class _RunState:
    state: Dict[str, str] = field(default_factory=dict)
    ready_t: Dict[str, float] = field(default_factory=dict)
    start_t: Dict[str, float] = field(default_factory=dict)
    end_t: Dict[str, float] = field(default_factory=dict)
    errors: Dict[str, BaseException] = field(default_factory=dict)
    device_running: int = 0
    max_concurrent: int = 0
    free: Set[int] = field(default_factory=set)      # sliced mode pool
    leases: Dict[str, Tuple[int, ...]] = field(default_factory=dict)
    lease_size: Dict[str, int] = field(default_factory=dict)
    first_failure: Optional[Tuple[str, BaseException]] = None


def _card_count() -> int:
    import torch
    return int(torch.cuda.device_count())


def _resolve_slicing(nodes: Sequence[Node]) -> Tuple[bool, Optional[int]]:
    """(sliced?, pool size). SHIFU_TPU_DAG_SLICE auto → slice when the
    pool holds more than one card; 1 → slice (an inventory is needed);
    0 → timeshared. Only a DAG with a device node reads the
    inventory."""
    mode = (knob_str("SHIFU_TPU_DAG_SLICE") or "auto").strip().lower()
    if mode not in ("auto", "0", "1"):
        raise ValueError(
            f"SHIFU_TPU_DAG_SLICE={mode!r}: want auto, 1 or 0")
    if mode == "0" or not any(n.device for n in nodes):
        return False, None
    total = knob_int("SHIFU_TPU_DAG_DEVICES") or _card_count()
    if not total:
        if mode == "1":
            raise RuntimeError(
                "SHIFU_TPU_DAG_SLICE=1 but torch sees no card — set "
                "SHIFU_TPU_DAG_DEVICES")
        return False, None
    total = int(total)
    if mode == "1":
        return True, max(total, 1)
    return (True, total) if total > 1 else (False, None)


def _effective_demand(node: Node, total: int) -> int:
    """A device node's demand in cards: its ``devices`` (None = the
    whole pool)."""
    if not node.device:
        return 0
    return max(int(node.devices if node.devices is not None else total), 1)


def _lease_env(lease: Tuple[int, ...]) -> Dict[str, str]:
    """The environment of a leased node's subprocess:
    CUDA_VISIBLE_DEVICES narrowed to the lease's pool indices (through
    the parent's own CUDA_VISIBLE_DEVICES when that is set, so the
    indices name the cards the parent sees)."""
    seen = [v.strip() for v in
            os.environ.get("CUDA_VISIBLE_DEVICES", "").split(",")
            if v.strip()]
    return {"CUDA_VISIBLE_DEVICES": ",".join(
        seen[i] if seen and i < len(seen) else str(i) for i in lease)}


def _call_node(node: Node, lease_env: Optional[Dict[str, str]]) -> None:
    """Call the node's body, with the lease's environment when it takes
    a ``lease_env`` keyword (an in-process body runs on the parent's
    own cards)."""
    if lease_env:
        try:
            params = inspect.signature(node.fn).parameters.values()
            takes = any(p.name == "lease_env"
                        or p.kind is inspect.Parameter.VAR_KEYWORD
                        for p in params)
        except (TypeError, ValueError):
            takes = False
        if takes:
            node.fn(lease_env=lease_env)
            return
        log.debug("dag: node %s takes no lease_env — its body runs on "
                  "the parent's cards", node.name)
    node.fn()


def run_dag(nodes: Sequence[Node], workers: Optional[int] = None,
            root: Optional[str] = None, label: str = "dag") -> Dict:
    """Run `nodes` along their dependency edges and return the report.
    Raises `DagError` at the end if a node failed; every branch not
    downstream of a failure still ran. `root` (the model set) puts the
    abort marker under ``<root>/tmp``."""
    nodes = list(nodes)
    by, children = _validate(nodes)
    order = [n.name for n in nodes]
    if workers is None:
        workers = max(knob_int("SHIFU_TPU_DAG_WORKERS"), 1)
    sliced, total = _resolve_slicing(nodes)
    eff: Dict[str, int] = {}
    if sliced:
        eff = {n.name: _effective_demand(n, total) for n in nodes}
        for n in nodes:
            if n.device and eff[n.name] > total:
                raise ValueError(
                    f"DAG node {n.name!r} demands {eff[n.name]} "
                    f"device(s) but the pool holds {total} — a demand "
                    "that can never be met would wait forever, and a "
                    "lease never shrinks silently (lower devices=)")
    # the largest demands first-fit before small ones fragment the pool
    # (stable: equal demands keep their order, timeshared mode all of it)
    dispatch = sorted(order, key=lambda k: -eff.get(k, 0)) if sliced \
        else order
    if root:
        resilience.set_abort_scope(os.path.join(root, "tmp"))
        resilience.clear_abort()

    rs = _RunState()
    if sliced:
        rs.free = set(range(total))
    dep_left = {n.name: len(n.deps) for n in nodes}
    t0 = time.monotonic()
    for n in nodes:
        rs.state[n.name] = "pending"
        if not n.deps:
            rs.ready_t[n.name] = t0
    cv = threading.Condition()

    def _mark_ready(name: str, now: float) -> None:
        for c in children[name]:
            dep_left[c] -= 1
            if dep_left[c] == 0:
                rs.ready_t[c] = now

    def _fail(name: str, err: BaseException) -> None:
        rs.state[name] = FAILED
        rs.errors[name] = err
        if rs.first_failure is None:
            rs.first_failure = (name, err)
            resilience.publish_abort(f"dag.{name}", err)
        for d in _descendants(name, children):
            if rs.state[d] == "pending":
                rs.state[d] = POISONED
        log.error("dag[%s]: node %s failed (%s: %s) — descendants "
                  "poisoned, independent branches continue",
                  label, name, type(err).__name__, err)

    def _finish(name: str, err: Optional[BaseException]) -> None:
        with cv:
            now = time.monotonic()
            rs.end_t[name] = now
            if by[name].device:
                rs.device_running -= 1
                lease = rs.leases.pop(name, None)
                if lease is not None:
                    rs.free.update(lease)   # the lease back to the pool
            if err is None:
                rs.state[name] = DONE
                _mark_ready(name, now)
            else:
                _fail(name, err)
            cv.notify_all()

    def _worker(node: Node, lease_env: Optional[Dict[str, str]]) -> None:
        err: Optional[BaseException] = None
        try:
            _call_node(node, lease_env)
        except BaseException as e:  # noqa: BLE001 — reported per node
            err = e
        _finish(node.name, err)

    with cv:
        while True:
            progressed = True
            while progressed:
                progressed = False
                for name in dispatch:
                    if rs.state[name] != "pending" or dep_left[name] > 0:
                        continue
                    node = by[name]
                    if node.device:
                        if sliced:
                            if eff[name] > len(rs.free):
                                continue   # wait for leases to return
                        elif rs.device_running >= workers:
                            continue
                    now = time.monotonic()
                    # RESUME: a manifest completed by an earlier run
                    # (and still matching its inputs) skips the node
                    if node.done_check is not None:
                        try:
                            cached = bool(node.done_check())
                        except Exception:  # noqa: BLE001 — run instead
                            cached = False
                        if cached:
                            rs.state[name] = CACHED
                            rs.start_t[name] = rs.end_t[name] = now
                            _mark_ready(name, now)
                            progressed = True
                            continue
                    # injected faults land in dispatch order, before
                    # the node's body starts
                    try:
                        fault_point("dag.node")
                    except BaseException as e:  # noqa: BLE001
                        rs.start_t[name] = rs.end_t[name] = now
                        _fail(name, e)
                        progressed = True
                        continue
                    lease_env: Optional[Dict[str, str]] = None
                    if node.device and sliced:
                        k = eff[name]
                        lease = tuple(sorted(rs.free)[:k])
                        rs.free.difference_update(lease)
                        rs.leases[name] = lease
                        rs.lease_size[name] = k
                        # a fault at the lease seam returns the lease
                        # and poisons only this node's descendants
                        try:
                            fault_point("dag.slice")
                        except BaseException as e:  # noqa: BLE001
                            rs.free.update(rs.leases.pop(name))
                            rs.start_t[name] = rs.end_t[name] = now
                            _fail(name, e)
                            progressed = True
                            continue
                        lease_env = _lease_env(lease)
                    rs.state[name] = "running"
                    rs.start_t[name] = now
                    if node.device:
                        rs.device_running += 1
                        rs.max_concurrent = max(rs.max_concurrent,
                                                rs.device_running)
                    progressed = True
                    threading.Thread(target=_worker,
                                     args=(node, lease_env),
                                     name=f"dag-{name}",
                                     daemon=True).start()
            if all(s in (DONE, CACHED, FAILED, POISONED)
                   for s in rs.state.values()):
                break
            cv.wait(timeout=1.0)
        wall = time.monotonic() - t0
        if sliced and (rs.leases or len(rs.free) != total):
            # every terminal path returns its lease: reaching here is a
            # scheduler fault; report it without masking the run's own
            # outcome
            log.error("dag[%s]: leaked device lease(s) %s — %d/%d "
                      "indices free at exit", label,
                      sorted(rs.leases), len(rs.free), total)

    if obs_trace.active():
        # one span a node (parent: the run root) with its queue and run
        # children, each node on a track of its own
        for name in order:
            if name not in rs.start_t:
                continue
            ready = rs.ready_t.get(name, rs.start_t[name])
            nid = obs_trace.record_span(
                "dag.node", ready, rs.end_t[name],
                track=f"dag.{name}", node=name, state=rs.state[name])
            obs_trace.record_span("dag.queue", ready, rs.start_t[name],
                                  parent=nid, track=f"dag.{name}")
            obs_trace.record_span("dag.run", rs.start_t[name],
                                  rs.end_t[name], parent=nid,
                                  track=f"dag.{name}")

    report = _report(order, by, rs, workers, wall,
                     total if sliced else None)
    profiling.set_step_extra("dag", report)
    if rs.first_failure is not None:
        name, err = rs.first_failure
        poisoned = sorted(k for k, v in rs.state.items() if v == POISONED)
        raise DagError(
            f"DAG node {name!r} failed ({type(err).__name__}: {err}); "
            f"poisoned descendants: {poisoned or 'none'}; all other "
            "nodes completed", report) from err
    return report


def _report(order, by, rs: _RunState, workers: int, wall: float,
            total: Optional[int]) -> Dict:
    sliced = total is not None
    run_s = {n: max(rs.end_t.get(n, 0.0) - rs.start_t.get(n, 0.0), 0.0)
             for n in order if n in rs.start_t}
    chain, cp_s = _critical_path(order, by, run_s)
    on_chain = set(chain)
    recs = []
    for name in order:
        queue_s = max(rs.start_t.get(name, 0.0)
                      - rs.ready_t.get(name, 0.0), 0.0) \
            if name in rs.start_t else 0.0
        if not by[name].device:
            dv: Optional[int] = 0
        elif sliced:
            dv = rs.lease_size.get(name, 0)   # 0: cached/poisoned/failed
        else:
            dv = None                          # timeshared: no lease
        recs.append(dict(zip(DAG_FIELDS, (
            name, rs.state[name], list(by[name].deps),
            round(queue_s, 3), round(run_s.get(name, 0.0), 3),
            dv, name in on_chain))))
    if wall <= 0:
        occ = 0.0
    elif sliced:
        # lease-weighted: a node busy on k of N cards counts k/N
        busy = sum(run_s.get(n, 0.0) * rs.lease_size.get(n, 0)
                   for n in order if by[n].device)
        occ = round(busy / (wall * total), 3)
    else:
        busy = sum(run_s.get(n, 0.0) for n in order if by[n].device)
        occ = round(busy / (wall * workers), 3)
    return dict(zip(DAG_SUMMARY_FIELDS, (
        workers, total, round(wall, 3), round(cp_s, 3), occ,
        rs.max_concurrent,
        rs.first_failure[0] if rs.first_failure else None, recs)))
