"""Host input pipeline of the streaming steps — the port of `prefetch`,
`map_prefetch`, `map_stream`, `prefetch_depth` and `prefetch_workers`
of `shifu_tpu/data/pipeline.py`, and the host→device half the JAX
package left to `jax.device_put`.

- `prefetch(iterable)` yields the items of a chunk iterator in order
  while one reader thread stays up to `SHIFU_TPU_PREFETCH_DEPTH` items
  ahead (a bounded queue); the streaming stats, norm, correlation, PSI
  and the sampled analysis frame read their raw chunks through it.
- `map_prefetch(fn, items)` yields ``fn(item)`` in order while up to
  `depth` later items are computed on `SHIFU_TPU_PREFETCH_WORKERS`
  threads (0 = a plain sequential map, as in the JAX package);
  `map_stream(fn, iterable)` does the same over an unsized source (the
  streaming eval builds each chunk's matrices on the workers). `fn` is
  numpy only: the consumer thread keeps every device call. An error in
  a reader or a worker is raised again in the consumer at its item's
  place; closing a generator early stops its threads and waits for
  them.
- `Stager` moves a chunk's numpy blocks to the device. On the card each
  block is copied into a pinned host buffer and sent with
  ``non_blocking=True`` on a side CUDA stream; the compute stream waits
  on that copy before it reads the block. Pinned buffers come in a ring
  of two a block, each with a CUDA event: a buffer is refilled only
  after the copy that last read it has ended, so chunk k+1's copy runs
  while chunk k computes. On the CPU a block becomes a tensor copy.

Fault injection: the ``pipeline.fetch`` site fires once a chunk in the
producer (before each item is pulled, or before each `map_prefetch`
assembly), on the threaded and the sequential paths alike; an injected
error reaches the consumer at its item's place.

Observability, as in the JAX package: every stage accrues wall time
into a process-wide thread-safe accumulator — ``host_parse_s`` (reader
time in ``next()``), ``host_assemble_s`` (worker time in ``fn``),
``input_stall_s`` (consumer time spent waiting on the pipeline, the
number that collapses when the overlap works), ``chunks``, ``h2d_s``
(`Stager.put`: the host time of enqueueing a chunk's copies) and the
layers' own timers (``device_step_s``, ``ckpt_save_s``, ``serve_*_s``,
...); `host_fetch` is the one sanctioned device→host read of a hot
path and counts its wait in ``host_sync_s``/``host_syncs``. On the
sequential paths all fetch time is stall time by definition.
`profiling.step_metrics` drains the accumulator into the step's
``tmp/metrics/steps.jsonl`` record under ``inputPipeline``; with
SHIFU_TPU_TRACE=1 the stages are also recorded as ``input.*`` spans.
No timer synchronizes the card: a device stage's timer is the host's
dispatch time.
"""

from __future__ import annotations

import collections
import queue
import threading
import time
from typing import Callable, Dict, Iterable, Iterator, Optional, Sequence, \
    Tuple, TypeVar

import numpy as np
import torch

from shifu_tpu_torch.config.environment import knob_int
from shifu_tpu_torch.obs import trace as obs_trace
from shifu_tpu_torch.resilience import fault_point, make_lock

T = TypeVar("T")
U = TypeVar("U")

PREFETCH_DEPTH = 2   # items assembled ahead of the consumer
FETCH_SITE = "pipeline.fetch"


def prefetch_depth() -> int:
    """SHIFU_TPU_PREFETCH_DEPTH (chunks buffered ahead; 0 = off)."""
    return max(knob_int("SHIFU_TPU_PREFETCH_DEPTH"), 0)


def prefetch_workers() -> int:
    """SHIFU_TPU_PREFETCH_WORKERS (assembly threads; 0 = off)."""
    return max(knob_int("SHIFU_TPU_PREFETCH_WORKERS"), 0)


# ---------------------------------------------------------------------------
# per-stage wall-time accumulator (drained into steps.jsonl)
# ---------------------------------------------------------------------------

_timers_lock = make_lock("pipeline.timers")
_timers: collections.Counter = collections.Counter()


def add_stage_time(stage: str, seconds: float) -> None:
    """Accrue wall seconds for a pipeline stage (thread-safe)."""
    with _timers_lock:
        _timers[stage] += seconds


def add_stage_count(stage: str, n: int = 1) -> None:
    with _timers_lock:
        _timers[stage] += n


def peek_stage_timers() -> Dict[str, float]:
    """Snapshot the accumulated stage timers without clearing them."""
    with _timers_lock:
        return {k: round(float(v), 6) for k, v in _timers.items()}


def drain_stage_timers() -> Dict[str, float]:
    """Snapshot AND clear — each steps.jsonl record owns its interval."""
    with _timers_lock:
        out = {k: round(float(v), 6) for k, v in _timers.items()}
        _timers.clear()
    return out


def host_fetch(x) -> np.ndarray:
    """The one sanctioned device→host read of a hot path: `x` (a tensor
    on any device, or an array) as a numpy array, its wait accrued into
    the ``host_sync_s`` stage timer with a ``host_syncs`` count, so a
    deliberate read shows in ``steps.jsonl`` instead of hiding as
    generic slowness. It adds no read: it times the one the caller
    makes."""
    t0 = time.perf_counter()
    out = x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)
    add_stage_time("host_sync_s", time.perf_counter() - t0)
    add_stage_count("host_syncs")
    return out


class _Done:
    pass


class _Raised:
    """An error of a reader thread, carried to the consumer."""
    __slots__ = ("exc",)

    def __init__(self, exc: BaseException):
        self.exc = exc


_DONE = _Done()


def _reader(iterable: Iterable, q: queue.Queue, stop: threading.Event,
            wrap: Callable = lambda item: item) -> threading.Thread:
    """Start a thread that puts ``wrap(item)`` for each item of
    `iterable` on `q`, then `_DONE` (or `_Raised`), giving up when
    `stop` is set: it never blocks for ever on a full queue."""
    def offer(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.05)
                return True
            except queue.Full:
                continue
        return False

    def produce() -> None:
        it = iter(iterable)
        while not stop.is_set():
            t0 = time.monotonic()
            try:
                fault_point(FETCH_SITE)
                item = next(it)
            except StopIteration:
                offer(_DONE)
                return
            except BaseException as e:  # noqa: BLE001 — carried across
                offer(_Raised(e))
                return
            t1 = time.monotonic()
            add_stage_time("host_parse_s", t1 - t0)
            obs_trace.record_span("input.host_parse", t0, t1)
            if not offer(wrap(item)):
                return

    worker = threading.Thread(target=produce, daemon=True,
                              name="shifu-prefetch")
    worker.start()
    return worker


def _sync_fetch(iterable: Iterable[T]) -> Iterator[T]:
    """The sequential path: the items of `iterable`, the fetch site
    firing before each is pulled (all fetch time is stall time)."""
    it = iter(iterable)
    while True:
        t0 = time.monotonic()
        try:
            fault_point(FETCH_SITE)
            item = next(it)
        except StopIteration:
            return
        finally:
            dt = time.monotonic() - t0
            add_stage_time("host_parse_s", dt)
            add_stage_time("input_stall_s", dt)
        obs_trace.record_span("input.host_parse", t0, t0 + dt)
        add_stage_count("chunks")
        yield item


def _assembled(fn: Callable[[T], U]) -> Callable[[T], U]:
    """`fn` with its wall time accrued to ``host_assemble_s`` and an
    ``input.host_assemble`` span."""
    def timed(item: T) -> U:
        t0 = time.monotonic()
        try:
            return fn(item)
        finally:
            t1 = time.monotonic()
            add_stage_time("host_assemble_s", t1 - t0)
            obs_trace.record_span("input.host_assemble", t0, t1)
    return timed


def _drain(q: queue.Queue) -> None:
    """Empty `q` (cancelling queued futures) so a reader waiting on a
    full queue sees `stop`."""
    while True:
        try:
            got = q.get_nowait()
        except queue.Empty:
            return
        if hasattr(got, "cancel"):
            got.cancel()


def prefetch(iterable: Iterable[T], depth: Optional[int] = None
             ) -> Iterator[T]:
    """The items of `iterable` in order, read by one thread that stays
    at most `depth` items ahead (memory: depth + 1 live chunks). With
    ``depth=0`` or ``SHIFU_TPU_PREFETCH_WORKERS=0`` a plain loop. A
    reader error is raised again here; closing the generator early
    stops the reader and joins it."""
    if depth is None:
        depth = prefetch_depth()
    if depth <= 0 or prefetch_workers() <= 0:
        yield from _sync_fetch(iterable)
        return
    q: queue.Queue = queue.Queue(maxsize=depth)
    stop = threading.Event()
    worker = _reader(iterable, q, stop)
    try:
        while True:
            t0 = time.monotonic()
            item = q.get()
            add_stage_time("input_stall_s", time.monotonic() - t0)
            if item is _DONE:
                return
            if isinstance(item, _Raised):
                raise item.exc
            add_stage_count("chunks")
            yield item
    finally:
        stop.set()
        _drain(q)
        worker.join()


def map_stream(fn: Callable[[T], U], iterable: Iterable[T],
               depth: Optional[int] = None,
               workers: Optional[int] = None) -> Iterator[U]:
    """`map_prefetch` over an unsized source: ``fn(item)`` for each item
    of `iterable` in order, one thread pulling items and up to `depth`
    calls of `fn` in flight on `workers` threads (``next()`` time accrues
    to ``host_parse_s``, `fn` time to ``host_assemble_s``). With
    ``workers=0`` or ``depth=0`` a plain sequential map. Reader and
    worker errors are raised again at the failed item's place; closing
    the generator early cancels what is queued and joins every
    thread."""
    if depth is None:
        depth = prefetch_depth()
    if workers is None:
        workers = prefetch_workers()
    timed = _assembled(fn)
    if depth <= 0 or workers <= 0:
        for item in _sync_fetch(iterable):
            t0 = time.monotonic()
            try:
                out = timed(item)
            finally:
                # synchronous: assembly time IS stall time
                add_stage_time("input_stall_s", time.monotonic() - t0)
            yield out
        return

    from concurrent.futures import ThreadPoolExecutor
    q: queue.Queue = queue.Queue(maxsize=depth)
    stop = threading.Event()
    ex = ThreadPoolExecutor(max_workers=min(workers, depth),
                            thread_name_prefix="shifu-pipeline")
    worker = _reader(iterable, q, stop,
                     wrap=lambda item: ex.submit(timed, item))
    try:
        while True:
            t0 = time.monotonic()
            got = q.get()
            if got is _DONE:
                add_stage_time("input_stall_s", time.monotonic() - t0)
                return
            if isinstance(got, _Raised):
                add_stage_time("input_stall_s", time.monotonic() - t0)
                raise got.exc
            try:
                out = got.result()
            finally:
                add_stage_time("input_stall_s", time.monotonic() - t0)
            add_stage_count("chunks")
            yield out
    finally:
        stop.set()
        _drain(q)
        worker.join()
        ex.shutdown(wait=True, cancel_futures=True)


def map_prefetch(fn: Callable[[T], U], items: Sequence[T],
                 depth: int = PREFETCH_DEPTH,
                 workers: Optional[int] = None) -> Iterator[U]:
    """Yield ``fn(item)`` for each item in order, computing up to
    `depth` items ahead on `workers` threads (``fn`` time accrues to
    ``host_assemble_s``). With ``workers=0`` (or ``depth=0``) this is a
    plain sequential map. A worker's error re-raises at its item's place
    in the order; later submissions are cancelled."""
    items = list(items)
    if workers is None:
        workers = prefetch_workers()

    def fetch(item: T) -> U:
        fault_point(FETCH_SITE)
        return fn(item)

    fetched = _assembled(fetch)
    if depth <= 0 or workers <= 0 or not items:
        for item in items:
            t0 = time.monotonic()
            try:
                out = fetched(item)
            finally:
                # synchronous: assembly time IS stall time
                add_stage_time("input_stall_s", time.monotonic() - t0)
            add_stage_count("chunks")
            yield out
        return

    from concurrent.futures import ThreadPoolExecutor
    pending: collections.deque = collections.deque()
    ex = ThreadPoolExecutor(max_workers=min(workers, depth),
                            thread_name_prefix="shifu-pipeline")
    try:
        idx = 0
        while idx < min(depth, len(items)):
            pending.append(ex.submit(fetched, items[idx]))
            idx += 1
        while pending:
            fut = pending.popleft()
            t0 = time.monotonic()
            try:
                out = fut.result()
            finally:
                add_stage_time("input_stall_s", time.monotonic() - t0)
            if idx < len(items):
                pending.append(ex.submit(fetched, items[idx]))
                idx += 1
            add_stage_count("chunks")
            yield out
    finally:
        for fut in pending:
            fut.cancel()
        ex.shutdown(wait=False)


class Stager:
    """Host→device copies of numpy blocks (see the module docstring).
    `put(key, array)` returns the block as a tensor on `device`; `key`
    names the ring of pinned buffers the block goes through (one per
    input of a chunk). Each put's host time (the pinned fill and the
    enqueue, not the copy itself) accrues to ``h2d_s`` with an
    ``input.h2d`` span."""

    def __init__(self, device: torch.device):
        self.device = torch.device(device)
        self.cuda = self.device.type == "cuda"
        self._rings: Dict[str, list] = {}
        self._turn: Dict[str, int] = {}
        self._stream = torch.cuda.Stream(self.device) if self.cuda else None

    def _buffer(self, key: str, arr: np.ndarray
                ) -> Tuple[torch.Tensor, Optional[torch.cuda.Event]]:
        ring = self._rings.setdefault(key, [None, None])
        turn = self._turn.get(key, 0)
        self._turn[key] = 1 - turn
        slot = ring[turn]
        dtype = torch.from_numpy(np.empty(0, arr.dtype)).dtype
        if slot is None or slot[0].numel() < arr.size \
                or slot[0].dtype != dtype:
            if slot is not None and slot[1] is not None:
                slot[1].synchronize()
            slot = (torch.empty(max(arr.size, 1), dtype=dtype,
                                pin_memory=True), torch.cuda.Event())
            ring[turn] = slot
        else:
            # the copy that last read this buffer must have ended
            slot[1].synchronize()
        return slot

    def put(self, key: str, arr: np.ndarray) -> torch.Tensor:
        t0 = time.monotonic()
        try:
            return self._put(key, arr)
        finally:
            t1 = time.monotonic()
            add_stage_time("h2d_s", t1 - t0)
            obs_trace.record_span("input.h2d", t0, t1, key=key)

    def _put(self, key: str, arr: np.ndarray) -> torch.Tensor:
        arr = np.ascontiguousarray(arr)
        if not self.cuda:
            return torch.tensor(arr, device=self.device)
        buf, event = self._buffer(key, arr)
        host = buf[:arr.size].view(arr.shape)
        host.numpy()[...] = arr
        compute = torch.cuda.current_stream(self.device)
        with torch.cuda.stream(self._stream):
            out = host.to(self.device, non_blocking=True)
            event.record(self._stream)
        compute.wait_stream(self._stream)
        # the block is made on the side stream and read on the compute
        # stream: the allocator must not hand its memory out before the
        # compute stream is done with it
        out.record_stream(compute)
        return out
