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
error reaches the consumer at its item's place. The JAX package's stage
timers, spans and lock checks (`add_stage_time`, `obs_trace`,
`lockcheck`) belong to its tracing plane (ROADMAP A8.5).
"""

from __future__ import annotations

import collections
import queue
import threading
from typing import Callable, Dict, Iterable, Iterator, Optional, Sequence, \
    Tuple, TypeVar

import numpy as np
import torch

from shifu_tpu_torch.config.environment import knob_int
from shifu_tpu_torch.resilience import fault_point

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
            try:
                fault_point(FETCH_SITE)
                item = next(it)
            except StopIteration:
                offer(_DONE)
                return
            except BaseException as e:  # noqa: BLE001 — carried across
                offer(_Raised(e))
                return
            if not offer(wrap(item)):
                return

    worker = threading.Thread(target=produce, daemon=True,
                              name="shifu-prefetch")
    worker.start()
    return worker


def _sync_fetch(iterable: Iterable[T]) -> Iterator[T]:
    """The sequential path: the items of `iterable`, the fetch site
    firing before each is pulled."""
    it = iter(iterable)
    while True:
        fault_point(FETCH_SITE)
        try:
            item = next(it)
        except StopIteration:
            return
        yield item


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
            item = q.get()
            if item is _DONE:
                return
            if isinstance(item, _Raised):
                raise item.exc
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
    calls of `fn` in flight on `workers` threads. With ``workers=0`` or
    ``depth=0`` a plain sequential map. Reader and worker errors are
    raised again at the failed item's place; closing the generator
    early cancels what is queued and joins every thread."""
    if depth is None:
        depth = prefetch_depth()
    if workers is None:
        workers = prefetch_workers()
    if depth <= 0 or workers <= 0:
        for item in _sync_fetch(iterable):
            yield fn(item)
        return

    from concurrent.futures import ThreadPoolExecutor
    q: queue.Queue = queue.Queue(maxsize=depth)
    stop = threading.Event()
    ex = ThreadPoolExecutor(max_workers=min(workers, depth),
                            thread_name_prefix="shifu-pipeline")
    worker = _reader(iterable, q, stop,
                     wrap=lambda item: ex.submit(fn, item))
    try:
        while True:
            got = q.get()
            if got is _DONE:
                return
            if isinstance(got, _Raised):
                raise got.exc
            yield got.result()
    finally:
        stop.set()
        _drain(q)
        worker.join()
        ex.shutdown(wait=True, cancel_futures=True)


def map_prefetch(fn: Callable[[T], U], items: Sequence[T],
                 depth: int = PREFETCH_DEPTH,
                 workers: Optional[int] = None) -> Iterator[U]:
    """Yield ``fn(item)`` for each item in order, computing up to
    `depth` items ahead on `workers` threads. With ``workers=0`` (or
    ``depth=0``) this is a plain sequential map. A worker's error
    re-raises at its item's place in the order; later submissions are
    cancelled."""
    items = list(items)
    if workers is None:
        workers = prefetch_workers()

    def fetched(item: T) -> U:
        fault_point(FETCH_SITE)
        return fn(item)

    if depth <= 0 or workers <= 0 or not items:
        for item in items:
            yield fetched(item)
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
            out = pending.popleft().result()
            if idx < len(items):
                pending.append(ex.submit(fetched, items[idx]))
                idx += 1
            yield out
    finally:
        for fut in pending:
            fut.cancel()
        ex.shutdown(wait=False)


class Stager:
    """Host→device copies of numpy blocks (see the module docstring).
    `put(key, array)` returns the block as a tensor on `device`; `key`
    names the ring of pinned buffers the block goes through (one per
    input of a chunk)."""

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
