"""Dynamic micro-batcher — counterpart of `shifu_tpu/serve/batcher.py`.

Many request-handler threads feed ONE consumer thread that owns the
device. The consumer opens a batch with the oldest queued request and
admits co-riders until the batch would exceed ``max_rows`` (the top
shape bucket) or the opener's deadline — submit time +
``SHIFU_TPU_SERVE_MAX_DELAY_MS`` — expires. A co-rider that would
overflow the bucket is carried over to open the next batch, so order
stays FIFO end to end. The admission queue is bounded
(``SHIFU_TPU_SERVE_QUEUE_DEPTH``); a full queue rejects the submit with
`queue.Full`. The ``serve.request`` fault site fires once a submit,
before the request is queued.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Any, Callable, Dict, List, Optional

from shifu_tpu_torch import resilience
from shifu_tpu_torch.config import environment as env

SERVE_SITE = "serve.request"


def max_delay_s() -> float:
    return env.knob_float("SHIFU_TPU_SERVE_MAX_DELAY_MS") / 1000.0


def queue_depth() -> int:
    return env.knob_int("SHIFU_TPU_SERVE_QUEUE_DEPTH")


class Request:
    """One scoring request riding the admission queue."""

    __slots__ = ("blocks", "n", "t_submit", "timing",
                 "_done", "_result", "_error")

    def __init__(self, blocks: Dict[str, Any], n: int):
        self.blocks = blocks
        self.n = n
        self.t_submit = time.monotonic()
        self.timing: Dict[str, float] = {}
        self._done = threading.Event()
        self._result: Any = None
        self._error: Optional[BaseException] = None

    def resolve(self, result: Any) -> None:
        self._result = result
        self._done.set()

    def reject(self, err: BaseException) -> None:
        self._error = err
        self._done.set()

    def wait(self, timeout: Optional[float] = None) -> Any:
        if not self._done.wait(timeout):
            raise TimeoutError(
                f"scoring request ({self.n} rows) not served in "
                f"{timeout}s")
        if self._error is not None:
            raise self._error
        return self._result


class MicroBatcher:
    """Admission queue + single consumer thread; `score_batch` is the
    device-owning callback ``(requests) -> None`` that must resolve or
    reject every request it is handed."""

    def __init__(self, score_batch: Callable[[List[Request]], None],
                 max_rows: int,
                 max_delay: Optional[float] = None,
                 depth: Optional[int] = None):
        self._score_batch = score_batch
        self.max_rows = int(max_rows)
        self.max_delay = max_delay_s() if max_delay is None else max_delay
        self._q: "queue.Queue[Request]" = queue.Queue(
            maxsize=queue_depth() if depth is None else depth)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._carry: Optional[Request] = None  # consumer-thread only
        self._stats_lock = threading.Lock()
        self.batches = 0
        self.requests = 0
        self.rows = 0
        self._occupancy_sum = 0.0

    # -- producer side -------------------------------------------------
    def submit(self, blocks: Dict[str, Any], n: int) -> Request:
        """Enqueue one request; raises `queue.Full` on backpressure and
        whatever the `serve.request` fault site injects."""
        if self._thread is None or self._stop.is_set():
            raise RuntimeError("micro-batcher is not running")
        if n <= 0 or n > self.max_rows:
            raise ValueError(
                f"request rows must be in [1, {self.max_rows}], got {n}")
        resilience.fault_point(SERVE_SITE)
        req = Request(blocks, n)
        self._q.put_nowait(req)
        return req

    # -- consumer side -------------------------------------------------
    def start(self) -> None:
        if self._thread is not None:
            return
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._run, name="serve-batcher", daemon=True)
        self._thread.start()

    def close(self) -> None:
        if self._thread is None:
            return
        self._stop.set()
        self._thread.join()
        self._thread = None
        err = RuntimeError("scorer service shut down")
        if self._carry is not None:
            self._carry.reject(err)
            self._carry = None
        while True:
            try:
                self._q.get_nowait().reject(err)
            except queue.Empty:
                break

    def _run(self) -> None:
        while not self._stop.is_set():
            opener = self._carry
            self._carry = None
            if opener is None:
                try:
                    # short poll so close() is never waited on for long
                    opener = self._q.get(timeout=0.05)
                except queue.Empty:
                    continue
            batch = self._form_batch(opener)
            try:
                self._score_batch(batch)
            except BaseException as e:  # resolve/reject is the contract
                for r in batch:
                    r.reject(e)

    def _form_batch(self, opener: Request) -> List[Request]:
        deadline = opener.t_submit + self.max_delay
        batch, rows = [opener], opener.n
        while rows < self.max_rows and not self._stop.is_set():
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                break
            try:
                nxt = self._q.get(timeout=remaining)
            except queue.Empty:
                break
            if rows + nxt.n > self.max_rows:
                self._carry = nxt
                break
            batch.append(nxt)
            rows += nxt.n
        t = time.monotonic()
        for r in batch:
            r.timing["queue_s"] = t - r.t_submit
        with self._stats_lock:
            self.batches += 1
            self.requests += len(batch)
            self.rows += rows
            self._occupancy_sum += rows / self.max_rows
        return batch

    def stats(self) -> Dict[str, Any]:
        with self._stats_lock:
            b = max(self.batches, 1)
            return {
                "batches": self.batches,
                "requests": self.requests,
                "rows": self.rows,
                "occupancy_mean": self._occupancy_sum / b,
                "rows_per_batch": self.rows / b,
                "queued_now": self._q.qsize(),
            }
