"""Host input pipeline of the streaming trainers — the port of
`map_prefetch` and `prefetch_workers` of `shifu_tpu/data/pipeline.py`,
and the host→device half the JAX package left to `jax.device_put`.

- `map_prefetch(fn, items)` yields ``fn(item)`` in order while up to
  `depth` later items are computed on `SHIFU_TPU_PREFETCH_WORKERS`
  threads (0 = a plain sequential map, as in the JAX package). `fn` is
  numpy only: the consumer thread keeps every device call.
- `Stager` moves a chunk's numpy blocks to the device. On the card each
  block is copied into a pinned host buffer and sent with
  ``non_blocking=True`` on a side CUDA stream; the compute stream waits
  on that copy before it reads the block. Pinned buffers come in a ring
  of two a block, each with a CUDA event: a buffer is refilled only
  after the copy that last read it has ended, so chunk k+1's copy runs
  while chunk k computes. On the CPU a block becomes a tensor copy.

The JAX package's stage timers and fault sites (`add_stage_time`,
`fault_point`) belong to its tracing and resilience planes (ROADMAP
A8) and have no counterpart here.
"""

from __future__ import annotations

import collections
from typing import Callable, Dict, Iterator, Optional, Sequence, Tuple, \
    TypeVar

import numpy as np
import torch

from shifu_tpu_torch.config.environment import knob_int

T = TypeVar("T")
U = TypeVar("U")

PREFETCH_DEPTH = 2   # items assembled ahead of the consumer


def prefetch_workers() -> int:
    """SHIFU_TPU_PREFETCH_WORKERS (assembly threads; 0 = off)."""
    return max(knob_int("SHIFU_TPU_PREFETCH_WORKERS"), 0)


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
    if depth <= 0 or workers <= 0 or not items:
        for item in items:
            yield fn(item)
        return

    from concurrent.futures import ThreadPoolExecutor
    pending: collections.deque = collections.deque()
    ex = ThreadPoolExecutor(max_workers=min(workers, depth),
                            thread_name_prefix="shifu-pipeline")
    try:
        idx = 0
        while idx < min(depth, len(items)):
            pending.append(ex.submit(fn, items[idx]))
            idx += 1
        while pending:
            out = pending.popleft().result()
            if idx < len(items):
                pending.append(ex.submit(fn, items[idx]))
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
