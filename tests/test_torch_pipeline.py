"""The port's chunk pipeline (`shifu_tpu_torch.data.pipeline.prefetch`
and `map_stream`, the counterparts of the JAX package's): items come
out in source order, a reader's or a worker's exception is raised again
in the consumer at its item's place, depth 0 (or no workers) is a plain
sequential loop, and breaking out early leaves no pipeline thread
alive. Every test runs its body on a thread and fails after
`TIMEOUT_S` seconds rather than hanging the run.
"""

import threading
import time

import pytest

from shifu_tpu_torch.data import pipeline

TIMEOUT_S = 30.0


def within_timeout(fn):
    """Run `fn` on a daemon thread; fail if it is not done in time, and
    raise again whatever it raised."""
    out = {}

    def body():
        try:
            out["value"] = fn()
        except BaseException as e:  # noqa: BLE001 — raised below
            out["error"] = e
    t = threading.Thread(target=body, daemon=True)
    t.start()
    t.join(TIMEOUT_S)
    assert not t.is_alive(), f"did not finish within {TIMEOUT_S} s"
    if "error" in out:
        raise out["error"]
    return out.get("value")


def pipeline_threads():
    return [t for t in threading.enumerate()
            if t.name.startswith(("shifu-prefetch", "shifu-pipeline"))
            and t.is_alive()]


def slow_source(n, delay=0.001, fail_at=None):
    for i in range(n):
        if i == fail_at:
            raise KeyError(f"source failed at {i}")
        time.sleep(delay)
        yield i


def jittery(x):
    time.sleep(0.003 if x % 3 == 0 else 0.0005)
    if x == 13:
        raise ZeroDivisionError("worker failed at 13")
    return x * x


@pytest.mark.parametrize("depth,workers", [(2, 2), (1, 1), (4, 3)])
def test_prefetch_keeps_order(monkeypatch, depth, workers):
    monkeypatch.setenv("SHIFU_TPU_PREFETCH_WORKERS", str(workers))
    got = within_timeout(lambda: list(pipeline.prefetch(slow_source(50),
                                                        depth=depth)))
    assert got == list(range(50))


@pytest.mark.parametrize("depth,workers", [(2, 2), (3, 1), (4, 4)])
def test_map_stream_keeps_order(depth, workers):
    got = within_timeout(lambda: list(pipeline.map_stream(
        lambda x: jittery(x) if x != 13 else 169, slow_source(40),
        depth=depth, workers=workers)))
    assert got == [x * x for x in range(40)]


@pytest.mark.parametrize("depth", [0, 2])
def test_prefetch_raises_the_readers_error_in_place(monkeypatch, depth):
    monkeypatch.setenv("SHIFU_TPU_PREFETCH_WORKERS", "2")
    seen = []

    def consume():
        for i in pipeline.prefetch(slow_source(20, fail_at=7), depth=depth):
            seen.append(i)
    with pytest.raises(KeyError, match="failed at 7"):
        within_timeout(consume)
    assert seen == list(range(7))
    within_timeout(lambda: time.sleep(0.2))
    assert not pipeline_threads()


@pytest.mark.parametrize("workers", [0, 2])
def test_map_stream_raises_errors_in_place(workers):
    seen = []

    def consume():
        for y in pipeline.map_stream(jittery, slow_source(30), depth=3,
                                     workers=workers):
            seen.append(y)
    with pytest.raises(ZeroDivisionError, match="at 13"):
        within_timeout(consume)
    assert seen == [x * x for x in range(13)]
    seen.clear()

    def consume_source_error():
        for y in pipeline.map_stream(lambda x: x, slow_source(30,
                                                              fail_at=5),
                                     depth=2, workers=workers):
            seen.append(y)
    with pytest.raises(KeyError, match="failed at 5"):
        within_timeout(consume_source_error)
    assert seen == list(range(5))
    within_timeout(lambda: time.sleep(0.2))
    assert not pipeline_threads()


def test_depth_zero_is_sequential(monkeypatch):
    """Depth 0 (or no workers) starts no thread: each item is read (and
    mapped) on the consumer's thread, only when asked for."""
    monkeypatch.setenv("SHIFU_TPU_PREFETCH_DEPTH", "0")
    callers = []

    def source():
        for i in range(5):
            callers.append(threading.current_thread())
            yield i

    def run():
        before = threading.active_count()
        it = pipeline.prefetch(source())
        assert next(it) == 0 and len(callers) == 1
        assert list(it) == [1, 2, 3, 4]
        it = pipeline.map_stream(lambda x: (threading.current_thread(), x),
                                 source(), workers=0)
        mapped = list(it)
        assert threading.active_count() == before
        return mapped
    mapped = within_timeout(run)
    assert {id(t) for t in callers} == {id(mapped[0][0])}
    assert all(t is mapped[0][0] for t, _ in mapped)
    assert pipeline.prefetch_depth() == 0


@pytest.mark.parametrize("which", ["prefetch", "map_stream"])
def test_early_break_leaves_no_thread(monkeypatch, which):
    monkeypatch.setenv("SHIFU_TPU_PREFETCH_WORKERS", "3")
    monkeypatch.setenv("SHIFU_TPU_PREFETCH_DEPTH", "4")

    def consume():
        src = slow_source(10_000, delay=0.0005)
        it = pipeline.prefetch(src) if which == "prefetch" else \
            pipeline.map_stream(lambda x: x + 1, src)
        for i, _ in enumerate(it):
            if i == 25:
                assert pipeline_threads()
                break

    def run():
        consume()   # the generator is closed as it goes out of scope
        return pipeline_threads()
    assert within_timeout(run) == []


def test_knobs_are_registered():
    from shifu_tpu_torch.config.environment import KNOBS
    assert KNOBS["SHIFU_TPU_PREFETCH_DEPTH"].default == 2
    assert KNOBS["SHIFU_TPU_PREFETCH_WORKERS"].default == 2
    assert pipeline.prefetch_workers() >= 0
