"""Training checkpoints and resume — the port of
`shifu_tpu/train/checkpoint.py`.

The full training state — parameters, optimizer state, the
best-validation tracker, the early-stop counters, the dropout
generator — is one nested structure (tuples, lists, dicts of tensors or
numpy arrays, a `torch.Generator`, None) saved every
`checkpoint_interval` epochs. A restarted run restores it and goes on
with the epoch where it stopped.

Layout: there is no orbax; the port writes the JAX package's fallback
layout. `step_N.npz` is a model spec (`models/spec.save_model(path,
"ckpt", {"step": N}, state)`) whose arrays are named by their path in
the state (``p.0.1.w``; a None is left out, a generator is its byte
state ``.gen_state`` and its device type ``.gen_device``), then comes
the `step_N.sharding.json` sidecar, then the older steps are pruned.
`restore_state` rebuilds the state against `like` — its structure,
dtypes and devices — reading each array by its path: tuples stay
tuples, int32 and bool trackers keep their dtype. A generator written
on one device type (a CUDA generator's state is a Philox seed and
offset, a CPU one's the MT19937 state) restores only onto the same
type: another raises `GeneratorDeviceMismatch` (a `ValueError`), which
`restore_latest` does not take for an unreadable step.

Async saves (snapshot, then a background write): with
`SHIFU_TPU_CKPT_ASYNC=1` (the default) `save_checkpoint` pays only the
snapshot on the training thread — a host copy of every tensor, never an
alias (a CPU tensor's ``.cpu()`` is the same storage, so it is cloned),
so training may overwrite the live state at once — and hands the
serialize and atomic publish to one background writer thread. One
snapshot may be in flight: the next save waits for its write (the JAX
package's default; its slot knob comes with ROADMAP A8.3). Writer
errors surface at the next save or flush.

Crash safety: each file is staged under a temporary name and renamed
(`fileio.atomic_path`), so a kill mid-save never leaves a corrupt
published step; `restore_latest` walks the steps newest first and falls
back past any unreadable `step_N.npz`. Fault sites: `ckpt.save` (before
staging — a kill here loses nothing), `ckpt.stage` (during the
snapshot), `ckpt.publish` (after the snapshot, before the write
commits — a kill here leaves only step N-1), `ckpt.saved` (after
publication: the "crash right after checkpoint N" case), `ckpt.restore`
and `ckpt.reshard`.

Sidecar: on one card every tensor leaf is recorded replicated (``[]``)
on the JAX package's one-device mesh record, with the default
logical→physical rules table; numpy leaves (the streaming trainer's
host curves and counters) get no entry and restore on the host.
`place_resharded` moves each recorded leaf onto the caller's device; a
sidecar written on a mesh of more than one device restores replicated,
with one log line. Placement across cards is ROADMAP A8.3, the
`ckpt.*` spans and the ``ckpt_save_s``/``ckpt_stall_s`` stage timers
A8.5.
"""

from __future__ import annotations

import collections
import json
import logging
import os
import shutil
import threading
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Tuple, \
    Union

import numpy as np
import torch

from shifu_tpu_torch.config.environment import knob_bool
from shifu_tpu_torch.fileio import atomic_write
from shifu_tpu_torch.resilience import fault_point, make_lock, sweep_stale

log = logging.getLogger("shifu_tpu_torch")

# the JAX package's one-device mesh record and default rules table
# (`shifu_tpu/parallel/mesh.py`: mesh_topology, _DEFAULT_RULES)
ONE_CARD_MESH = {"axes": ["data", "model"], "shape": [1, 1], "devices": 1,
                 "hosts": 1}
DEFAULT_RULES = {"rows": "data", "hidden": "model", "cat": "model",
                 "task": "model"}


class GeneratorDeviceMismatch(ValueError):
    """A checkpointed dropout generator restored onto another device
    type: its state cannot carry over, and fresh numbers would change
    the run."""


class _GenSnap(NamedTuple):
    state: torch.Tensor      # the generator's byte state, a host copy
    device: str              # "cpu" | "cuda"


def _copy_leaf(x: Any) -> Any:
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", copy=True)
    if isinstance(x, torch.Generator):
        return _GenSnap(x.get_state().clone(), x.device.type)
    if x is None:
        return None
    return np.array(x)


def _map(fn: Callable, state: Any) -> Any:
    """`fn` over every leaf, the structure kept (tuples stay tuples)."""
    if isinstance(state, dict):
        return {k: _map(fn, v) for k, v in state.items()}
    if isinstance(state, (list, tuple)):
        return type(state)(_map(fn, v) for v in state)
    return fn(state)


def _snapshot(state: Any) -> Any:
    """Device→host staging: a host copy of the state, the only part of
    a save the training thread waits for."""
    fault_point("ckpt.stage")
    return _map(_copy_leaf, state)


def _leaves(state: Any, path: str = "") -> List[Tuple[str, Any]]:
    """(keystr, leaf) in order; keys as `jax.tree_util.keystr` writes
    them (``[0]['w']``)."""
    if isinstance(state, dict):
        return [kv for k, v in state.items()
                for kv in _leaves(v, f"{path}[{k!r}]")]
    if isinstance(state, (list, tuple)):
        return [kv for i, v in enumerate(state)
                for kv in _leaves(v, f"{path}[{i}]")]
    return [(path, state)]


def sharding_meta(state: Any) -> Optional[dict]:
    """The sidecar of a live state: each tensor leaf replicated on the
    one-card mesh; None when the state holds no tensor."""
    entries = {key: [] for key, leaf in _leaves(state)
               if isinstance(leaf, torch.Tensor)}
    if not entries:
        return None
    return {"version": 1, "leaves": entries, "mesh": dict(ONE_CARD_MESH),
            "rules": dict(DEFAULT_RULES)}


def _spec_tree(snap: Any) -> Any:
    """The tree `save_model` writes: numpy leaves, lists as {index:
    leaf} maps (a None leaves a gap, `spec._flatten` names the rest
    alike), a generator as its state and device type."""
    if isinstance(snap, _GenSnap):
        return {"gen_state": snap.state.numpy(),
                "gen_device": np.asarray(snap.device)}
    if isinstance(snap, dict):
        return {k: _spec_tree(v) for k, v in snap.items() if v is not None}
    if isinstance(snap, (list, tuple)):
        return {str(i): _spec_tree(v) for i, v in enumerate(snap)
                if v is not None}
    if isinstance(snap, torch.Tensor):
        if snap.dtype in (torch.bfloat16, torch.float16):
            snap = snap.float()   # exact; restored in `like`'s dtype
        return snap.numpy()
    return np.asarray(snap)


def _sidecar_name(step: int) -> str:
    return f"step_{step}.sharding.json"


def _publish(ckpt_dir: str, step: int, snap: Any,
             meta: Optional[dict] = None) -> None:
    """Serialize the host snapshot and publish `step_N.npz`, then its
    sidecar, then prune the older steps. The sidecar commits after the
    step: a kill between the two leaves a restorable step that falls
    back to the caller's placement, never the reverse."""
    from shifu_tpu_torch.models.spec import save_model
    ckpt_dir = os.path.abspath(ckpt_dir)
    sweep_stale(ckpt_dir)
    path = os.path.join(ckpt_dir, f"step_{step}")
    fault_point("ckpt.publish")
    save_model(path + ".npz", "ckpt", {"step": step}, _spec_tree(snap))
    if meta is not None:
        with atomic_write(os.path.join(ckpt_dir, _sidecar_name(step)),
                          "w") as f:
            json.dump({"step": step, **meta}, f)
    keep = (f"step_{step}", f"step_{step}.npz", _sidecar_name(step))
    for old in os.listdir(ckpt_dir):
        if old.startswith("step_") and old not in keep:
            full = os.path.join(ckpt_dir, old)
            if os.path.isdir(full):
                shutil.rmtree(full, ignore_errors=True)
            else:
                os.remove(full)
    fault_point("ckpt.saved")


def save_state(ckpt_dir: str, step: int, state: Any) -> None:
    """Write the training state for `step` (epochs done) synchronously,
    replacing any older checkpoint."""
    fault_point("ckpt.save")
    os.makedirs(os.path.abspath(ckpt_dir), exist_ok=True)
    meta = sharding_meta(state)
    _publish(ckpt_dir, step, _snapshot(state), meta)


class AsyncCheckpointWriter:
    """Background writer: up to `SLOTS` staged snapshots in flight
    (queued or publishing), drained by one worker thread in FIFO
    order — the single ordered consumer keeps `_publish`'s prune
    safe. `save` surfaces a pending writer error, snapshots on the
    calling thread, then waits only while every slot is taken; `flush`
    waits for every write in flight (FIFO: the newest step publishes
    last) and raises (or logs) the first writer error."""

    def __init__(self) -> None:
        self._lock = make_lock("ckpt.writer")
        self._cond = threading.Condition()
        self._staged: collections.deque = collections.deque()
        self._inflight = 0
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    SLOTS = 1

    def _take_error(self) -> Optional[BaseException]:
        with self._lock:
            err, self._error = self._error, None
        return err

    def _ensure_worker(self) -> None:
        # callers hold self._cond
        if self._thread is None or not self._thread.is_alive():
            self._thread = threading.Thread(
                target=self._run, name="ckpt-writer", daemon=True)
            self._thread.start()

    def _run(self) -> None:
        while True:
            with self._cond:
                while not self._staged:
                    self._cond.wait()
                ckpt_dir, step, snap, meta = self._staged.popleft()
            try:
                _publish(ckpt_dir, step, snap, meta)
            except BaseException as e:  # noqa: BLE001 — surfaced at flush
                with self._lock:
                    if self._error is None:
                        self._error = e
            finally:
                with self._cond:
                    self._inflight -= 1
                    self._cond.notify_all()

    def save(self, ckpt_dir: str, step: int, state: Any) -> None:
        fault_point("ckpt.save")
        err = self._take_error()
        if err is not None:
            raise err
        os.makedirs(os.path.abspath(ckpt_dir), exist_ok=True)
        meta = sharding_meta(state)
        snap = _snapshot(state)
        with self._cond:
            while self._inflight >= self.SLOTS:
                self._cond.wait()
            self._inflight += 1
            self._staged.append((ckpt_dir, step, snap, meta))
            self._ensure_worker()
            self._cond.notify_all()

    def flush(self, reraise: bool = True) -> None:
        """Wait for every write in flight; raise (or, with
        ``reraise=False``, log) the first writer error."""
        with self._cond:
            while self._inflight:
                self._cond.wait()
        err = self._take_error()
        if err is not None:
            if reraise:
                raise err
            log.warning("background checkpoint write failed (%s: %s); "
                        "the previously published step remains "
                        "restorable", type(err).__name__, err)


_WRITER = AsyncCheckpointWriter()


def async_enabled() -> bool:
    return knob_bool("SHIFU_TPU_CKPT_ASYNC")


def save_checkpoint(ckpt_dir: str, step: int, state: Any) -> None:
    """The trainers' save: a background write with
    `SHIFU_TPU_CKPT_ASYNC=1` (the default), synchronous otherwise.
    Callers `flush_saves()` before they return or raise `Preempted`."""
    if async_enabled():
        _WRITER.save(ckpt_dir, step, state)
    else:
        save_state(ckpt_dir, step, state)


def flush_saves(reraise: bool = True) -> None:
    """Join barrier over the background writer (a no-op when idle);
    ``reraise=False`` logs a writer error instead, for unwind paths
    that must not mask the original exception."""
    _WRITER.flush(reraise=reraise)


def save_interrupt(ckpt_dir: str, step: int, state: Any) -> None:
    """The preemption checkpoint: flush any background write first
    (logging its error), then a synchronous `save_state`, logged so a
    resumed run's log shows where the preemption landed."""
    flush_saves(reraise=False)
    log.warning("preempt: saving shutdown checkpoint at step %d to %s "
                "(resume with SHIFU_TPU_RESUME=1)", step, ckpt_dir)
    save_state(ckpt_dir, step, state)


def _step_names(ckpt_dir: str) -> List[Tuple[int, str]]:
    """(step, name) of every published step_* entry; `.tmp` staging
    and sidecars excluded."""
    out = []
    for name in os.listdir(ckpt_dir):
        if not name.startswith("step_") or name.endswith(".tmp") \
                or name.endswith(".sharding.json"):
            continue
        try:
            out.append((int(name.split("_")[1].split(".")[0]), name))
        except ValueError:
            continue        # not a step entry
    return out


def latest_step(ckpt_dir: str) -> Optional[int]:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [s for s, _ in _step_names(ckpt_dir)]
    return max(steps) if steps else None


def _rebuild(like: Any, arrays: Dict[str, np.ndarray], key: str) -> Any:
    """`like` rebuilt from the arrays saved under `key` (see `_publish`
    for the names): its structure, dtypes and devices."""
    if like is None:
        return None
    if isinstance(like, torch.Generator):
        saved = str(arrays[key + ".gen_device"])
        if saved != like.device.type:
            raise GeneratorDeviceMismatch(
                f"the checkpoint's dropout generator was written on "
                f"{saved!r} and cannot restore onto {like.device.type!r}; "
                "resume on the device that wrote it, or remove the "
                "checkpoint to start over")
        gen = torch.Generator(device=like.device)
        gen.set_state(torch.from_numpy(np.array(arrays[key + ".gen_state"])))
        return gen
    if isinstance(like, dict):
        return {k: _rebuild(v, arrays, f"{key}.{k}") for k, v in like.items()}
    if isinstance(like, (list, tuple)):
        return type(like)(_rebuild(v, arrays, f"{key}.{i}")
                          for i, v in enumerate(like))
    arr = arrays[key]
    if isinstance(like, torch.Tensor):
        if tuple(arr.shape) != tuple(like.shape):
            raise ValueError(f"{key}: saved shape {arr.shape} != "
                             f"{tuple(like.shape)}")
        return torch.from_numpy(np.array(arr)).to(dtype=like.dtype,
                                                  device=like.device)
    like = np.asarray(like)
    if arr.shape != like.shape:
        raise ValueError(f"{key}: saved shape {arr.shape} != {like.shape}")
    return np.array(arr, dtype=like.dtype)


def restore_state(ckpt_dir: str, step: int, like: Any) -> Any:
    """The state saved at `step`, rebuilt against `like`. Raises when
    the checkpoint is missing, unreadable or of another shape — use
    `restore_latest` to fall back to an earlier one."""
    fault_point("ckpt.restore")
    path = os.path.join(os.path.abspath(ckpt_dir), f"step_{step}.npz")
    with np.load(path, allow_pickle=False) as z:
        header = json.loads(bytes(z["__header__"].tolist()).decode())
        if header.get("kind") != "ckpt":
            raise ValueError(f"{path} is a {header.get('kind')!r} spec, "
                             "not a checkpoint")
        arrays = {k: z[k] for k in z.files if k != "__header__"}
    return _rebuild(like, arrays, "p")


def restore_latest(ckpt_dir: str, like: Union[Any, Callable[[int], Any]],
                   max_step: Optional[int] = None
                   ) -> Optional[Tuple[int, Any]]:
    """The newest usable checkpoint as ``(step, state)``, skipping
    unreadable `step_N` entries with a warning; None when nothing is
    usable. `like` is the target state, or ``step -> state`` when the
    shapes depend on the step (the streaming trainer's per-epoch
    curves). Steps outside ``0 < step <= max_step`` are ignored (a
    longer earlier run must not skip this run's training). A generator
    of another device type raises."""
    if not os.path.isdir(ckpt_dir):
        return None
    candidates = sorted({s for s, _ in _step_names(ckpt_dir)
                         if s > 0 and (max_step is None or s <= max_step)},
                        reverse=True)
    for step in candidates:
        want = like(step) if callable(like) else like
        try:
            return step, restore_state(ckpt_dir, step, want)
        except GeneratorDeviceMismatch:
            raise
        except Exception as e:  # noqa: BLE001 — any unreadable step
            log.warning(
                "checkpoint step_%d in %s unreadable (%s: %s); falling "
                "back to the previous checkpoint", step, ckpt_dir,
                type(e).__name__, e)
    if candidates:
        log.warning("no usable checkpoint in %s (%d candidate(s) all "
                    "unreadable); starting from scratch", ckpt_dir,
                    len(candidates))
    return None


def load_sharding_meta(ckpt_dir: str, step: int) -> Optional[dict]:
    """`step_N`'s sidecar; None when absent or unreadable (the restore
    then keeps the caller's placement)."""
    path = os.path.join(os.path.abspath(ckpt_dir), _sidecar_name(step))
    try:
        with open(path) as f:
            return json.load(f)
    except FileNotFoundError:
        return None
    except Exception as e:  # noqa: BLE001 — not a lost step
        log.warning("sharding sidecar %s unreadable (%s) — restoring "
                    "with replicated placement", path, e)
        return None


def place_resharded(state: Any, meta: Optional[dict],
                    device: "str | torch.device | None" = None) -> Any:
    """Move each tensor leaf the sidecar lists onto `device` (None:
    where the restore put it, `like`'s device); unlisted leaves were
    host-resident at save time and stay. A sidecar written on a mesh of
    more than one device restores replicated on this card."""
    fault_point("ckpt.reshard")
    src = (meta or {}).get("mesh")
    if src and int(src.get("devices", 1)) > 1:
        log.info("reshard: a checkpoint written on a %s mesh restores "
                 "replicated onto one card",
                 "x".join(map(str, src.get("shape", []))))
    entries = (meta or {}).get("leaves")
    if device is None or entries is None:
        return state
    listed = set(entries)
    placed = {key: leaf.to(device) if key in listed and
              isinstance(leaf, torch.Tensor) else leaf
              for key, leaf in _leaves(state)}
    return _map_keyed(state, placed)


def _map_keyed(state: Any, leaves: Dict[str, Any], path: str = "") -> Any:
    if isinstance(state, dict):
        return {k: _map_keyed(v, leaves, f"{path}[{k!r}]")
                for k, v in state.items()}
    if isinstance(state, (list, tuple)):
        return type(state)(_map_keyed(v, leaves, f"{path}[{i}]")
                           for i, v in enumerate(state))
    return leaves[path]


def restore_resharded(ckpt_dir: str, like: Union[Any, Callable[[int], Any]],
                      device: "str | torch.device | None" = None,
                      max_step: Optional[int] = None
                      ) -> Optional[Tuple[int, Any]]:
    """`restore_latest`, then `place_resharded` through the step's
    sidecar. Returns ``(step, state)`` or None."""
    res = restore_latest(ckpt_dir, like, max_step=max_step)
    if res is None:
        return None
    step, state = res
    return step, place_resharded(state, load_sharding_meta(ckpt_dir, step),
                                 device)
