"""Versioned model registry — counterpart of
`shifu_tpu/registry/registry.py`, the same layout and manifest, so
either package resolves the other's registry.

Layout (one registry root serves many models):

    <root>/models/<name>/v001/          immutable version dir
        model0.npz ...                  artifacts (models/spec format)
        manifest.json                   family, dtype, ladder, sha256s
    <root>/models/<name>/HEAD           text pointer, e.g. "v002"

A publish stages the version dir under a dot-temp name, renames it
into place, then commits the HEAD pointer via write-tmp-then-rename —
both renames are atomic, so a reader (or a fleet re-warm) mid-publish
always sees either the previous complete version or the new one,
never a partial dir. The `registry.publish` fault site fires before
each rename: a SIGKILL at either point leaves the previous HEAD
intact and the registry readable (the chaos-drill guarantee).

gc keeps the last K versions per model (`SHIFU_TPU_REGISTRY_KEEP`)
and never deletes the HEAD version; rollback is one HEAD commit.
"""

from __future__ import annotations

import hashlib
import json
import logging
import os
import re
import shutil
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from shifu_tpu_torch.config.environment import knob_int
from shifu_tpu_torch.fileio import atomic_write
from shifu_tpu_torch.models import spec as spec_mod
from shifu_tpu_torch.resilience import absorbed, fault_point

log = logging.getLogger("shifu_tpu_torch")

MANIFEST_FILE = "manifest.json"
HEAD_FILE = "HEAD"

_VERSION_RE = re.compile(r"^v(\d{3,})$")


def _models_root(root: str) -> str:
    return os.path.join(root, "models")


def _model_dir(root: str, name: str) -> str:
    return os.path.join(_models_root(root), name)


def _fmt_version(n: int) -> str:
    return f"v{n:03d}"


def _sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def _param_bytes(params: Any) -> int:
    """Total array bytes in a nested list/dict pytree of arrays."""
    if isinstance(params, (list, tuple)):
        return sum(_param_bytes(p) for p in params)
    if isinstance(params, dict):
        return sum(_param_bytes(v) for v in params.values())
    if params is None:
        return 0
    return int(np.asarray(params).nbytes)


def versions(root: str, name: str) -> List[str]:
    """Complete version dirs for one model, ascending."""
    d = _model_dir(root, name)
    if not os.path.isdir(d):
        return []
    out = []
    for entry in os.listdir(d):
        m = _VERSION_RE.match(entry)
        if m and os.path.isfile(os.path.join(d, entry, MANIFEST_FILE)):
            out.append((int(m.group(1)), entry))
    return [v for _, v in sorted(out)]


def head(root: str, name: str) -> Optional[str]:
    """The published version the HEAD pointer names, or None when the
    model has never been published (or the pointed dir is gone)."""
    path = os.path.join(_model_dir(root, name), HEAD_FILE)
    try:
        with open(path, encoding="utf-8") as f:
            v = f.read().strip()
    except OSError:
        return None
    if v and os.path.isfile(os.path.join(_model_dir(root, name), v,
                                         MANIFEST_FILE)):
        return v
    return None


def read_manifest(root: str, name: str,
                  version: Optional[str] = None) -> Dict[str, Any]:
    _, vdir, manifest = resolve(root, name, version)
    return manifest


def resolve(root: str, name: str, version: Optional[str] = None
            ) -> Tuple[str, str, Dict[str, Any]]:
    """(version, version_dir, manifest) for HEAD or a named version."""
    v = version or head(root, name)
    if v is None:
        raise FileNotFoundError(
            f"registry: model {name!r} has no published HEAD "
            f"under {root}")
    vdir = os.path.join(_model_dir(root, name), v)
    mpath = os.path.join(vdir, MANIFEST_FILE)
    if not os.path.isfile(mpath):
        raise FileNotFoundError(
            f"registry: {name}/{v} is not a complete version "
            f"(no {MANIFEST_FILE})")
    with open(mpath, encoding="utf-8") as f:
        return v, vdir, json.load(f)


def _scrub_stale_tmp(model_dir: str) -> None:
    """Remove stage residue a killed publish left behind — a `.tmp.*`
    stage dir never looks like a version, so this is pure hygiene."""
    try:
        entries = os.listdir(model_dir)
    except OSError:
        return
    for entry in entries:
        if entry.startswith(".tmp."):
            path = os.path.join(model_dir, entry)
            try:
                shutil.rmtree(path) if os.path.isdir(path) \
                    else os.remove(path)
            except OSError as e:
                absorbed("registry.gc-tmp", e)


def _model_shape_meta(kind: str, meta: Dict[str, Any]
                      ) -> Tuple[Optional[int], int]:
    """(input_dim, working-row bytes) for the HBM budget estimate: one
    padded row's activations through the widest layer chain, f32."""
    sp = meta.get("spec") or {}
    dim = sp.get("input_dim")
    if dim is None:
        return None, 0
    widths = [int(dim)] + [int(h) for h in sp.get("hidden_dims", [])] \
        + [1]
    return int(dim), 4 * sum(widths)


def publish(root: str, name: str, models_dir: str,
            priority: str = "high",
            ladder: Optional[Tuple[int, ...]] = None,
            max_delay_ms: Optional[float] = None,
            extra: Optional[Dict[str, Any]] = None) -> str:
    """Publish the model specs in `models_dir` as the next version of
    `name` and commit HEAD to it. Returns the new version string."""
    if priority not in ("high", "low"):
        raise ValueError(f"priority must be high|low, got {priority!r}")
    paths = spec_mod.list_models(models_dir)
    if not paths:
        raise FileNotFoundError(
            f"registry publish: no model specs under {models_dir}")
    from shifu_tpu_torch.serve import aot
    ladder = tuple(int(b) for b in (ladder or aot.bucket_ladder()))

    mdir = _model_dir(root, name)
    os.makedirs(mdir, exist_ok=True)
    _scrub_stale_tmp(mdir)
    existing = versions(root, name)
    next_n = (int(_VERSION_RE.match(existing[-1]).group(1)) + 1
              if existing else 1)
    version = _fmt_version(next_n)
    vdir = os.path.join(mdir, version)
    stage = os.path.join(mdir, f".tmp.{os.getpid()}.{version}")

    family, files, param_bytes = [], {}, 0
    input_dim, working_row_bytes = None, 0
    compute_dtype = "float32"
    os.makedirs(stage, exist_ok=True)
    try:
        for src in paths:
            base = os.path.basename(src)
            shutil.copy2(src, os.path.join(stage, base))
            files[base] = _sha256(src)
            kind, meta, params = spec_mod.load_model(src)
            family.append(kind)
            param_bytes += _param_bytes(params)
            dim, row_bytes = _model_shape_meta(kind, meta)
            if dim is not None:
                input_dim = dim if input_dim is None else input_dim
                working_row_bytes = max(working_row_bytes, row_bytes)
            dtype = (meta.get("spec") or {}).get("compute_dtype")
            if dtype:
                compute_dtype = str(dtype)
        manifest = {
            "name": name, "version": version, "family": family,
            "compute_dtype": compute_dtype, "ladder": list(ladder),
            "priority": priority, "max_delay_ms": max_delay_ms,
            "files": files, "param_bytes": int(param_bytes),
            "input_dim": input_dim,
            "working_row_bytes": int(working_row_bytes),
            "created": time.strftime("%Y-%m-%dT%H:%M:%S"),
        }
        if extra:
            manifest.update(extra)
        with open(os.path.join(stage, MANIFEST_FILE), "w",
                  encoding="utf-8") as f:
            json.dump(manifest, f, indent=1, sort_keys=True)
            f.flush()
            os.fsync(f.fileno())
        # commit 1: the immutable version dir appears atomically
        fault_point("registry.publish")
        os.replace(stage, vdir)
    except BaseException:
        shutil.rmtree(stage, ignore_errors=True)
        raise
    # commit 2: HEAD flips to the new version (write-tmp-then-rename);
    # a kill between the renames leaves a complete-but-unreferenced
    # version dir and the PREVIOUS HEAD intact — gc reaps the orphan
    fault_point("registry.publish")
    with atomic_write(os.path.join(mdir, HEAD_FILE)) as f:
        f.write(version + "\n")
    log.info("registry: published %s/%s (%d spec(s), %d param bytes)",
             name, version, len(files), param_bytes)
    return version


def annotate(root: str, name: str, version: str,
             extra: Dict[str, Any]) -> Dict[str, Any]:
    """Merge `extra` into a published version's manifest atomically
    (write-tmp-then-rename). The artifact files stay immutable — this
    records facts learned AFTER publish (the live canary verdict and
    its observed window) on the version they are about. Returns the
    updated manifest."""
    v, vdir, manifest = resolve(root, name, version)
    manifest.update(extra)
    with atomic_write(os.path.join(vdir, MANIFEST_FILE)) as f:
        json.dump(manifest, f, indent=1, sort_keys=True)
    log.info("registry: annotated %s/%s with %s", name, v,
             sorted(extra))
    return manifest


def rollback(root: str, name: str,
             to: Optional[str] = None) -> str:
    """Point HEAD at `to` (default: the version preceding the current
    HEAD). The abandoned version dir stays — roll forward is another
    rollback."""
    current = head(root, name)
    if to is None:
        vs = versions(root, name)
        if current not in vs or vs.index(current) == 0:
            raise FileNotFoundError(
                f"registry rollback: {name} has no version before "
                f"HEAD ({current})")
        to = vs[vs.index(current) - 1]
    if not os.path.isfile(os.path.join(_model_dir(root, name), to,
                                       MANIFEST_FILE)):
        raise FileNotFoundError(
            f"registry rollback: {name}/{to} is not a complete version")
    with atomic_write(os.path.join(_model_dir(root, name),
                                   HEAD_FILE)) as f:
        f.write(to + "\n")
    log.info("registry: %s HEAD %s -> %s", name, current, to)
    return to


def gc(root: str, name: str, keep: Optional[int] = None) -> List[str]:
    """Delete all but the newest `keep` versions (default
    SHIFU_TPU_REGISTRY_KEEP); the HEAD version is always kept. Doomed
    dirs are renamed to dot-temps first so a kill mid-delete never
    leaves a half-deleted dir that still looks like a version."""
    keep = knob_int("SHIFU_TPU_REGISTRY_KEEP") if keep is None \
        else int(keep)
    keep = max(keep, 1)
    vs = versions(root, name)
    current = head(root, name)
    keep_set = set(vs[-keep:])
    if current:
        keep_set.add(current)
    removed = []
    for v in vs:
        if v in keep_set:
            continue
        vdir = os.path.join(_model_dir(root, name), v)
        doomed = os.path.join(_model_dir(root, name),
                              f".tmp.{os.getpid()}.gc.{v}")
        try:
            os.replace(vdir, doomed)
            shutil.rmtree(doomed, ignore_errors=True)
            removed.append(v)
        except OSError as e:
            log.warning("registry gc: could not remove %s/%s: %s",
                        name, v, e)
    if removed:
        log.info("registry: gc %s removed %s (kept %s)", name,
                 removed, sorted(keep_set))
    return removed


def ls(root: str) -> List[Dict[str, Any]]:
    """One summary row per registered model."""
    mroot = _models_root(root)
    if not os.path.isdir(mroot):
        return []
    rows = []
    for name in sorted(os.listdir(mroot)):
        if name.startswith("."):
            continue
        vs = versions(root, name)
        if not vs:
            continue
        current = head(root, name)
        row = {"name": name, "head": current, "versions": vs}
        try:
            _, _, manifest = resolve(root, name)
            row.update({
                "family": manifest.get("family"),
                "priority": manifest.get("priority"),
                "param_bytes": manifest.get("param_bytes"),
                "ladder": manifest.get("ladder"),
                "created": manifest.get("created"),
            })
        except (OSError, ValueError) as e:
            absorbed("registry.ls-manifest", e)
        rows.append(row)
    return rows
