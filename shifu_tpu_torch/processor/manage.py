"""`shifu save / switch / show` — model-set versioning, the port's copy
of `shifu_tpu/processor/manage.py` (host only).

Replaces `core/processor/ManageModelProcessor.java` (git-like branches
of a model set): a version snapshot = ModelConfig.json +
ColumnConfig.json + models/ copied into `.shifu-versions/<name>/`;
`switch` restores a snapshot into the working tree (saving the current
state under `master` first, like the reference's implicit branch).
"""

from __future__ import annotations

import logging
import os
import shutil
import time
from typing import List, Optional

from shifu_tpu_torch.processor.base import ProcessorContext

log = logging.getLogger("shifu_tpu_torch")

VERSIONS_DIR = ".shifu-versions"
_SNAPSHOT_ITEMS = ("ModelConfig.json", "ColumnConfig.json", "models")


def _vdir(ctx: ProcessorContext, name: str = "") -> str:
    return os.path.join(ctx.path_finder.root, VERSIONS_DIR, name)


def save(ctx: ProcessorContext, name: Optional[str] = None) -> int:
    """Snapshot the current model set under `name`
    (`shifu save [name]`; default timestamped)."""
    name = name or time.strftime("v%Y%m%d-%H%M%S")
    dst = _vdir(ctx, name)
    if os.path.exists(dst):
        raise ValueError(f"version {name!r} already exists")
    os.makedirs(dst, exist_ok=True)
    for item in _SNAPSHOT_ITEMS:
        src = os.path.join(ctx.path_finder.root, item)
        if os.path.isdir(src):
            shutil.copytree(src, os.path.join(dst, item))
        elif os.path.exists(src):
            shutil.copy2(src, os.path.join(dst, item))
    log.info("saved model-set version %r", name)
    return 0


def switch(ctx: ProcessorContext, name: str) -> int:
    """Restore snapshot `name` into the working tree
    (`shifu switch <name>`); the current state is auto-saved as
    'master' first (overwritten each switch)."""
    src = _vdir(ctx, name)
    if not os.path.isdir(src):
        raise ValueError(f"no saved version {name!r}; have {list_versions(ctx)}")
    master = _vdir(ctx, "master")
    if os.path.exists(master):
        shutil.rmtree(master)
    save(ctx, "master")  # auto-backup
    for item in _SNAPSHOT_ITEMS:
        dst = os.path.join(ctx.path_finder.root, item)
        s = os.path.join(src, item)
        if os.path.isdir(dst):
            shutil.rmtree(dst)
        elif os.path.exists(dst):
            os.remove(dst)
        if os.path.isdir(s):
            shutil.copytree(s, dst)
        elif os.path.exists(s):
            shutil.copy2(s, dst)
    log.info("switched model set to version %r (previous state saved as "
             "'master')", name)
    return 0


def list_versions(ctx: ProcessorContext) -> List[str]:
    base = _vdir(ctx)
    if not os.path.isdir(base):
        return []
    return sorted(os.listdir(base))


def show(ctx: ProcessorContext) -> int:
    """`shifu show` — list saved versions."""
    versions = list_versions(ctx)
    if not versions:
        log.info("no saved versions (use `shifu_tpu_torch save [name]`)")
    for v in versions:
        log.info("version: %s", v)
    return 0
