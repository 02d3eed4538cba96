"""Versioned model registry — immutable version dirs + atomic HEAD
(counterpart of `shifu_tpu/registry/`).

The promotion seam the fleet's hot swap rides: publishes
are crash-atomic (write-tmp-then-rename, `registry.publish` fault
site), readers always see a complete version, and rollback is one
HEAD pointer commit.
"""

from shifu_tpu_torch.registry.registry import (  # noqa: F401
    HEAD_FILE,
    MANIFEST_FILE,
    annotate,
    gc,
    head,
    ls,
    publish,
    read_manifest,
    resolve,
    rollback,
    versions,
)
