"""The pipeline as a DAG — the port of `shifu_tpu/pipeline/`: a
dependency graph over the processor steps and a small scheduler that
runs every ready node at once.

- `nodes`     — the step registry (deps, device tag, manifest name a
                step) and the builders that turn a model set into Node
                lists (the pipeline, its per-segment stats siblings,
                multi-algorithm and grid-search fan-outs).
- `scheduler` — `run_dag`: timeshared admission slots or disjoint card
                leases, a per-node RESUME skip, a failure that poisons
                only its descendants, the first failure published as an
                abort marker, and the per-node report.

The scheduler changes *when* steps run, never *what* they compute: the
outputs equal a sequential walk of the same nodes to the bit.
"""

from shifu_tpu_torch.pipeline.nodes import (  # noqa: F401
    STEP_REGISTRY, StepSpec)
from shifu_tpu_torch.pipeline.scheduler import (  # noqa: F401
    DagError, Node, run_dag)
