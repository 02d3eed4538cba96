"""Model health plane — counterpart of `shifu_tpu/obs/health/`:

- `store`  — append-only, atomically-compacted per-workspace metric
  time-series (`tmp/metrics/metrics.jsonl`, lines interchangeable with
  the JAX package's) behind a small counter/gauge/event API; long-lived
  `serve` processes flush periodically and `eval` writes its guardrail
  metrics.
- `drift`  — rolling PSI/KS monitors: per-feature bin counts of each
  arriving window (binned on the device over the frozen training cuts)
  against the training bins in ColumnConfig.
- `slo`    — declarative `slo.json` guardrails evaluated over the
  store with hysteresis, emitting ok/warn/breach health events to
  alert sinks (log / file / webhook).
- `watch`  — the `watch --monitor-only` loop that ties the three
  together.

Everything here is OFF unless `SHIFU_TPU_METRICS=1`, and every write
or alert failure is absorbed — the health plane can never fail the step
it watches. The refresh and canary controllers (full `watch`) are
ROADMAP A7.4.
"""
