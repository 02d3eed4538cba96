"""The port's `version` and `knobs` verbs (`shifu_tpu/cli.py:661-695`)
over its own knob registry (`shifu_tpu_torch/config/environment.py`):
every port knob is one of the JAX package's, with the same type and
default, and the verbs print what the JAX package's print for them."""

import pytest

from shifu_tpu_torch import cli


def test_version_prints_the_package_version(capsys):
    import shifu_tpu_torch
    assert cli.main(["version"]) == 0
    assert capsys.readouterr().out == \
        f"shifu-tpu-torch {shifu_tpu_torch.__version__}\n"


def test_registry_agrees_with_the_jax_package():
    from shifu_tpu.config.environment import KNOBS as JKNOBS
    from shifu_tpu_torch.config.environment import KNOBS
    assert {"SHIFU_TPU_PREFETCH_DEPTH", "SHIFU_TPU_PREFETCH_WORKERS",
            "SHIFU_TPU_ANALYSIS_MAX_ROWS", "SHIFU_TPU_STATS_CHUNK_ROWS",
            "SHIFU_TPU_NORM_CHUNK_ROWS", "SHIFU_TPU_EVAL_CHUNK_ROWS",
            "SHIFU_TPU_ANALYSIS_CHUNK_ROWS", "SHIFU_TPU_METRICS",
            "SHIFU_TPU_METRICS_FLUSH_S", "SHIFU_TPU_METRICS_ROLLUP",
            "SHIFU_TPU_SLO_FILE", "SHIFU_TPU_ALERT_WEBHOOK",
            "SHIFU_TPU_ALERT_WEBHOOK_TIMEOUT_S", "SHIFU_TPU_DRIFT_THRESHOLD",
            "SHIFU_TPU_WATCH_INTERVAL_S", "SHIFU_TPU_REGISTRY_KEEP",
            "SHIFU_TPU_FLEET_HBM_MB", "SHIFU_TPU_FLEET_SHED_WINDOW",
            "SHIFU_TPU_FLEET_SLO_P99_MS", "SHIFU_TPU_FAULT"} <= set(KNOBS)
    for name, k in KNOBS.items():
        j = JKNOBS[name]
        assert (k.type, k.default) == (j.type, j.default), name


CLOSED_LOOP_KNOBS = (
    "SHIFU_TPU_REFRESH_WINDOW_ROWS", "SHIFU_TPU_REFRESH_TOLERANCE",
    "SHIFU_TPU_REFRESH_COOLDOWN_S", "SHIFU_TPU_INGEST_SEGMENT_ROWS",
    "SHIFU_TPU_INGEST_SEGMENT_AGE_S", "SHIFU_TPU_INGEST_WINDOW_ROWS",
    "SHIFU_TPU_SHADOW_PCT", "SHIFU_TPU_SHADOW_QUEUE", "SHIFU_TPU_CANARY_PCT",
    "SHIFU_TPU_CANARY_MIN_REQUESTS", "SHIFU_TPU_CANARY_WINDOW_S",
    "SHIFU_TPU_CANARY_PSI_MAX", "SHIFU_TPU_CANARY_P99_FACTOR",
    "SHIFU_TPU_FLEET_REFRESH_BUDGET")


@pytest.mark.parametrize("name", CLOSED_LOOP_KNOBS)
def test_closed_loop_knobs_match_the_jax_defaults(name, monkeypatch):
    """The row log's, the refresh and canary controllers' and the fleet
    drift watch's knobs: declared with the JAX package's type and
    default, and read alike when set (and when malformed)."""
    from shifu_tpu.config import environment as jenv
    from shifu_tpu_torch.config import environment as penv
    k, j = penv.KNOBS[name], jenv.KNOBS[name]
    assert (k.type, k.default) == (j.type, j.default)
    read = {"int": "knob_int", "float": "knob_float"}[k.type]
    monkeypatch.delenv(name, raising=False)
    assert getattr(penv, read)(name) == getattr(jenv, read)(name) == k.default
    for raw in ("3", "0.25", "nonsense"):
        monkeypatch.setenv(name, raw)
        assert getattr(penv, read)(name) == getattr(jenv, read)(name)


DAG_KNOBS = ("SHIFU_TPU_DAG_WORKERS", "SHIFU_TPU_DAG_SLICE",
             "SHIFU_TPU_DAG_DEVICES")


@pytest.mark.parametrize("name", DAG_KNOBS)
def test_dag_knobs_match_the_jax_package(name, monkeypatch):
    """The pipeline DAG's admission and lease knobs: declared with the
    JAX package's type and default, and read alike when set (and when
    malformed)."""
    from shifu_tpu.config import environment as jenv
    from shifu_tpu_torch.config import environment as penv
    k, j = penv.KNOBS[name], jenv.KNOBS[name]
    assert (k.type, k.default) == (j.type, j.default)
    read = {"int": "knob_int", "str": "knob_str"}[k.type]
    monkeypatch.delenv(name, raising=False)
    assert getattr(penv, read)(name) == getattr(jenv, read)(name) == k.default
    for raw in ("3", "0", "1,2", "auto", "nonsense"):
        monkeypatch.setenv(name, raw)
        assert getattr(penv, read)(name) == getattr(jenv, read)(name)


def test_mesh_and_compile_cache_knobs_stay_out():
    """The mesh's knobs wait for the mesh that reads them (ROADMAP
    A8.3); the port has no XLA compile cache."""
    from shifu_tpu_torch.config.environment import KNOBS
    assert not {"SHIFU_TPU_MESH_DEVICES", "SHIFU_TPU_COMPILE_CACHE_DIR",
                "SHIFU_TPU_DEVICE_SLICE", "SHIFU_TPU_DAG_DEMAND_CAP"} \
        & set(KNOBS)


def test_bench_refresh_knob_stays_out():
    from shifu_tpu_torch.config.environment import KNOBS
    assert "SHIFU_TPU_BENCH_REFRESH" not in KNOBS


def test_knobs_table(capsys, monkeypatch):
    from shifu_tpu_torch.config.environment import KNOBS
    monkeypatch.setenv("SHIFU_TPU_PREFETCH_DEPTH", "5")
    assert cli.main(["knobs"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].split() == ["knob", "type", "default", "current", "doc"]
    rows = {ln.split()[0]: ln.split() for ln in lines[1:]}
    assert sorted(rows) == sorted(KNOBS)
    assert rows["SHIFU_TPU_PREFETCH_DEPTH"][1:4] == ["int", "2", "5"]
    assert rows["SHIFU_TPU_STATS_CHUNK_ROWS"][1:4] == ["int", "-", "-"]
    assert cli.main(["knobs", "--all"]) == 0
    assert capsys.readouterr().out.splitlines() == lines


@pytest.mark.parametrize("name", ["SHIFU_TPU_ANALYSIS_MAX_ROWS",
                                  "SHIFU_TPU_SERVE_BUCKETS",
                                  "SHIFU_TPU_FLEET_HBM_MB",
                                  "SHIFU_TPU_METRICS_FLUSH_S"])
def test_knobs_markdown_matches_the_jax_rows(capsys, name):
    from shifu_tpu.config.environment import knobs_markdown
    assert cli.main(["knobs", "--markdown"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[:2] == ["| Knob | Type | Default | Doc |", "|---|---|---|---|"]
    want = [ln for ln in knobs_markdown().splitlines()
            if ln.startswith(f"| `{name}` |")]
    got = [ln for ln in out if ln.startswith(f"| `{name}` |")]
    assert len(got) == len(want) == 1
    # name, type and default; the docs may say what the port does
    assert got[0].split(" | ")[:3] == want[0].split(" | ")[:3]


CHECKPOINT_KNOBS = ("SHIFU_TPU_CKPT_ASYNC", "SHIFU_TPU_MAX_RESTARTS",
                    "SHIFU_TPU_RESUME")


@pytest.mark.parametrize("name", CHECKPOINT_KNOBS)
def test_checkpoint_knobs_match_the_jax_defaults(name, monkeypatch):
    """The checkpoint writer's, the restart and the resume knobs:
    the JAX package's type, default and doc, read alike when set (and
    when malformed)."""
    from shifu_tpu.config import environment as jenv
    from shifu_tpu_torch.config import environment as penv
    k, j = penv.KNOBS[name], jenv.KNOBS[name]
    assert (k.type, k.default, k.doc) == (j.type, j.default, j.doc)
    read = {"int": "knob_int", "flag": "knob_bool",
            "str": "knob_str"}[k.type]
    monkeypatch.delenv(name, raising=False)
    assert getattr(penv, read)(name) == getattr(jenv, read)(name)
    for raw in ("0", "1", "3", "nonsense"):
        monkeypatch.setenv(name, raw)
        assert getattr(penv, read)(name) == getattr(jenv, read)(name)


TRACE_KNOBS = ("SHIFU_TPU_TRACE", "SHIFU_TPU_TRACE_BUF",
               "SHIFU_TPU_TRACE_DIR")


@pytest.mark.parametrize("name", TRACE_KNOBS)
def test_trace_knobs_match_the_jax_package(name, monkeypatch):
    """The span tracer's switch, ring size and shared workspace: the JAX
    package's type, default and doc, read alike when set (and when
    malformed)."""
    from shifu_tpu.config import environment as jenv
    from shifu_tpu_torch.config import environment as penv
    k, j = penv.KNOBS[name], jenv.KNOBS[name]
    assert (k.type, k.default, k.doc) == (j.type, j.default, j.doc)
    read = {"flag": "knob_bool", "int": "knob_int", "str": "knob_str"}[k.type]
    monkeypatch.delenv(name, raising=False)
    assert getattr(penv, read)(name) == getattr(jenv, read)(name)
    for raw in ("1", "0", "8", "tmp/trace/x", "nonsense"):
        monkeypatch.setenv(name, raw)
        assert getattr(penv, read)(name) == getattr(jenv, read)(name)
