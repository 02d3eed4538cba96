"""The segment siblings of the port's `stats` (`stats -base-only`, `stats
-seg K`, `stats -seg-merge`, the pipeline DAG's per-segment nodes):
their ColumnConfig.json equals the port's inline `stats` byte for byte,
through the CLI in process and through `run_dag` as subprocesses, and
the JAX package's segmented `stats` under the field tolerances
`tests/test_torch_stats.py` holds `stats` to; `norm` depends on the
merge.
"""

import json
import os
import shutil

import pytest

from tests.test_torch_stats import (assert_column_configs, make_sets,
                                    run_jax, run_port)

SEGMENTS = ["num_1 > 0", "num_0 > 0 and cat_0 == 'aa'"]


def _seg_sets(tmp_path, seed):
    root, port = make_sets(tmp_path, seed, n_rows=1200,
                           seg_expressions=SEGMENTS)
    # make_sets repoints the port copy's files, the segment file too
    twin = str(tmp_path / "twin")
    shutil.copytree(port, twin)
    path = os.path.join(twin, "ModelConfig.json")
    with open(path) as f:
        text = f.read()
    with open(path, "w") as f:
        f.write(text.replace(port, twin))
    return root, port, twin


def _siblings(twin, capsys=None):
    from shifu_tpu_torch import cli
    lines = []
    for flags in (["-base-only"], ["-seg", "1"], ["-seg", "2"],
                  ["-seg-merge"]):
        assert cli.main(["--dir", twin, "stats", *flags, "--device",
                         "cpu"]) == 0
        if capsys is not None:
            lines.append(json.loads(capsys.readouterr().out
                                    .strip().splitlines()[-1]))
    return lines


def _bytes(root):
    with open(os.path.join(root, "ColumnConfig.json"), "rb") as f:
        return f.read()


def test_siblings_equal_inline_stats_and_the_jax_package(tmp_path, capsys):
    root, port, twin = _seg_sets(tmp_path, 501)
    run_jax(root, ("init", "stats"))
    run_port(port, ("init", "stats"))
    run_port(twin, ("init",))
    capsys.readouterr()
    lines = _siblings(twin, capsys)
    assert [ln["step"] for ln in lines] == [
        "stats -base-only", "stats -seg 1", "stats -seg 2",
        "stats -seg-merge"]
    assert [ln["device"] for ln in lines] == ["cpu"] * 3 + ["host"]
    assert 0 < lines[1]["rows"] < lines[0]["rows"]
    assert _bytes(twin) == _bytes(port)
    ccs = json.loads(_bytes(twin))
    assert sum(1 for c in ccs if c.get("segment")) == 2 * 11
    assert_column_configs(os.path.join(root, "ColumnConfig.json"),
                          os.path.join(twin, "ColumnConfig.json"))
    partials = sorted(os.listdir(os.path.join(twin, "tmp", "stats_seg")))
    assert partials == ["seg_1.json", "seg_2.json"]
    assert sorted(os.listdir(os.path.join(twin, "tmp", "manifests"))) == [
        "stats.json", "stats.seg.1.json", "stats.seg.2.json",
        "stats.segmerge.json"]


def test_base_only_writes_the_base_columns(tmp_path):
    _, port, twin = _seg_sets(tmp_path, 502)
    run_port(port, ("init", "stats"))
    run_port(twin, ("init",))
    from shifu_tpu_torch import cli
    assert cli.main(["--dir", twin, "stats", "-base-only", "--device",
                     "cpu"]) == 0
    base = json.loads(_bytes(twin))
    inline = json.loads(_bytes(port))
    assert len(base) == 11 and not any(c.get("segment") for c in base)
    assert base == inline[:11]


def test_segment_index_and_missing_partial_raise(tmp_path):
    from shifu_tpu_torch import cli
    _, _, twin = _seg_sets(tmp_path, 503)
    run_port(twin, ("init",))
    assert cli.main(["--dir", twin, "stats", "-base-only", "--device",
                     "cpu"]) == 0
    for k in ("0", "3"):
        with pytest.raises(ValueError, match="out of range"):
            cli.main(["--dir", twin, "stats", "-seg", k, "--device",
                      "cpu"])
    assert cli.main(["--dir", twin, "stats", "-seg", "1", "--device",
                     "cpu"]) == 0
    with pytest.raises(FileNotFoundError, match="stats -seg 2"):
        cli.main(["--dir", twin, "stats", "-seg-merge"])


def test_resume_skips_a_completed_segment(tmp_path, monkeypatch, caplog):
    """With SHIFU_TPU_RESUME=1 a segment whose manifest matches is
    skipped before the merge; after it, the merge has rewritten
    ColumnConfig.json, an input of every manifest's fingerprint (as in
    the JAX package), so the segment runs again, to the same partial."""
    import logging

    from shifu_tpu_torch import cli
    _, _, twin = _seg_sets(tmp_path, 504)
    run_port(twin, ("init",))
    argv = ["--dir", twin, "stats", "-seg", "2", "--device", "cpu"]
    for flags in (["-base-only"], ["-seg", "1"], ["-seg", "2"]):
        assert cli.main(["--dir", twin, "stats", *flags, "--device",
                         "cpu"]) == 0
    partial = os.path.join(twin, "tmp", "stats_seg", "seg_2.json")
    with open(partial, "rb") as f:
        before = f.read()
    monkeypatch.setenv("SHIFU_TPU_RESUME", "1")
    with caplog.at_level(logging.INFO, logger="shifu_tpu_torch"):
        assert cli.main(argv) == 0
        assert cli.main(["--dir", twin, "stats", "-seg-merge"]) == 0
        assert cli.main(argv) == 0
    msgs = [r.getMessage().split()[2] for r in caplog.records
            if r.getMessage().startswith("step stats.seg.2:")]
    assert msgs == ["complete", "stale/mismatched"]
    with open(partial, "rb") as f:
        assert f.read() == before


def test_dag_siblings_as_subprocesses_equal_inline(tmp_path, monkeypatch):
    """init → stats -base-only → (seg 1 ∥ seg 2) → seg-merge scheduled by
    `run_dag` as port processes writes the inline ColumnConfig.json, and
    `norm` waits on the merge."""
    from shifu_tpu_torch.pipeline import nodes
    from shifu_tpu_torch.pipeline.scheduler import run_dag
    from tests.test_torch_pipeline_dag import SUBPROCESS_S, within_timeout
    monkeypatch.setenv("SHIFU_TPU_DAG_SLICE", "0")
    _, port, twin = _seg_sets(tmp_path, 505)
    run_port(port, ("init", "stats"))
    plan = nodes.pipeline_nodes(twin, resume=False, device="cpu")
    by = {n.name: n for n in plan}
    assert by["stats"].deps == ("init",)
    assert by["stats.seg.1"].deps == by["stats.seg.2"].deps == ("stats",)
    assert by["stats.segmerge"].deps == ("stats.seg.1", "stats.seg.2")
    assert by["stats.segmerge"].device is False
    assert by["norm"].deps == ("stats.segmerge",)
    head = [n for n in plan if n.name.startswith(("init", "stats"))]
    rep = within_timeout(lambda: run_dag(head, root=twin, label="seg"),
                         SUBPROCESS_S)
    assert {r["node"]: r["state"] for r in rep["nodes"]} == {
        "init": "done", "stats": "done", "stats.seg.1": "done",
        "stats.seg.2": "done", "stats.segmerge": "done"}
    assert rep["max_concurrent"] == 2
    assert _bytes(twin) == _bytes(port)
    log_dir = os.path.join(twin, "tmp", "dag_logs")
    assert sorted(os.listdir(log_dir)) == [
        "init.log", "stats.log", "stats.seg.1.log", "stats.seg.2.log",
        "stats.segmerge.log"]


def test_cli_flags_are_the_jax_packages():
    """`stats` takes the JAX package's -seg, -seg-merge and -base-only
    flags (and the port's --device)."""
    from shifu_tpu.cli import build_parser as jparser
    from shifu_tpu_torch.cli import build_parser as pparser
    for argv in (["stats", "-seg", "2"], ["stats", "--seg-merge"],
                 ["stats", "-base-only"]):
        j, p = jparser().parse_args(argv), pparser().parse_args(argv)
        for k in ("seg", "seg_merge", "base_only"):
            assert getattr(p, k) == getattr(j, k), (argv, k)
