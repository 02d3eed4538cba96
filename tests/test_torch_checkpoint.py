"""The port's training checkpoints (`train/checkpoint.py`) and resume,
mirroring the JAX package's `tests/test_checkpoint.py` and the
checkpoint drills of `tests/test_resilience.py`, on the CPU.

- a checkpointed run equals a straight one to the bit (full batch, and
  dropout with mini-batches: the batch order is sliced, the generator's
  state carries on); a run stopped at epoch 8 and resumed to 12 equals
  the straight 12 to the bit, and a SIGKILL at ``ckpt.saved:kill:2`` in
  a ``python -c`` subprocess resumes to the bit;
- a resumed port run, from the JAX package's initial weights (as
  `tests/test_torch_trainer.py` carries them across), within that
  file's 1e-5 relative of the JAX package's resumed run (no dropout);
- the store: round trips of the carry's structure (tuples, int32/bool
  trackers, a None and a generator), only the newest step kept, the
  fallback past a truncated `step_N.npz`, `max_step`, stale `.tmp`
  residue, async against sync saves (equal to the bit), the snapshot
  decoupled from later mutation, a writer error surfacing at the
  flush, `save_interrupt` flushing first, the generator's device-type
  refusal, the sidecar;
- the streaming NN, WDL and MTL resumed after a preemption equal to
  uninterrupted runs;
- the JAX package's `latest_step` / `load_sharding_meta` read the
  port's checkpoint directory, and both `ckpt` verbs print equal JSON.

A private `np.random.default_rng` each (C-ref-1)."""

import json
import logging
import os
import signal
import subprocess
import sys

import numpy as np
import pytest
import torch

from shifu_tpu_torch import resilience
from shifu_tpu_torch.config.model_config import ModelTrainConf as TConf
from shifu_tpu_torch.train import checkpoint as ckpt
from shifu_tpu_torch.train import trainer as ttrainer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NN = {"NumHiddenLayers": 1, "NumHiddenNodes": [6], "ActivationFunc":
      ["tanh"], "LearningRate": 0.1, "Propagation": "ADAM"}
DROPOUT = dict(NN, DropoutRate=0.2, MiniBatchRows=100)


@pytest.fixture(autouse=True)
def _fresh():
    ckpt.flush_saves(reraise=False)
    resilience.reset_faults()
    resilience.clear_preempt()
    yield
    ckpt.flush_saves(reraise=False)
    resilience.reset_faults()
    resilience.clear_preempt()


def _data(seed=5, n=400):
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1, (n, 4)).astype(np.float32)
    y = (x[:, 0] + x[:, 1] > 0).astype(np.float32)
    return x, y, rng.uniform(0.5, 2.0, n).astype(np.float32)


def _conf(epochs, params=NN, bags=2):
    c = TConf()
    c.params = dict(params)
    c.numTrainEpochs = epochs
    c.baggingNum = bags
    c.validSetRate = 0.2
    return c


def _bit_equal(got, want):
    np.testing.assert_array_equal(got.best_val, want.best_val)
    for pg, pw in zip(got.params_per_bag, want.params_per_bag):
        for lg, lw in zip(pg, pw):
            for k in lw:
                np.testing.assert_array_equal(lg[k], lw[k])


# ---------------------------------------------------------------------------
# the resident trainer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("params", [NN, DROPOUT], ids=["full", "dropout"])
def test_checkpointed_equals_straight_to_the_bit(tmp_path, params):
    x, y, w = _data()
    straight = ttrainer.train_nn(_conf(12, params), x, y, w, seed=7,
                                 device="cpu")
    ck = ttrainer.train_nn(_conf(12, params), x, y, w, seed=7, device="cpu",
                           checkpoint_dir=str(tmp_path / "ck"),
                           checkpoint_interval=5)
    _bit_equal(ck, straight)
    np.testing.assert_array_equal(ck.val_errors, straight.val_errors)
    np.testing.assert_array_equal(ck.train_errors, straight.train_errors)
    assert ckpt.latest_step(str(tmp_path / "ck")) == 12


@pytest.mark.parametrize("params", [NN, DROPOUT], ids=["full", "dropout"])
def test_resume_after_stop_equals_straight(tmp_path, params, caplog):
    """A run of 8 epochs, resumed with the budget of 12: the curves of
    the 4 epochs after the resume (as the JAX package returns them) and
    the models equal the straight run's; a rerun of the finished run
    returns at once with train errors of shape (B, 0)."""
    x, y, w = _data()
    d = str(tmp_path / "ck")
    ttrainer.train_nn(_conf(8, params), x, y, w, seed=7, device="cpu",
                      checkpoint_dir=d, checkpoint_interval=4)
    assert ckpt.latest_step(d) == 8
    with caplog.at_level(logging.INFO, logger="shifu_tpu_torch"):
        res = ttrainer.train_nn(_conf(12, params), x, y, w, seed=7,
                                device="cpu", checkpoint_dir=d,
                                checkpoint_interval=4)
    assert any("resumed at epoch 8" in r.getMessage() for r in caplog.records)
    straight = ttrainer.train_nn(_conf(12, params), x, y, w, seed=7,
                                 device="cpu")
    _bit_equal(res, straight)
    np.testing.assert_array_equal(res.val_errors, straight.val_errors[:, 8:])
    np.testing.assert_array_equal(res.best_epoch,
                                  np.argmin(straight.val_errors[:, 8:], 1))
    again = ttrainer.train_nn(_conf(12, params), x, y, w, seed=7,
                              device="cpu", checkpoint_dir=d,
                              checkpoint_interval=4)
    assert again.train_errors.shape == (2, 0)
    assert again.val_errors.shape == (2, 1)
    _bit_equal(again, straight)


_TRAIN_SCRIPT = """\
import logging
import sys
import numpy as np
from shifu_tpu_torch.config.model_config import ModelTrainConf
from shifu_tpu_torch.train.trainer import train_nn
logging.basicConfig(level=logging.INFO)
rng = np.random.default_rng(5)
x = rng.normal(0, 1, (400, 4)).astype(np.float32)
y = (x[:, 0] + x[:, 1] > 0).astype(np.float32)
w = rng.uniform(0.5, 2.0, 400).astype(np.float32)
conf = ModelTrainConf()
conf.params = {"NumHiddenLayers": 1, "NumHiddenNodes": [6],
               "ActivationFunc": ["tanh"], "LearningRate": 0.1,
               "Propagation": "ADAM", "DropoutRate": 0.2,
               "MiniBatchRows": 100}
conf.numTrainEpochs, conf.baggingNum, conf.validSetRate = 12, 2, 0.2
res = train_nn(conf, x, y, w, seed=7, device="cpu",
               checkpoint_dir=sys.argv[1], checkpoint_interval=4)
np.savez(sys.argv[2], *[v for p in res.params_per_bag for layer in p
                        for v in layer.values()])
"""


def test_sigkill_after_second_save_resumes_to_the_bit(tmp_path):
    """SIGKILL right after the 2nd checkpoint lands (the background
    writer's ``ckpt.saved``), a rerun resumes at epoch 8 and ends on
    the straight run's parameters, dropout and mini-batches included."""
    ckdir, out = str(tmp_path / "ck"), str(tmp_path / "out.npz")
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    env.pop("SHIFU_TPU_FAULT", None)
    killed = subprocess.run(
        [sys.executable, "-c", _TRAIN_SCRIPT, ckdir, out],
        env={**env, "SHIFU_TPU_FAULT": "ckpt.saved:kill:2",
             "SHIFU_TPU_CKPT_ASYNC": "1"},
        cwd=REPO, timeout=600, capture_output=True, text=True)
    assert killed.returncode == -signal.SIGKILL, killed.stderr[-2000:]
    assert ckpt.latest_step(ckdir) == 8
    assert not [n for n in os.listdir(ckdir) if ".tmp" in n]
    resumed = subprocess.run([sys.executable, "-c", _TRAIN_SCRIPT, ckdir,
                              out], env=env, cwd=REPO, timeout=600,
                             capture_output=True, text=True)
    assert resumed.returncode == 0, resumed.stderr[-2000:]
    assert "resumed at epoch 8" in resumed.stderr
    x, y, w = _data()
    straight = ttrainer.train_nn(_conf(12, DROPOUT), x, y, w, seed=7,
                                 device="cpu")
    want = [v for p in straight.params_per_bag for layer in p
            for v in layer.values()]
    with np.load(out) as z:
        got = [z[f"arr_{i}"] for i in range(len(z.files))]
    assert len(got) == len(want)
    for g, wv in zip(got, want):
        np.testing.assert_array_equal(g, wv)


def test_resumed_run_matches_the_jax_resumed_run(tmp_path):
    """The port resumed at epoch 6 of 10, from the JAX package's
    initial weights, within 1e-5 relative of the JAX package's run
    resumed alike (the JAX package writes its own checkpoints)."""
    from tests.test_torch_trainer import _confs, _rel, jax_init
    from shifu_tpu.train import trainer as jtrainer
    from shifu_tpu_torch.models import nn as tnn
    x, y, w = _data(9)
    spec = tnn.MLPSpec.from_train_params(NN, 4)
    init = jax_init(spec, 7, 2)
    runs = {}
    for side in ("jax", "port"):
        d = str(tmp_path / side)
        for epochs in (6, 10):
            jconf, tconf = _confs(NN, epochs=epochs, bags=2)
            if side == "jax":
                res = jtrainer.train_nn(jconf, x, y, w, seed=7,
                                        checkpoint_dir=d,
                                        checkpoint_interval=3)
            else:
                res = ttrainer.train_nn(tconf, x, y, w, seed=7, spec=spec,
                                        init_params=init, device="cpu",
                                        checkpoint_dir=d,
                                        checkpoint_interval=3)
        runs[side] = res
    got, want = runs["port"], runs["jax"]
    assert got.val_errors.shape == want.val_errors.shape == (2, 4)
    _rel(got.val_errors, want.val_errors, 1e-5, "val errors")
    _rel(got.train_errors, want.train_errors, 1e-5, "train errors")
    np.testing.assert_array_equal(got.best_epoch, np.asarray(want.best_epoch))
    for pg, pw in zip(got.params_per_bag, want.params_per_bag):
        for lg, lw in zip(pg, pw):
            for k in lw:
                _rel(lg[k], np.asarray(lw[k]), 1e-5, k)


# ---------------------------------------------------------------------------
# the store
# ---------------------------------------------------------------------------

def _carry(scale=1.0, gen=True):
    params = [{"w": torch.arange(6, dtype=torch.float32).reshape(2, 3)
               * scale, "b": torch.zeros(2, 3)}]
    g = torch.Generator().manual_seed(11) if gen else None
    return (params, {"count": torch.tensor([3, 4], dtype=torch.int32),
                     "mu": [torch.ones(2, 3) * scale]},
            {"params": params, "val": torch.tensor([0.5, np.inf])},
            {"bad": torch.zeros(2, dtype=torch.int32),
             "stopped": torch.tensor([False, True])}, g)


def test_state_roundtrip_keeps_the_carry_structure(tmp_path):
    d = str(tmp_path / "s")
    state = _carry(2.0)
    ckpt.save_state(d, 5, state)
    assert ckpt.latest_step(d) == 5
    got = ckpt.restore_state(d, 5, _carry(0.0))
    assert isinstance(got, tuple) and isinstance(got[0], list)
    for a, b in zip(ckpt._leaves(got)[:-1], ckpt._leaves(state)[:-1]):
        assert a[0] == b[0]
        assert a[1].dtype == b[1].dtype
        torch.testing.assert_close(a[1], b[1], rtol=0, atol=0)
    assert torch.equal(got[4].get_state(), state[4].get_state())
    assert torch.equal(torch.rand(3, generator=got[4]),
                       torch.rand(3, generator=state[4]))
    nogen = ckpt.restore_state(d, 5, _carry(0.0, gen=False))
    assert nogen[4] is None
    # numpy state, as the JAX package's tests write it
    npstate = ({"w": np.arange(6, dtype=np.float32).reshape(2, 3)},
               {"count": np.asarray([3], np.int64)})
    ckpt.save_state(d, 6, npstate)
    back = ckpt.restore_state(d, 6, npstate)
    np.testing.assert_array_equal(back[0]["w"], npstate[0]["w"])
    assert back[1]["count"].dtype == np.int64


def test_only_latest_checkpoint_kept(tmp_path):
    d = str(tmp_path / "s")
    ckpt.save_state(d, 1, _carry())
    ckpt.save_state(d, 2, _carry())
    assert sorted(os.listdir(d)) == ["step_2.npz", "step_2.sharding.json"]


def test_restore_latest_falls_back_past_truncated_npz(tmp_path, caplog):
    d = str(tmp_path / "ck")
    ckpt.save_state(d, 10, _carry(3.0))
    with open(os.path.join(d, "step_20.npz"), "wb") as f:
        f.write(b"PK\x03\x04 truncated")
    assert ckpt.latest_step(d) == 20
    with caplog.at_level(logging.WARNING, logger="shifu_tpu_torch"):
        step, got = ckpt.restore_latest(d, _carry(0.0))
    assert step == 10
    torch.testing.assert_close(got[0][0]["w"], _carry(3.0)[0][0]["w"])
    assert any("unreadable" in r.getMessage() for r in caplog.records)
    # a step of another shape is unreadable too
    ckpt.save_state(str(tmp_path / "s2"), 4, {"w": torch.zeros(3)})
    assert ckpt.restore_latest(str(tmp_path / "s2"),
                               {"w": torch.zeros(4)}) is None


def test_restore_latest_none_when_all_corrupt(tmp_path, caplog):
    d = str(tmp_path / "ck")
    os.makedirs(d)
    with open(os.path.join(d, "step_5.npz"), "wb") as f:
        f.write(b"")
    with caplog.at_level(logging.WARNING, logger="shifu_tpu_torch"):
        assert ckpt.restore_latest(d, {"w": torch.zeros(2)}) is None
    assert any("starting from scratch" in r.getMessage()
               for r in caplog.records)
    assert ckpt.restore_latest(str(tmp_path / "nowhere"), {}) is None


def test_restore_latest_respects_max_step(tmp_path):
    d = str(tmp_path / "ck")
    ckpt.save_state(d, 50, {"w": torch.ones(3)})
    assert ckpt.restore_latest(d, {"w": torch.ones(3)}, max_step=30) is None
    assert ckpt.restore_latest(d, {"w": torch.ones(3)}, max_step=50)[0] == 50


def test_stale_tmp_leftovers_ignored_and_swept(tmp_path):
    d = str(tmp_path / "ck")
    ckpt.save_state(d, 3, {"w": torch.ones(2)})
    os.makedirs(os.path.join(d, "step_9.tmp"))
    with open(os.path.join(d, ".tmp.123.x"), "w") as f:
        f.write("junk")
    assert ckpt.latest_step(d) == 3
    assert ckpt.restore_latest(d, {"w": torch.ones(2)})[0] == 3
    ckpt.save_state(d, 4, {"w": torch.ones(2)})
    assert sorted(os.listdir(d)) == ["step_4.npz", "step_4.sharding.json"]


def test_async_vs_sync_saves_are_bit_identical(tmp_path, monkeypatch):
    state = _carry(2.5)
    da, ds = str(tmp_path / "async"), str(tmp_path / "sync")
    monkeypatch.setenv("SHIFU_TPU_CKPT_ASYNC", "1")
    ckpt.save_checkpoint(da, 4, state)
    ckpt.flush_saves()
    monkeypatch.setenv("SHIFU_TPU_CKPT_ASYNC", "0")
    ckpt.save_checkpoint(ds, 4, state)
    with np.load(os.path.join(da, "step_4.npz")) as za, \
            np.load(os.path.join(ds, "step_4.npz")) as zs:
        assert za.files == zs.files
        for k in za.files:
            assert za[k].dtype == zs[k].dtype
            np.testing.assert_array_equal(za[k], zs[k])
    with open(os.path.join(da, "step_4.sharding.json")) as fa, \
            open(os.path.join(ds, "step_4.sharding.json")) as fs:
        assert fa.read() == fs.read()


def test_async_snapshot_decouples_from_mutation(tmp_path, monkeypatch):
    """The snapshot is a copy even of a CPU tensor (whose ``.cpu()`` is
    the same storage): an in-place change after the save returns does
    not reach the background write."""
    monkeypatch.setenv("SHIFU_TPU_CKPT_ASYNC", "1")
    d = str(tmp_path / "ck")
    state = {"w": torch.arange(8, dtype=torch.float32),
             "h": np.arange(4, dtype=np.float32)}
    ckpt.save_checkpoint(d, 1, state)
    state["w"].mul_(-1.0)
    state["h"] *= -1.0
    ckpt.flush_saves()
    got = ckpt.restore_state(d, 1, state)
    torch.testing.assert_close(got["w"], torch.arange(8, dtype=torch.float32))
    np.testing.assert_array_equal(got["h"], np.arange(4, dtype=np.float32))


def test_background_write_error_surfaces_at_flush(tmp_path, monkeypatch):
    monkeypatch.setenv("SHIFU_TPU_CKPT_ASYNC", "1")
    monkeypatch.setenv("SHIFU_TPU_FAULT", "ckpt.publish:oserror:1")
    d = str(tmp_path / "ck")
    ckpt.save_checkpoint(d, 1, _carry())
    with pytest.raises(OSError, match="injected oserror at ckpt.publish"):
        ckpt.flush_saves()
    ckpt.flush_saves()
    monkeypatch.delenv("SHIFU_TPU_FAULT")
    ckpt.save_checkpoint(d, 2, _carry())
    ckpt.flush_saves()
    assert ckpt.latest_step(d) == 2


def test_save_interrupt_flushes_inflight_write_first(tmp_path, monkeypatch,
                                                     caplog):
    monkeypatch.setenv("SHIFU_TPU_CKPT_ASYNC", "1")
    orig = ckpt._publish
    calls = []

    def flaky(ckpt_dir, step, snap, meta=None):
        calls.append(step)
        if len(calls) == 1:
            raise OSError("simulated background write failure")
        return orig(ckpt_dir, step, snap, meta)

    monkeypatch.setattr(ckpt, "_publish", flaky)
    d = str(tmp_path / "ck")
    ckpt.save_checkpoint(d, 4, _carry(4.0))
    with caplog.at_level(logging.WARNING, logger="shifu_tpu_torch"):
        ckpt.save_interrupt(d, 5, _carry(5.0))
    assert any("background checkpoint write failed" in r.getMessage()
               for r in caplog.records)
    assert calls == [4, 5] and ckpt.latest_step(d) == 5


def test_generator_of_another_device_type_is_refused(tmp_path):
    """A CUDA generator's state (a Philox seed and offset) cannot become
    a CPU generator's: the restore raises instead of drawing fresh
    numbers, and `restore_latest` does not take it for an unreadable
    step. Without a generator the same checkpoint restores."""
    d = str(tmp_path / "ck")
    snap = {"w": torch.ones(2),
            "gen": ckpt._GenSnap(torch.zeros(16, dtype=torch.uint8),
                                 "cuda")}
    ckpt._publish(d, 3, snap)
    like = {"w": torch.zeros(2), "gen": torch.Generator()}
    with pytest.raises(ckpt.GeneratorDeviceMismatch, match="'cuda'"):
        ckpt.restore_state(d, 3, like)
    with pytest.raises(ValueError, match="cannot restore onto 'cpu'"):
        ckpt.restore_latest(d, like)
    step, got = ckpt.restore_latest(d, {"w": torch.zeros(2), "gen": None})
    assert step == 3 and got["gen"] is None
    torch.testing.assert_close(got["w"], torch.ones(2))


def test_sidecar_and_resharded_restore(tmp_path, caplog):
    d = str(tmp_path / "ck")
    state = {"t": torch.ones(2), "host": np.zeros(3, np.float32)}
    ckpt.save_state(d, 2, state)
    meta = ckpt.load_sharding_meta(d, 2)
    assert meta == {"step": 2, "version": 1, "leaves": {"['t']": []},
                    "mesh": {"axes": ["data", "model"], "shape": [1, 1],
                             "devices": 1, "hosts": 1},
                    "rules": {"rows": "data", "hidden": "model",
                              "cat": "model", "task": "model"}}
    from shifu_tpu.parallel import mesh as jmesh
    assert meta["rules"] == jmesh._DEFAULT_RULES
    assert ckpt.sharding_meta({"h": np.zeros(2)}) is None
    step, got = ckpt.restore_resharded(d, state, device="cpu")
    assert step == 2 and isinstance(got["host"], np.ndarray)
    wide = dict(meta, mesh={"axes": ["data", "model"], "shape": [4, 2],
                            "devices": 8, "hosts": 1})
    with caplog.at_level(logging.INFO, logger="shifu_tpu_torch"):
        placed = ckpt.place_resharded(got, wide, "cpu")
    assert any("4x2 mesh restores replicated" in r.getMessage()
               for r in caplog.records)
    torch.testing.assert_close(placed["t"], torch.ones(2))
    with open(os.path.join(d, "step_2.sharding.json"), "w") as f:
        f.write("{corrupt")
    assert ckpt.load_sharding_meta(d, 2) is None
    assert ckpt.restore_resharded(d, state)[0] == 2


def test_jax_reads_the_port_directory_and_ckpt_verbs_agree(tmp_path,
                                                           capsys):
    from shifu_tpu.cli import main as jmain
    from shifu_tpu.train import checkpoint as jckpt
    from shifu_tpu_torch import cli
    from tests.synth import make_model_set
    root = make_model_set(tmp_path / "ms", np.random.default_rng(31),
                          n_rows=60)
    d = os.path.join(root, "tmp", "checkpoints", "bag0")
    ckpt.save_state(d, 7, _carry())
    assert jckpt.latest_step(d) == 7
    assert jckpt.load_sharding_meta(d, 7) == ckpt.load_sharding_meta(d, 7)
    capsys.readouterr()
    assert cli.main(["--dir", root, "ckpt"]) == 0
    got = capsys.readouterr().out
    assert jmain(["--dir", root, "ckpt"]) == 0
    want = capsys.readouterr().out
    assert got == want
    rec = json.loads(got)["checkpoints"]
    assert rec[0]["latestStep"] == 7
    assert rec[0]["sharding"]["deviceLeaves"] == len(
        ckpt.sharding_meta(_carry())["leaves"])


# ---------------------------------------------------------------------------
# the streaming trainers
# ---------------------------------------------------------------------------

def _stream_case(kind):
    """(run(conf, **kw), conf) of a streaming NN, WDL or MTL on in-memory
    chunks."""
    from shifu_tpu_torch.models import mtl as tmtl
    from shifu_tpu_torch.models import wdl as twdl
    from shifu_tpu_torch.train import streaming as tstream
    rng = np.random.default_rng({"NN": 41, "WDL": 42, "MTL": 43}[kind])
    n = 480
    if kind == "NN":
        x = rng.normal(0, 1, (n, 5)).astype(np.float32)
        y = (x[:, 0] - 0.5 * x[:, 1] > 0).astype(np.float32)
        w = rng.uniform(0.5, 2.0, n).astype(np.float32)
        conf = _conf(7, dict(NN, DropoutRate=0.1))

        def run(c, **kw):
            return tstream.train_nn_streaming(
                c, lambda a, b: (x[a:b], y[a:b], w[a:b]), n, 5, seed=3,
                chunk_rows=100, n_val=80, device="cpu", **kw)
    elif kind == "WDL":
        dense = rng.normal(0, 1, (n, 3)).astype(np.float32)
        idx = rng.integers(0, 5, (n, 2)).astype(np.int32)
        y = (idx[:, 0] >= 2).astype(np.float32)
        spec = twdl.WDLSpec(dense_dim=3, n_cat=2, vocab_size=6, embed_size=3,
                            hidden_dims=(5,), activations=("relu",))
        conf = _conf(7, {"Propagation": "ADAM", "LearningRate": 0.05})

        def run(c, **kw):
            return tstream.train_wdl_streaming(
                c, lambda a, b: (dense[a:b], idx[a:b], y[a:b],
                                 np.ones(b - a, np.float32)), n, spec,
                seed=4, chunk_rows=100, device="cpu", **kw)
    else:
        x = rng.normal(0, 1, (n, 4)).astype(np.float32)
        y = np.stack([x[:, 0] > 0, x[:, 1] > 0], 1).astype(np.float32)
        y[rng.random(n) < 0.2, 1] = np.nan
        spec = tmtl.MTLSpec(input_dim=4, n_tasks=2, hidden_dims=(5,),
                            activations=("tanh",))
        conf = _conf(7, {"Propagation": "ADAM", "LearningRate": 0.05})

        def run(c, **kw):
            return tstream.train_streaming_core(
                c, lambda a, b: (x[a:b], y[a:b], np.ones(b - a, np.float32)),
                n, seed=5, chunk_rows=100,
                init_fn=lambda g: tmtl.init_params(spec, g),
                loss_fn=lambda p, i, w_, g: tmtl.loss_fn(spec, p, *i, w_),
                metric_sum_fn=lambda p, i, w_: tmtl.error_sum(spec, p, *i,
                                                              w_),
                metric_mass_fn=lambda i, w_: tmtl.labelled_mass(i[1], w_),
                spec=spec, device="cpu", **kw)
    return run, conf


@pytest.mark.parametrize("kind", ["NN", "WDL", "MTL"])
def test_streaming_resumed_after_preempt_equals_straight(tmp_path,
                                                         monkeypatch,
                                                         caplog, kind):
    """A preemption noticed after the 2nd epoch's save raises
    `Preempted` with the state saved; the rerun resumes there and ends
    on the uninterrupted run's models and curves, to the bit. The saves
    are synchronous, so `ckpt.saved` fires on the training thread and
    the preemption lands at that epoch's boundary (an async write's
    fires on the writer thread, and is seen at the next boundary)."""
    from shifu_tpu_torch.train import streaming as tstream
    run, conf = _stream_case(kind)
    straight = run(conf)
    d = str(tmp_path / "ck")
    monkeypatch.setenv("SHIFU_TPU_CKPT_ASYNC", "0")
    monkeypatch.setenv("SHIFU_TPU_FAULT", "ckpt.saved:preempt:2")
    with pytest.raises(resilience.Preempted, match="after epoch 2/"):
        run(conf, checkpoint_dir=d, checkpoint_interval=1)
    monkeypatch.delenv("SHIFU_TPU_FAULT")
    step = ckpt.latest_step(d)
    assert step == 2
    with caplog.at_level(logging.INFO, logger="shifu_tpu_torch"):
        res = run(conf, checkpoint_dir=d, checkpoint_interval=1)
    assert any(f"resumed from checkpoint at epoch {step}" in r.getMessage()
               for r in caplog.records)
    np.testing.assert_array_equal(res.val_errors, straight.val_errors)
    np.testing.assert_array_equal(res.train_errors, straight.train_errors)
    np.testing.assert_array_equal(res.best_epoch, straight.best_epoch)
    for pg, pw in zip(res.params_per_bag, straight.params_per_bag):
        for a, b in zip(ttrainer._flat(pg), ttrainer._flat(pw)):
            np.testing.assert_array_equal(a, b)
    assert os.path.isdir(d)
    tstream.cleanup_checkpoints(d)
    assert not os.path.exists(d)


def test_streaming_off_interval_preempt_saves_and_all_stopped_shortcut(
        tmp_path, monkeypatch):
    """A preemption between interval saves takes `save_interrupt`'s
    step; a resumed run whose bags had all stopped returns the restored
    best without another epoch."""
    run, conf = _stream_case("NN")
    d = str(tmp_path / "ck")
    monkeypatch.setenv("SHIFU_TPU_FAULT", "pipeline.fetch:preempt:3")
    with pytest.raises(resilience.Preempted, match="after epoch 1/"):
        run(conf, checkpoint_dir=d, checkpoint_interval=5)
    monkeypatch.delenv("SHIFU_TPU_FAULT")
    assert ckpt.latest_step(d) == 1
    stopper = _conf(7, dict(NN, DropoutRate=0.1))
    stopper.convergenceThreshold = 10.0       # every bag stops at once
    d2 = str(tmp_path / "ck2")
    first = run(stopper, checkpoint_dir=d2, checkpoint_interval=1)
    assert first.val_errors.shape[1] == 1
    again = run(stopper, checkpoint_dir=d2, checkpoint_interval=1)
    np.testing.assert_array_equal(again.val_errors, first.val_errors)
    np.testing.assert_array_equal(again.best_val, first.best_val)
