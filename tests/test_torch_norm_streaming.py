"""Port parity for the streaming (>RAM) `norm` —
`shifu_tpu_torch.processor.norm_streaming` against
`shifu_tpu.processor.norm_streaming.run_streaming` on the same synth raw
files and chunk rows (both read SHIFU_TPU_NORM_CHUNK_ROWS), plain
PyTorch on the CPU.

Tolerances: every `.npy` file of CleanedData and NormalizedData and both
meta.json equal to the bit (FLOAT16 as real f16), but a z-scored dense
block, within 1e-5 (the z-score is taken in f32 by XLA and by PyTorch,
as `tests/test_torch_norm.py` holds the resident norm). Rows equal the
resident norm's by raw index; the split is unbiased on label-sorted
input; `init → stats → norm → train#trainOnDisk` streams end to end
and trains the JAX package's trees. Each set comes from a private
`np.random.default_rng(seed)`.
"""

import json
import os

import numpy as np
import pytest

from tests.test_torch_stats import make_sets, run_jax, run_port


def assert_stream_layout(jax_root, port_root, zscored=True):
    """The streaming `.npy` layout and meta.json of the port against the
    JAX package's."""
    for sub in ("CleanedData", "NormalizedData"):
        jdir = os.path.join(jax_root, "tmp", sub)
        tdir = os.path.join(port_root, "tmp", sub)
        names = sorted(f for f in os.listdir(jdir) if f.endswith(".npy"))
        assert sorted(f for f in os.listdir(tdir)
                      if f.endswith(".npy")) == names
        assert {"dense.npy", "tags.npy", "weights.npy"} <= set(names)
        for name in names:
            want = np.load(os.path.join(jdir, name))
            got = np.load(os.path.join(tdir, name))
            assert got.dtype == want.dtype and got.shape == want.shape, name
            if sub == "NormalizedData" and name == "dense.npy" and zscored:
                np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
            else:
                np.testing.assert_array_equal(got, want, err_msg=name)
        with open(os.path.join(jdir, "meta.json")) as f:
            want_meta = f.read()
        with open(os.path.join(tdir, "meta.json")) as f:
            got_meta = f.read()
        assert got_meta == want_meta
        assert json.loads(got_meta)["validSplit"]["nTrain"] > 0


def _edit(norm="ZSCALE", precision="FLOAT32", valid=0.2, on_disk=True,
          sample=1.0):
    def edit(mc):
        mc["normalize"]["normType"] = norm
        mc["normalize"]["precisionType"] = precision
        mc["normalize"]["sampleRate"] = sample
        mc["train"]["validSetRate"] = valid
        mc["train"]["trainOnDisk"] = on_disk
    return edit


@pytest.mark.parametrize("norm,precision,sample", [
    ("ZSCALE", "FLOAT32", 1.0), ("WOE", "FLOAT16", 1.0),
    ("ZSCALE_INDEX", "FLOAT32", 0.7), ("WOE", "DOUBLE64", 1.0)])
def test_streaming_norm_layout_matches_jax(tmp_path, monkeypatch, norm,
                                           precision, sample):
    root, port = make_sets(tmp_path, 1200, n_rows=1500,
                           edit=_edit(norm, precision, sample=sample))
    run_jax(root, ("init", "stats"))
    run_port(port, ("init", "stats"))
    monkeypatch.setenv("SHIFU_TPU_NORM_CHUNK_ROWS", "256")
    run_jax(root, ("norm",))
    run_port(port, ("norm",))
    assert_stream_layout(root, port, zscored=norm.startswith("ZSCALE"))
    assert not os.path.exists(os.path.join(port, "tmp", "NormalizedData",
                                           "data.npz"))


def test_streaming_norm_rows_follow_the_resident_norm(tmp_path,
                                                      monkeypatch):
    """The streaming layout holds the resident norm's rows (CleanedData,
    raw order) with the hashed validation rows moved to the end, each
    region in raw order."""
    from shifu_tpu_torch.config.model_config import ModelConfig
    from shifu_tpu_torch.data.dataset import valid_tag_mask
    from shifu_tpu_torch.data.reader import read_raw_table
    from shifu_tpu_torch.processor.norm_streaming import _val_flags
    _, port = make_sets(tmp_path, 1201, n_rows=1200,
                        edit=_edit(on_disk=False, valid=0.25))
    run_port(port, ("init", "stats", "norm"))
    clean = os.path.join(port, "tmp", "CleanedData")
    resident = np.load(os.path.join(clean, "data.npz"))
    monkeypatch.setenv("SHIFU_TPU_NORM_CHUNK_ROWS", "333")
    run_port(port, ("norm",))
    mc = ModelConfig.load(port)
    raw = read_raw_table(mc)
    kept = valid_tag_mask(mc, raw)
    vf = _val_flags(12306, 0, len(raw), 0.25)[kept]
    for name, key in (("dense.npy", "dense"), ("tags.npy", "tags"),
                      ("weights.npy", "weights")):
        got = np.load(os.path.join(clean, name))
        want = np.concatenate([resident[key][~vf], resident[key][vf]])
        np.testing.assert_array_equal(got, want, err_msg=name)
    with open(os.path.join(clean, "meta.json")) as f:
        split = json.load(f)["validSplit"]
    assert (split["nTrain"], split["nVal"]) == (int((~vf).sum()),
                                                int(vf.sum()))


def test_streaming_norm_split_unbiased_on_sorted_input(tmp_path,
                                                       monkeypatch):
    """A label-sorted raw file still gives a validation region of both
    classes near the overall positive rate: the split hashes row
    indices, it does not take the file's tail."""
    _, port = make_sets(tmp_path, 1202, n_rows=3000,
                        edit=_edit(valid=0.2))
    path = os.path.join(port, "data", "part-00000")
    with open(path) as f:
        lines = f.readlines()
    body = sorted(lines[1:], key=lambda ln: ln.rsplit("|", 1)[-1])
    with open(path, "w") as f:
        f.writelines(lines[:1] + body)
    run_port(port, ("init", "stats"))
    monkeypatch.setenv("SHIFU_TPU_NORM_CHUNK_ROWS", "500")
    run_port(port, ("norm",))
    norm_dir = os.path.join(port, "tmp", "NormalizedData")
    tags = np.load(os.path.join(norm_dir, "tags.npy"))
    with open(os.path.join(norm_dir, "meta.json")) as f:
        n_train = json.load(f)["validSplit"]["nTrain"]
    val = tags[n_train:]
    assert 0.1 * len(tags) < len(val) < 0.3 * len(tags)
    assert abs(val.mean() - tags.mean()) < 0.06
    assert 0 < val.mean() < 1


@pytest.mark.parametrize("alg", ["RF", "GBT"])
def test_streaming_pipeline_trains_on_disk_like_jax(tmp_path, monkeypatch,
                                                    alg):
    """`init → stats → norm → train` with the stats and norm chunk knobs
    set and train#trainOnDisk: the streaming layouts equal, and the
    streaming tree trainers grow the JAX package's trees (RF tables
    exact; `test_torch_train_tree._close` for the trees)."""
    from shifu_tpu.models.spec import load_model as jload_model
    from shifu_tpu.processor import train as jtrain
    from shifu_tpu.processor.base import ProcessorContext
    from shifu_tpu_torch.models.spec import load_model
    from tests.test_torch_train_tree import _close, _exact
    from tests.test_torch_train_tree_streaming import STREAM_PARAMS
    root, port = make_sets(tmp_path, 1203, n_rows=1200, algorithm=alg,
                           train_params=STREAM_PARAMS[alg],
                           edit=_edit(norm="ZSCALE", valid=0.1))
    monkeypatch.setenv("SHIFU_TPU_STATS_CHUNK_ROWS", "400")
    monkeypatch.setenv("SHIFU_TPU_NORM_CHUNK_ROWS", "400")
    run_jax(root)
    run_port(port)
    assert_stream_layout(root, port)
    assert jtrain.run(ProcessorContext.load(root)) == 0
    run_port(port, ("train",))
    ext = "gbt" if alg == "GBT" else "rf"
    name = os.path.join("models", f"model0.{ext}")
    jkind, jmeta, jparams = jload_model(os.path.join(root, name))
    kind, meta, params = load_model(os.path.join(port, name))
    assert (kind, meta) == (jkind, jmeta)
    _exact(params["tables"], jparams["tables"])
    _close(params["trees"], jparams["trees"])
