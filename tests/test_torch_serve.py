"""The port's serving slice as a whole, against the JAX package.

Model specs written by the JAX package are served by the JAX
`ScorerService` and by the port's (``device="cpu"``, the plain
PyTorch routes of both kernels); requests of 1/4/16/64 rows must get
the same scores — rtol 1e-5 / atol 1e-5 for the NN (f32 matmul sum
order), rtol 1e-6 / atol 1e-6 for the trees (integer routing; f32
leaf sums). The NN is served with `norm`, so the port takes its fused
normalize + first-layer route while the JAX CPU side scores the
normalized block. Also: `POST /score` answers the same, entry points
without a device raise when there is no card, and weights round-trip.
"""

import json
import os
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shifu_tpu.models import gbdt as jgbdt
from shifu_tpu.models import nn as jnn
from shifu_tpu.models.spec import load_model as jload_model
from shifu_tpu.models.spec import save_model as jsave_model
from shifu_tpu.ops.normalize import zscore as jzscore
from shifu_tpu.serve.service import ScorerService as JaxService
from shifu_tpu_torch import cli, weights
from shifu_tpu_torch.eval.scorer import Scorer
from shifu_tpu_torch.models.spec import load_model, save_model
from shifu_tpu_torch.serve.http import HttpFrontEnd
from shifu_tpu_torch.serve.service import ScorerService

SIZES = (1, 4, 16, 64)
NN_TOL = dict(rtol=1e-5, atol=1e-5)
TREE_TOL = dict(rtol=1e-6, atol=1e-6)
CUTOFF = 4.0


def _nn_set(root, seed=0, c=12):
    """A JAX-written NN spec, its norm params and raw/normalized rows."""
    rng = np.random.default_rng(seed)
    spec = jnn.MLPSpec(input_dim=c, hidden_dims=(10, 6),
                       activations=("relu", "tanh"))
    params = jax.tree.map(np.asarray,
                          jnn.init_params(spec, jax.random.PRNGKey(seed)))
    jsave_model(os.path.join(root, "model0.nn"), "nn",
                {"spec": {"input_dim": c, "hidden_dims": [10, 6],
                          "activations": ["relu", "tanh"]}}, params)
    raw = rng.normal(1.0, 2.0, (200, c)).astype(np.float32)
    raw[rng.random(raw.shape) < 0.1] = np.nan
    mean = rng.normal(1.0, 0.5, c).astype(np.float32)
    std = rng.uniform(0.5, 3.0, c).astype(np.float32)
    std[2] = 1e-7
    norm = {"mean": mean, "std": std, "cutoff": CUTOFF}
    dense = np.asarray(jzscore(jnp.asarray(raw), jnp.asarray(mean),
                               jnp.asarray(std), CUTOFF))
    return root, norm, raw, dense


def _tree_set(root, seed=1, n=400, cn=5, cc=2, vocab=6, n_bins=16):
    """JAX-built GBT (log loss) + RF specs over mixed raw columns."""
    rng = np.random.default_rng(seed)
    dense = rng.normal(0, 1, (n, cn)).astype(np.float32)
    dense[rng.random((n, cn)) < 0.08] = np.nan
    codes = rng.integers(0, vocab, (n, cc)).astype(np.int32)
    codes[rng.random((n, cc)) < 0.08] = -1
    num_cuts = np.nanquantile(dense, np.linspace(0, 1, n_bins)[1:-1],
                              axis=0).astype(np.float32)
    tables = jgbdt.make_bin_tables(
        num_cuts, [rng.permutation(vocab).astype(np.int32)
                   for _ in range(cc)], n_bins)
    y = ((np.nan_to_num(dense[:, 0]) + 0.4 * codes[:, 0]) > 0.5) \
        .astype(np.float32)
    bins = jgbdt.bin_dataset(tables, dense, codes, n_bins)
    for i, (kind, loss) in enumerate((("gbt", "log"), ("rf", "squared"))):
        cfg = jgbdt.TreeConfig(max_depth=3, n_bins=n_bins,
                               learning_rate=0.3, loss=loss)
        if kind == "gbt":
            trees, _ = jgbdt.build_gbt(cfg, bins, y, np.ones_like(y), 3)
        else:
            trees = jgbdt.build_rf(cfg, bins, y, np.ones_like(y), 3,
                                   "SQRT", 1.0, 3)
        meta = {"kind": kind,
                "treeConfig": {"max_depth": 3, "n_bins": n_bins,
                               "learning_rate": 0.3, "loss": loss}}
        jsave_model(os.path.join(root, f"model{i}.{kind}"), kind, meta,
                    {"trees": jax.tree.map(np.asarray, trees),
                     "tables": tables})
    return root, dense, codes


def _assert_same(got, want, tol):
    assert set(want) <= set(got)
    for k in want:
        np.testing.assert_allclose(np.asarray(got[k]), np.asarray(want[k]),
                                   **tol, err_msg=k)


def test_nn_with_norm_serves_like_jax(tmp_path):
    root, norm, raw, dense = _nn_set(str(tmp_path / "nn"))
    proto = {"dense": dense[:1], "raw_dense": raw[:1]}
    port = ScorerService(models_dir=root, norm=norm, max_delay=0.002,
                         device="cpu").start(proto=proto)
    ref = JaxService(models_dir=root, norm=norm, max_delay=0.002,
                     aot_compile=False).start(proto=proto)
    try:
        off = 0
        for n in SIZES:
            blk = {"dense": dense[off:off + n], "raw_dense": raw[off:off + n]}
            off += n
            _assert_same(port.submit(**blk), ref.submit(**blk), NN_TOL)
        assert port.stats()["batcher"]["requests"] == len(SIZES)
    finally:
        port.close()
        ref.close()


def test_trees_serve_like_jax_in_process_and_over_http(tmp_path):
    root, dense, codes = _tree_set(str(tmp_path / "trees"))
    proto = {"raw_dense": dense[:1], "raw_codes": codes[:1]}
    port = ScorerService(models_dir=root, max_delay=0.002,
                         device="cpu").start(proto=proto)
    ref = JaxService(models_dir=root, max_delay=0.002,
                     aot_compile=False).start(proto=proto)
    front = HttpFrontEnd(port, host="127.0.0.1", port=0).start()
    try:
        host, p = front.address
        off = 0
        for n in SIZES:
            blk = {"raw_dense": dense[off:off + n],
                   "raw_codes": codes[off:off + n]}
            off += n
            got = port.submit(**blk)
            _assert_same(got, ref.submit(**blk), TREE_TOL)
            body = json.dumps({k: np.where(np.isnan(v), None, v).tolist()
                               if v.dtype.kind == "f" else v.tolist()
                               for k, v in blk.items()}).encode()
            req = urllib.request.Request(
                f"http://{host}:{p}/score", data=body,
                headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=30) as resp:
                payload = json.loads(resp.read())
            _assert_same(payload["scores"], got, TREE_TOL)
            assert {"queue_s", "pad_s", "h2d_s", "device_s", "d2h_s",
                    "total_s"} <= set(payload["timing_ms"])
        with urllib.request.urlopen(f"http://{host}:{p}/healthz",
                                    timeout=10) as resp:
            assert json.loads(resp.read()) == {"ok": True}
        with urllib.request.urlopen(f"http://{host}:{p}/metrics",
                                    timeout=10) as resp:
            text = resp.read().decode()
        assert "shifu_serve_requests_total" in text
        assert 'shifu_serve_latency_ms{quantile="0.99"}' in text
    finally:
        front.close()
        port.close()
        ref.close()


def test_entry_points_without_device_raise_without_cuda(tmp_path,
                                                        monkeypatch):
    """The default device is the card; with none present the port
    raises instead of falling back to the CPU."""
    root, _, _, _ = _nn_set(str(tmp_path / "models"), c=4)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA"):
        Scorer.from_dir(root)
    with pytest.raises(RuntimeError, match="no CUDA"):
        ScorerService(models_dir=root)
    with pytest.raises(RuntimeError, match="no CUDA"):
        cli.main(["--dir", str(tmp_path), "serve", "--no-http",
                  "--duration-s", "0.1"])


def test_cli_serve_on_cpu(tmp_path, capsys):
    _nn_set(str(tmp_path / "models"), c=4)
    assert cli.main(["--dir", str(tmp_path), "serve", "--no-http",
                     "--duration-s", "0.05", "--device", "cpu"]) == 0
    stats = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert stats["models"] == ["nn"] and stats["device"] == "cpu"


def test_weights_round_trip(tmp_path):
    """JAX spec → port objects → numpy → port save → JAX load: every
    array comes back bit-equal, for both families."""
    nn_root, _, _, _ = _nn_set(str(tmp_path / "nn"))
    tree_root, _, _ = _tree_set(str(tmp_path / "trees"))
    for path in (os.path.join(nn_root, "model0.nn"),
                 os.path.join(tree_root, "model0.gbt"),
                 os.path.join(tree_root, "model1.rf")):
        kind, meta, params = jload_model(path)
        back = weights.from_torch(weights.to_torch(kind, meta, params,
                                                   "cpu"))
        out = str(tmp_path / ("rt_" + os.path.basename(path)))
        save_model(out, kind, meta, back)
        kind2, meta2, params2 = jload_model(out)
        assert (kind2, meta2) == (kind, meta)
        flat = jax.tree_util.tree_flatten_with_path
        a, _ = flat(params)
        b, _ = flat(params2)
        assert [p for p, _ in a] == [p for p, _ in b]
        for (_, x), (_, y) in zip(a, b):
            np.testing.assert_array_equal(x, y)
            assert x.dtype == y.dtype
        assert load_model(out)[0] == kind


@pytest.mark.parametrize("knob", [None, "16,4,64", "0,8", "junk"])
def test_bucket_padding_matches_jax(monkeypatch, knob):
    """Ladder parsing (warn-and-run on a malformed knob), bucket choice
    and repeat-last-row padding are the JAX package's."""
    from shifu_tpu.serve import aot as jaot
    from shifu_tpu_torch.serve import aot
    if knob is None:
        monkeypatch.delenv("SHIFU_TPU_SERVE_BUCKETS", raising=False)
    else:
        monkeypatch.setenv("SHIFU_TPU_SERVE_BUCKETS", knob)
    ladder = aot.bucket_ladder()
    assert ladder == jaot.bucket_ladder()
    for n in (1, 3, 8, 9, 64, 65, 512, 513, 1500):
        assert aot.bucket_for(n, ladder) == jaot.bucket_for(n, ladder)
    x = np.random.default_rng(3).normal(size=(5, 3)).astype(np.float32)
    np.testing.assert_array_equal(aot.pad_rows(x, 8), jaot.pad_rows(x, 8))
    out = aot.padded_call(lambda dense: {"s": dense.sum(axis=1)}, 5,
                          {"dense": x}, ladder=(8,))
    np.testing.assert_array_equal(out["s"], x.sum(axis=1))


def test_batcher_carries_overflow_in_fifo_order():
    """A co-rider that would overflow the top bucket opens the next
    batch; order stays FIFO."""
    from shifu_tpu_torch.serve.batcher import MicroBatcher
    seen = []

    def score(batch):
        seen.append([r.n for r in batch])
        for r in batch:
            r.resolve(r.n)

    b = MicroBatcher(score, max_rows=512, max_delay=0.2, depth=8)
    b.start()
    try:
        reqs = [b.submit({}, n) for n in (300, 300, 100)]
        assert [r.wait(10) for r in reqs] == [300, 300, 100]
    finally:
        b.close()
    assert seen == [[300], [300, 100]]
    assert b.stats()["requests"] == 3
