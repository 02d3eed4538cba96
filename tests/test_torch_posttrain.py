"""Port parity for `posttrain` and its sensitivity pass.

The JAX-trained synth sets of `tests/test_torch_eval.py` (GBT, RF, and
the NN over a ZSCALE set) are copied twice; the JAX package's
`posttrain` runs on one copy and the port's `posttrain --device cpu` on
the other: featureimportance.csv lists the same columns with equal
values for the trees and within 1e-5 relative for the NN (the JAX
package `vmap`s every ablation at once, the port runs them a chunk of
columns at a time), binAvgScore within 1e-6 relative, every other
ColumnConfig field equal. Chunked (SHIFU_TPU_ANALYSIS_CHUNK_ROWS)
equals resident: the merges are sums (for the NN, to f32 precision: a
row's score may round an ulp apart in another batch shape).
`_sensitivity_kernel` itself is held against the JAX kernel with chunks
forced small.
"""

import json
import os

import numpy as np
import pytest
import torch

import chip_smoke as cs
from tests.test_torch_eval import copy_set, jax_ctx, port, sets  # noqa: F401

IMP_RTOL = {"GBT": 0.0, "RF": 0.0, "NN": 1e-5}


@pytest.mark.parametrize("alg", ["GBT", "RF", "NN"])
def test_posttrain_matches_jax(sets, tmp_path, capsys, alg):  # noqa: F811
    from shifu_tpu.processor import posttrain as jpost
    root = sets(alg)
    want = copy_set(root, tmp_path / "jax")
    got = copy_set(root, tmp_path / "port")
    assert jpost.run(jax_ctx(want)) == 0
    line = port(got, "posttrain", capsys=capsys)
    assert line["step"] == "posttrain" and line["device"] == "cpu"
    assert line["rows"] == 800
    assert 0 < line["read_seconds"] <= line["seconds"]
    out = cs.compare_posttrain(got, want, IMP_RTOL[alg], 1e-6)
    print(f"{alg}: {out}")
    with open(os.path.join(got, "ColumnConfig.json")) as f:
        filled = [c for c in json.load(f)
                  if c["columnBinning"].get("binAvgScore")]
    assert len(filled) == (6 if alg == "NN" else 8)   # NN: no categoricals


@pytest.mark.parametrize("alg", ["RF", "NN"])
def test_chunked_posttrain_equals_resident(sets, tmp_path,  # noqa: F811
                                           monkeypatch, alg):
    root = sets(alg)
    resident = copy_set(root, tmp_path / "resident")
    chunked = copy_set(root, tmp_path / "chunked")
    port(resident, "posttrain")
    monkeypatch.setenv("SHIFU_TPU_ANALYSIS_CHUNK_ROWS", "97")
    port(chunked, "posttrain")
    # trees score a row the same in any batch; the NN's f32 GEMMs may
    # round a row's score an ulp apart in a 97-row batch and an 800-row
    # one, so its sums agree to f32 precision
    out = cs.compare_posttrain(chunked, resident,
                               0.0 if alg == "RF" else 1e-6,
                               1e-12 if alg == "RF" else 1e-7)
    print(f"{alg} chunked vs resident: {out}")


@pytest.mark.parametrize("chunk_bytes", [None, 5 * 60 * 23 * 4])
def test_sensitivity_kernel_matches_jax(chunk_bytes):
    """Chunks of 5 columns (of 23), or all at once, against the JAX
    package's vmapped kernel; `n_real` as there."""
    import jax
    import jax.numpy as jnp
    from shifu_tpu.models import nn as jnn
    from shifu_tpu.processor.varselect import _sensitivity_kernel as jsens
    from shifu_tpu_torch import weights
    from shifu_tpu_torch.processor.varselect import _sensitivity_kernel
    rng = np.random.default_rng(11)
    c, n = 23, 60
    spec = {"input_dim": c, "hidden_dims": [16, 8],
            "activations": ["tanh", "relu"]}
    params = [{"w": rng.normal(0, 0.3, (a, b)).astype(np.float32),
               "b": rng.normal(0, 0.1, b).astype(np.float32)}
              for a, b in ((c, 16), (16, 8), (8, 1))]
    x = rng.normal(0, 1, (n, c)).astype(np.float32)
    jspec = jnn.MLPSpec(input_dim=c, hidden_dims=(16, 8),
                        activations=("tanh", "relu"))
    jp = jax.tree.map(jnp.asarray, params)
    jx = jnp.asarray(x)
    want = np.asarray(jsens(jspec, jp, jx, jnn.forward(jspec, jp, jx),
                            n_real=40))
    model = weights.to_torch("nn", {"spec": spec}, params, "cpu")
    tx = torch.as_tensor(x)
    kw = {} if chunk_bytes is None else {"chunk_bytes": chunk_bytes}
    got = _sensitivity_kernel(model, tx, model(tx), n_real=40, **kw).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-9)
