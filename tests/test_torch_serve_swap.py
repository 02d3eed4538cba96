"""The port's hot swap (`ScorerService.swap_params`) and the pieces of
its CUDA-graph serving that run on the CPU, against the JAX package.

The same JAX-written specs go to the JAX `ScorerService` and the port's
(``device="cpu"``): the structural gate refuses the same candidates
(another model count, kind, NN spec or leaf shape) and mutates nothing;
a swap that passes scores as a cold service of the new specs (bit for
bit on the port; within rtol/atol 1e-5 NN, 1e-6 trees of the JAX
service). `weights.refresh_` copies into the storage a graph reads; a
graph's body, run eagerly on CPU tensors, scores as `score_matrix`
does to the bit; a failed check through the live graphs restores the
incumbent. Every generator is a private `np.random.default_rng(seed)`.
"""

import os
import shutil

import jax
import numpy as np
import pytest
import torch

from shifu_tpu.models import nn as jnn
from shifu_tpu.models.spec import load_model as jload_model
from shifu_tpu.models.spec import save_model as jsave_model
from shifu_tpu.serve.service import ScorerService as JaxService
from shifu_tpu_torch import _build, weights
from shifu_tpu_torch.eval.scorer import score_matrix
from shifu_tpu_torch.models.spec import load_model
from shifu_tpu_torch.serve import aot
from shifu_tpu_torch.serve.service import ScorerService
from tests.test_torch_serve import CUTOFF, _nn_set, _tree_set

NN_TOL = dict(rtol=1e-5, atol=1e-5)
TREE_TOL = dict(rtol=1e-6, atol=1e-6)


def _nn_dir(root, seed, hidden=(10, 6), c=12, kind="nn"):
    spec = jnn.MLPSpec(input_dim=c, hidden_dims=hidden,
                       activations=("relu",) * len(hidden))
    params = jax.tree.map(np.asarray,
                          jnn.init_params(spec, jax.random.PRNGKey(seed)))
    jsave_model(os.path.join(root, f"model0.{kind}"), kind,
                {"spec": {"input_dim": c, "hidden_dims": list(hidden),
                          "activations": ["relu"] * len(hidden)}}, params)
    return root


def _dense(seed, n=37, c=12):
    return np.random.default_rng(seed).normal(0, 1, (n, c)) \
        .astype(np.float32)


def _pair(tmp_path, incumbent, proto):
    """The port's and the JAX package's services over `incumbent`."""
    port = ScorerService(models_dir=incumbent, max_delay=0.001,
                         device="cpu").start(proto=proto)
    ref = JaxService(models_dir=incumbent, max_delay=0.001).start(
        proto=proto)
    return port, ref


def _bad_candidate(tmp_path, case):
    d = str(tmp_path / f"bad-{case}")
    if case == "count":
        _nn_dir(d, 5)
        shutil.copy(os.path.join(d, "model0.nn"), os.path.join(d,
                                                               "model1.nn"))
    elif case == "kind":
        _nn_dir(d, 5, kind="lr")
    elif case == "spec":
        _nn_dir(d, 5, hidden=(10, 7))
    elif case == "shape":
        _nn_dir(d, 5, c=13)
    return d


@pytest.mark.parametrize("case", ["count", "kind", "spec", "shape"])
def test_swap_gate_refuses_like_jax_and_mutates_nothing(tmp_path, case):
    inc = _nn_dir(str(tmp_path / "inc"), 1)
    x = _dense(2)
    port, ref = _pair(tmp_path, inc, {"dense": x[:1]})
    try:
        before = port.submit(dense=x)
        models = list(port.scorer.models)
        w0 = models[0][2].w[0].detach().clone()
        bad = _bad_candidate(tmp_path, case)
        assert port.swap_params(bad) is False
        assert ref.swap_params(bad) is False
        assert port.swaps == ref.swaps == 0
        assert all(a is b for a, b in zip(port.scorer.models, models))
        assert torch.equal(models[0][2].w[0], w0)
        after = port.submit(dense=x)
        for k in before:
            assert np.array_equal(before[k], after[k])
    finally:
        port.close()
        ref.close()


def test_swap_on_cpu_scores_like_a_cold_service_nn(tmp_path):
    inc = _nn_dir(str(tmp_path / "inc"), 1)
    new = _nn_dir(str(tmp_path / "new"), 2)
    x = _dense(3)
    port, ref = _pair(tmp_path, inc, {"dense": x[:1]})
    cold = ScorerService(models_dir=new, device="cpu").start(
        proto={"dense": x[:1]})
    try:
        assert port.swap_params(new) and ref.swap_params(new)
        assert port.stats()["swaps"] == 1
        got, want = port.submit(dense=x), cold.submit(dense=x)
        for k in want:
            assert np.array_equal(got[k], want[k]), k
        jax_got = ref.submit(dense=x)
        for k in want:
            np.testing.assert_allclose(got[k], jax_got[k], **NN_TOL)
    finally:
        for s in (port, ref, cold):
            s.close()


def test_swap_on_cpu_scores_like_a_cold_service_trees(tmp_path):
    inc, dense, codes = _tree_set(str(tmp_path / "inc"), seed=1)
    new, _, _ = _tree_set(str(tmp_path / "new"), seed=4)
    blk = {"raw_dense": dense[:64], "raw_codes": codes[:64]}
    proto = {k: v[:1] for k, v in blk.items()}
    port, ref = _pair(tmp_path, inc, proto)
    cold = ScorerService(models_dir=new, device="cpu").start(proto=proto)
    try:
        before = port.submit(**blk)
        assert port.swap_params(new) and ref.swap_params(new)
        got, want = port.submit(**blk), cold.submit(**blk)
        for k in want:
            assert np.array_equal(got[k], want[k]), k
        assert not np.array_equal(got["mean"], before["mean"])
        jax_got = ref.submit(**blk)
        for k in want:
            np.testing.assert_allclose(got[k], jax_got[k], **TREE_TOL)
    finally:
        for s in (port, ref, cold):
            s.close()


@pytest.mark.parametrize("which", ["nn", "trees"])
def test_refresh_copies_into_the_storage_a_graph_reads(tmp_path, which):
    """`weights.refresh_` keeps every tensor's storage (a captured
    graph's pointers) and leaves packs equal to a fresh pack of the
    new weights."""
    if which == "nn":
        paths = [os.path.join(_nn_dir(str(tmp_path / f"d{s}"), s),
                              "model0.nn") for s in (1, 2)]
    else:
        paths = [os.path.join(_tree_set(str(tmp_path / f"d{s}"),
                                        seed=s)[0], "model0.gbt")
                 for s in (1, 4)]
    old, new = [weights.to_torch(*load_model(p), "cpu") for p in paths]
    if which == "nn":
        tensors = [*old.w, *old.b, old.w0_pack]
    else:
        tensors = [old.nodes, old.node_pack, old.cuts,
                   *old.trees.values()]
    ptrs = [t.data_ptr() for t in tensors]
    weights.refresh_(old, new)
    assert [t.data_ptr() for t in tensors] == ptrs
    if which == "nn":
        for a, b in zip([*old.w, *old.b, old.w0_pack],
                        [*new.w, *new.b, new.w0_pack]):
            assert torch.equal(a, b)
    else:
        assert torch.equal(old.nodes, new.nodes)
        assert torch.equal(old.node_pack, new.node_pack)
        assert torch.equal(old.cuts, new.cuts)
        for k in old.tables:
            assert np.array_equal(old.tables[k], new.tables[k])


def test_graph_bodies_score_like_score_matrix_on_cpu(tmp_path):
    """The body each (model, bucket) graph captures, run eagerly on CPU
    static buffers, scores the padded blocks as `score_matrix` does, to
    the bit: the NN over the raw block with `norm` (the K1 route), the
    NN over the dense block, and trees with categorical rows mapped on
    the host."""
    from shifu_tpu_torch.eval.scorer import Scorer
    from shifu_tpu_torch.models import gbdt
    nn_root, norm, raw, dense = _nn_set(str(tmp_path / "nn"))
    tr_root, tdense, codes = _tree_set(str(tmp_path / "tr"))
    norm_t = {"mean": torch.as_tensor(norm["mean"]),
              "std": torch.as_tensor(norm["std"]), "cutoff": CUTOFF}
    cases = [
        (Scorer.from_dir(nn_root, device="cpu"),
         {"raw_dense": raw[:8], "dense": dense[:8]}, norm_t, ("raw_dense",)),
        (Scorer.from_dir(nn_root, device="cpu"), {"dense": dense[:8]},
         None, ("dense",)),
        (Scorer.from_dir(tr_root, device="cpu"),
         {"raw_dense": tdense[:8], "raw_codes": codes[:8]}, None,
         ("raw_dense",)),
    ]
    for scorer, blocks, nrm, keys in cases:
        for bucket in (8, 64):
            padded = aot.pad_blocks(blocks, bucket)
            kw = aot._score_kwargs(padded)
            for i, (kind, meta, model) in enumerate(scorer.models):
                route = aot._graph_route(i, kind, meta, model, blocks, nrm)
                assert route is not None and route.keys == keys
                statics = {k: torch.tensor(padded[k]) for k in keys}
                if route.cat_key is not None:
                    statics[route.cat_key] = torch.as_tensor(
                        gbdt.cat_values(model.tables, padded["raw_codes"],
                                        model.cfg.n_bins))
                with torch.no_grad():
                    got = route.body(statics).numpy()
                want = score_matrix(kind, meta, model, **kw, norm=nrm)
                assert np.array_equal(got, want), (kind, bucket)



def test_graph_routes_skip_what_stays_eager(tmp_path):
    """wdl/mtl, and a tree model whose columns the request does not
    carry, get no graph route."""
    from shifu_tpu_torch.eval.scorer import Scorer
    tr_root, tdense, codes = _tree_set(str(tmp_path / "tr"))
    scorer = Scorer.from_dir(tr_root, device="cpu")
    kind, meta, model = scorer.models[0]
    assert aot._graph_route(0, kind, meta, model,
                            {"raw_dense": tdense[:1]}, None) is None
    assert aot._graph_route(0, "wdl", meta, model,
                            {"raw_dense": tdense[:1]}, None) is None


def test_capture_counts_launches_apart():
    """Inside `_build.capturing` a wrapper's launch goes to the capture's
    counter (the replays add it later); outside, to the module."""
    assert _build.captured("fused_score") is False
    with _build.capturing() as counts:
        assert _build.captured("fused_score")
        assert _build.captured("fused_trees")
        assert _build.captured("fused_score")
    assert dict(counts) == {"fused_score": 2, "fused_trees": 1}
    assert _build.captured("fused_trees") is False


class _FakeGraphs:
    """Stands in for `aot.ServingGraphs` on the CPU: the models in
    `graphed` have graphs, and the self-check through the live graphs
    passes or fails."""

    def __init__(self, models, graphed=(0,), passes=False):
        self.routes = {i: None for i in graphed}
        self.models = models
        self.passes = passes
        self.captures = 4
        self.graphs = {}

    def selfcheck(self, models=None):
        if not self.passes:
            raise AssertionError("graph deviates")

    def close(self):
        pass


def test_failed_check_restores_the_incumbent(tmp_path):
    inc = _nn_dir(str(tmp_path / "inc"), 1)
    new = _nn_dir(str(tmp_path / "new"), 2)
    x = _dense(3)
    svc = ScorerService(models_dir=inc, device="cpu").start(
        proto={"dense": x[:1]})
    try:
        before = svc.submit(dense=x)
        model = svc.scorer.models[0][2]
        w = [t.detach().clone() for t in (*model.w, *model.b,
                                          model.w0_pack)]
        svc._graphs = _FakeGraphs(svc.scorer.models)
        with pytest.raises(AssertionError, match="deviates"):
            svc.swap_params(new)
        svc._graphs = None
        assert svc.swaps == 0 and svc.scorer.models[0][2] is model
        for a, b in zip((*model.w, *model.b, model.w0_pack), w):
            assert torch.equal(a, b)
        after = svc.submit(dense=x)
        for k in before:
            assert np.array_equal(before[k], after[k])
    finally:
        svc.close()


def test_stats_carry_graph_and_swap_fields(tmp_path):
    inc = _nn_dir(str(tmp_path / "inc"), 1)
    svc = ScorerService(models_dir=inc, device="cpu").start()
    try:
        st = svc.stats()
        assert (st["graphs"], st["graph_captures"], st["swaps"]) == (0, 0, 0)
        assert st["priority"] == "high"
        assert st["rejected_by_class"] == {"high": 0, "low": 0}
    finally:
        svc.close()


def test_first_batch_warms_a_service_started_without_a_prototype(tmp_path):
    """A tree service has no default prototype: its first batch warms
    (and on the card captures) every bucket, then scores."""
    root, dense, codes = _tree_set(str(tmp_path / "tr"))
    svc = ScorerService(models_dir=root, device="cpu").start()
    cold = ScorerService(models_dir=root, device="cpu").start(
        proto={"raw_dense": dense[:1], "raw_codes": codes[:1]})
    try:
        assert svc.stats()["warmed_buckets"] == 0
        got = svc.submit(raw_dense=dense[:5], raw_codes=codes[:5])
        assert svc.stats()["warmed_buckets"] == len(svc.ladder)
        want = cold.submit(raw_dense=dense[:5], raw_codes=codes[:5])
        for k in want:
            assert np.array_equal(got[k], want[k])
    finally:
        svc.close()
        cold.close()


# ---------------------------------------------------------------------------
# the in-place copy refuses before it writes; a failed swap restores all
# ---------------------------------------------------------------------------

def _tensors(model):
    """Every tensor and host array `weights.refresh_` may write."""
    if isinstance(model, weights.TreeEnsemble):
        return [model.nodes, model.node_pack, model.cuts,
                *model.trees.values(), *model.tables.values()]
    return [*model.w, *model.b, model.w0_pack]


def _snapshot(model):
    return [t.clone() if isinstance(t, torch.Tensor) else t.copy()
            for t in _tensors(model)]


def _unchanged(model, snap):
    return all(torch.equal(a, b) if isinstance(a, torch.Tensor)
               else np.array_equal(a, b)
               for a, b in zip(_tensors(model), snap))


def _retuned(src, dst, **tree_config):
    """A copy of the tree set `src` whose treeConfig differs."""
    os.makedirs(dst, exist_ok=True)
    for name in sorted(os.listdir(src)):
        if name.startswith("model"):
            kind, meta, params = jload_model(os.path.join(src, name))
            meta = dict(meta, treeConfig=dict(meta["treeConfig"],
                                              **tree_config))
            jsave_model(os.path.join(dst, name), kind, meta, params)
    return dst


@pytest.mark.parametrize("case", ["nn_shape", "tree_rate", "tree_loss",
                                  "tree_bins", "kind"])
def test_refresh_refuses_before_it_copies(tmp_path, case):
    """A refresh the live storage cannot take raises before its first
    copy, so the model keeps every weight and pack it had."""
    if case == "nn_shape":
        a = os.path.join(_nn_dir(str(tmp_path / "a"), 1), "model0.nn")
        b = os.path.join(_nn_dir(str(tmp_path / "b"), 2, c=13), "model0.nn")
    else:
        src = _tree_set(str(tmp_path / "a"), seed=1)[0]
        a = os.path.join(src, "model0.gbt")
        if case == "tree_bins":
            b = os.path.join(_tree_set(str(tmp_path / "b"), seed=4,
                                       n_bins=8)[0], "model0.gbt")
        elif case == "kind":
            b = os.path.join(_nn_dir(str(tmp_path / "b"), 2), "model0.nn")
        else:
            change = {"tree_rate": {"learning_rate": 0.1},
                      "tree_loss": {"loss": "squared"}}[case]
            b = os.path.join(_retuned(src, str(tmp_path / "b"), **change),
                             "model0.gbt")
    old, new = [weights.to_torch(*load_model(p), "cpu") for p in (a, b)]
    snap = _snapshot(old)
    with pytest.raises(TypeError if case == "kind" else ValueError):
        weights.refresh_(old, new)
    assert _unchanged(old, snap)


@pytest.mark.parametrize("change", [{"learning_rate": 0.1},
                                    {"loss": "squared"}])
def test_swap_refuses_a_graphed_tree_with_other_statics(tmp_path, change):
    """A graph bakes in a tree ensemble's statics: a challenger that
    differs there is refused (False, nothing mutated) when the trees
    are graphed, and swaps like the JAX service's when they are not."""
    inc, dense, codes = _tree_set(str(tmp_path / "inc"), seed=1)
    new = _retuned(inc, str(tmp_path / "new"), **change)
    blk = {"raw_dense": dense[:16], "raw_codes": codes[:16]}
    proto = {k: v[:1] for k, v in blk.items()}
    port, ref = _pair(tmp_path, inc, proto)
    try:
        before = port.submit(**blk)
        models = list(port.scorer.models)
        snaps = [_snapshot(m) for _, _, m in models]
        port._graphs = _FakeGraphs(port.scorer.models, graphed=(0, 1),
                                   passes=True)
        assert port.swap_params(new) is False
        port._graphs = None
        assert port.swaps == 0
        assert all(a is b for a, b in zip(port.scorer.models, models))
        assert all(_unchanged(m, sn) for (_, _, m), sn in zip(models, snaps))
        after = port.submit(**blk)
        for k in before:
            assert np.array_equal(before[k], after[k])
        assert port.swap_params(new) is True
        assert ref.swap_params(new) is True
    finally:
        port.close()
        ref.close()


def test_failed_copy_partway_restores_every_model(tmp_path, monkeypatch):
    """The copy of the second graphed model fails after the first was
    copied: the swap raises and both models score as before."""
    inc, dense, codes = _tree_set(str(tmp_path / "inc"), seed=1)
    new, _, _ = _tree_set(str(tmp_path / "new"), seed=4)
    blk = {"raw_dense": dense[:16], "raw_codes": codes[:16]}
    svc = ScorerService(models_dir=inc, device="cpu").start(
        proto={k: v[:1] for k, v in blk.items()})
    real, calls = weights.refresh_, []

    def refresh_(model, fresh):
        calls.append(model)
        if len(calls) == 2:
            raise ValueError("copy failed")
        real(model, fresh)

    try:
        before = svc.submit(**blk)
        models = list(svc.scorer.models)
        snaps = [_snapshot(m) for _, _, m in models]
        svc._graphs = _FakeGraphs(svc.scorer.models, graphed=(0, 1),
                                  passes=True)
        monkeypatch.setattr(weights, "refresh_", refresh_)
        with pytest.raises(ValueError, match="copy failed"):
            svc.swap_params(new)
        monkeypatch.setattr(weights, "refresh_", real)
        svc._graphs = None
        assert len(calls) == 4      # two copies in, two restores
        assert svc.swaps == 0
        assert all(a is b for a, b in zip(svc.scorer.models, models))
        assert all(_unchanged(m, sn) for (_, _, m), sn in zip(models, snaps))
        after = svc.submit(**blk)
        for k in before:
            assert np.array_equal(before[k], after[k])
    finally:
        svc.close()


@pytest.mark.parametrize("which", ["nn", "trees"])
def test_graphed_swap_copies_in_place_and_scores_like_a_cold_service(
        tmp_path, which):
    """With the models graphed, a swap keeps the model objects (the
    storage the graphs read) and then scores as a cold service of the
    new specs, to the bit."""
    if which == "nn":
        inc = _nn_dir(str(tmp_path / "inc"), 1)
        new = _nn_dir(str(tmp_path / "new"), 2)
        blk = {"dense": _dense(3)}
    else:
        inc, dense, codes = _tree_set(str(tmp_path / "inc"), seed=1)
        new, _, _ = _tree_set(str(tmp_path / "new"), seed=4)
        blk = {"raw_dense": dense[:16], "raw_codes": codes[:16]}
    proto = {k: v[:1] for k, v in blk.items()}
    svc = ScorerService(models_dir=inc, device="cpu").start(proto=proto)
    cold = ScorerService(models_dir=new, device="cpu").start(proto=proto)
    try:
        models = [m for _, _, m in svc.scorer.models]
        graphed = tuple(range(len(models)))
        svc._graphs = _FakeGraphs(svc.scorer.models, graphed=graphed,
                                  passes=True)
        assert svc.swap_params(new) is True
        assert svc._graphs.models is svc.scorer.models
        svc._graphs = None
        assert all(m is n for m, (_, _, n) in zip(models,
                                                  svc.scorer.models))
        got, want = svc.submit(**blk), cold.submit(**blk)
        for k in want:
            assert np.array_equal(got[k], want[k]), k
    finally:
        svc.close()
        cold.close()


def test_warm_scores_and_selfcheck_take_a_model_subset(tmp_path,
                                                       monkeypatch):
    """`models=` warms and checks only the models listed, once a bucket
    for the warm-up."""
    from shifu_tpu_torch.eval import scorer as scorer_mod
    from shifu_tpu_torch.eval.scorer import Scorer
    root, dense, codes = _tree_set(str(tmp_path / "tr"))
    scorer = Scorer.from_dir(root, device="cpu")
    proto = {"raw_dense": dense[:1], "raw_codes": codes[:1]}
    real, seen = scorer_mod.score_matrix, []

    def score_matrix(kind, meta, model, *a, **kw):
        seen.append(model)
        return real(kind, meta, model, *a, **kw)

    monkeypatch.setattr(scorer_mod, "score_matrix", score_matrix)
    ladder = (1, 8, 64)
    assert aot.warm_scores(scorer, proto, ladder, models=[1]) == 3
    assert seen == [scorer.models[1][2]] * 3
    seen.clear()
    aot.selfcheck(scorer, proto, ladder, models=[1])
    assert seen == [scorer.models[1][2]]
    seen.clear()
    aot.selfcheck(scorer, proto, ladder, models=[])
    assert seen == []


def test_warm_up_leaves_the_graphed_models_to_their_capture(tmp_path,
                                                            monkeypatch):
    """On the card a graph's capture warms its model and the graph check
    covers it: the eager warm-up and check run only for the models no
    graph scores."""
    root, dense, codes = _tree_set(str(tmp_path / "tr"))
    svc = ScorerService(models_dir=root, device="cpu")
    built, warmed, checked = [], [], []

    class Graphs(_FakeGraphs):
        def __init__(self, scorer, proto, ladder, norm=None):
            super().__init__(scorer.models, graphed=(0,), passes=True)
            built.append(self)

        def capture_all(self):
            return 0

        def covers(self, bucket):
            return False

    monkeypatch.setattr(aot, "ServingGraphs", Graphs)
    monkeypatch.setattr(aot, "warm_scores",
                        lambda *a, models=None, **kw: warmed.append(models))
    monkeypatch.setattr(aot, "selfcheck",
                        lambda *a, models=None, **kw: checked.append(models))
    svc._graphs_enabled = True
    try:
        svc.start(proto={"raw_dense": dense[:1], "raw_codes": codes[:1]})
        assert len(built) == 1 and svc._graphs is built[0]
        assert warmed == checked == [[1]]
        assert svc.stats()["warmed_buckets"] == len(svc.ladder)
    finally:
        svc._graphs = None
        svc.close()
