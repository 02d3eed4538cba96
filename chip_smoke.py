"""Chip smoke test of the PyTorch/CUDA port (`shifu_tpu_torch`) on one card.

    python3 chip_smoke.py

Phases, each fatal on failure (the exit code is then non-zero and no
result line is printed):

1. the card's name, count and power limit; build every kernel from
   `shifu_tpu_torch/csrc/` (one `nvcc` per source, all at once);
2. K1 `fused_score` against its plain PyTorch version at 512×600→512 and
   at an eval-sized 65,536×600→512, with NaNs, outliers and a tiny-std
   column (rtol 1e-5 / atol 1e-5);
3. K2 `fused_trees` against its plain version at R = 512 and
   R = 1,048,576 on the HIGGS GBT shape (28 columns, 20 trees, depth 6,
   64 bins, log loss) with NaN and ±inf values: landing leaves exact,
   scores within 1e-6;
4. the main path: model sets written with the port's `save_model` from a
   seed (NN 600→512→256→1 served with `norm`; GBT + RF of the HIGGS
   shape), two `ScorerService`s on the card behind `HttpFrontEnd`,
   requests of 1/4/16/64/512 rows in process and over `POST /score`,
   every answer held against the same service on the CPU; the kernels'
   launch counters are zeroed just before and must have risen;
5. per kernel, CUDA-event times of the wrapper call, its plain version
   and (K1) one `torch.matmul` over the z-scored input, the kernel's own
   device time from `torch.profiler`, and the bound; plus request
   p50/p95/p99 and the mean per-stage split of both services over a
   closed loop of 1,000 requests per size, and the device's idle share
   over a profiled window of 200 more;
6. K3 `level_hist` and K4 `level_hist_fused` against their plain
   versions at R = 2,000,000, C = 28, B = 64 for S = 1 and 32, with
   dump-slot rows and NaN/±inf values: integer grads exact, real ones
   within 1e-5·Σ|grad| per slot;
7. K5 `best_splits` against its plain version at N = 1, 32 and 640 on
   integer-valued histograms with a planted tie and an all-masked node:
   feature, bin and default_left exact;
8. the training main path: model sets of 28 numeric columns and
   262,144 rows written with the port's own config writers, trained by
   `python -m shifu_tpu_torch --dir <set> train` on the card and with
   `--device cpu` (RF 10 trees and one-round squared-loss GBT
   bit-exact; 10-tree log-loss GBT, also through K4 with
   SHIFU_TPU_HIST_FUSED=1, within 1e-4 relative train log-loss and 1e-3
   AUC); each card run reports its kernels' launches, which must be
   non-zero; the port's `serve` then scores the card-trained GBT;
9. training times at the HIGGS widths (28 columns, depth 6, 64 bins,
   log loss, lr 0.2): per kernel at the main path's shapes (events,
   profiler, plain, bound; K3 also `torch.bincount`), 2,000,000 rows ×
   10 trees end to end with one profiled tree split by kernel and the
   device's idle share, and 11,000,000 rows × 20 trees when the
   projected time fits half the limit.

The last lines are the per-kernel launch line, the kernel JSON line,
the card's name and power limit, and the result object.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import tempfile
import time
import urllib.request

import numpy as np

MEM_BW = 3.35e12      # H100 SXM HBM3 bytes/s (data sheet)
F32_PEAK = 67e12      # H100 SXM f32 FLOP/s outside the tensor cores

NN_IN, NN_HIDDEN = 600, (512, 256)        # bench.py:90-92
GBT_COLS, GBT_TREES, GBT_DEPTH, GBT_BINS = 28, 20, 6, 64  # bench.py:171-174
CUTOFF = 4.0
SIZES = (1, 4, 16, 64, 512)
STREAM = 1000          # closed-loop requests per size: ≥ 10 beyond p99
IDLE_WINDOW = 200      # profiled closed-loop requests per size


# ---------------------------------------------------------------------------
# Inputs and models made from a seed
# ---------------------------------------------------------------------------

def norm_params(rng, c=NN_IN):
    mean = rng.normal(0.5, 1.0, c).astype(np.float32)
    std = rng.uniform(0.5, 2.0, c).astype(np.float32)
    std[7] = 1e-7                            # tiny std → z exactly 0
    return mean, std


def raw_rows(rng, n, mean, std):
    """Raw NN input rows around the norm params, with NaN cells, a NaN
    row and outliers beyond the clamp."""
    x = (mean + std * rng.normal(0, 1.5, (n, len(mean)))).astype(np.float32)
    x[rng.random(x.shape) < 0.05] = np.nan
    x[0, :10] = 1e6
    if n > 1:
        x[1] = np.nan
    return x


def nn_params(rng):
    """Xavier-uniform weights, small random biases."""
    dims = [NN_IN, *NN_HIDDEN, 1]
    out = []
    for fan_in, fan_out in zip(dims[:-1], dims[1:]):
        lim = math.sqrt(6.0 / (fan_in + fan_out))
        out.append({"w": rng.uniform(-lim, lim, (fan_in, fan_out))
                    .astype(np.float32),
                    "b": rng.normal(0, 0.01, fan_out).astype(np.float32)})
    return out


def tree_rows(rng, n, c=GBT_COLS):
    """HIGGS-like raw numeric rows with NaN and ±inf values."""
    x = rng.normal(0, 1, (n, c)).astype(np.float32)
    x[rng.random(x.shape) < 0.05] = np.nan
    x[rng.random(x.shape) < 0.002] = np.inf
    x[rng.random(x.shape) < 0.002] = -np.inf
    return x


def tree_model(rng, kind, loss):
    """Random perfect trees of depth 6 over 28 columns with quantile
    cuts (62 per column; 64 bins incl. the missing slot), a few
    subtrees cut short by early leaves."""
    sample = rng.normal(0, 1, (20000, GBT_COLS)).astype(np.float32)
    qs = np.linspace(0, 1, GBT_BINS - 1)[1:-1]          # 62 cuts
    num_cuts = np.quantile(sample, qs, axis=0).astype(np.float32)
    n_nodes = 2 ** (GBT_DEPTH + 1) - 1
    n_internal = 2 ** GBT_DEPTH - 1
    t = GBT_TREES
    feature = rng.integers(0, GBT_COLS, (t, n_nodes)).astype(np.int32)
    bins = rng.integers(0, GBT_BINS - 1, (t, n_nodes)).astype(np.int32)
    is_leaf = np.zeros((t, n_nodes), bool)
    is_leaf[:, n_internal:] = True
    is_leaf[:, 3:n_internal] |= rng.random((t, n_internal - 3)) < 0.05
    feature[is_leaf] = -1
    trees = {"feature": feature, "bin": bins,
             "default_left": rng.integers(0, 2, (t, n_nodes))
             .astype(np.int32),
             "is_leaf": is_leaf,
             "gain": np.zeros((t, n_nodes), np.float32),
             "leaf_value": rng.normal(0, 0.5, (t, n_nodes))
             .astype(np.float32)}
    meta = {"kind": kind,
            "treeConfig": {"max_depth": GBT_DEPTH, "n_bins": GBT_BINS,
                           "learning_rate": 0.1, "loss": loss}}
    tables = {"num_cuts": num_cuts,
              "cat_map": np.zeros((0, 1), np.int32)}
    return meta, {"trees": trees, "tables": tables}


# ---------------------------------------------------------------------------
# Measurement helpers
# ---------------------------------------------------------------------------

def cuda_ms(fn, iters, warmup=3):
    """Mean device time of `fn` over `iters` back-to-back calls, by CUDA
    events, after `warmup` calls."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def kernel_device_ms(fn, iters, kernel):
    """Mean device time of the CUDA kernel named `kernel` over `iters`
    calls of `fn`, from `torch.profiler`; None when the profiler records
    no device time for it."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    for ev in prof.key_averages():
        if kernel in ev.key and ev.count:
            us = getattr(ev, "self_device_time_total", 0) or \
                getattr(ev, "device_time_total", 0)
            return us / ev.count / 1e3 if us else None
    return None


def device_busy(fn):
    """Run `fn` under `torch.profiler` → (wall ms, device ms): the wall
    time of the window and the device time of every kernel and copy the
    profiler saw in it, from whichever thread launched them (the
    service's batcher thread)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    dev_us = sum(ev.self_device_time_total for ev in prof.events()
                 if ev.device_type == DeviceType.CUDA)
    return wall_ms, dev_us / 1e3


def bound_ms(n_bytes, n_ops):
    t_mem = n_bytes / MEM_BW * 1e3
    t_ops = n_ops / F32_PEAK * 1e3
    return max(t_mem, t_ops), ("bytes" if t_mem >= t_ops else "operations")


def k1_cost(n, c, h):
    """Bytes: values, mean, std, w, b read once, out written once.
    Operations: 2·N·C·H for the product, 5·N·C for the normalize."""
    return 4 * (n * c + 2 * c + c * h + h + n * h), 2 * n * c * h + 5 * n * c


def k2_cost(c, r, k, s, n_trees, leaves):
    """Bytes: valuesT, cuts, the five node rows the walk reads (feature,
    bin, default_left, stop, leaf; rows 5-7 of the (8, S) block are
    padding nothing reads) once each, scores written once. Operations
    (this run's data): ⌈log2(K+1)⌉ compares per cell for the bins, the
    least that finds Σ(v ≥ cut) over ascending cuts (the kernel itself
    scans all K); 3 per node step each row took (compare, select,
    index), counted from the landing node depths; one add per tree and
    row."""
    import torch
    steps = int(torch.floor(torch.log2(leaves.double() + 1)).sum())
    return 4 * (c * r + c * k + 5 * s + r), \
        r * c * math.ceil(math.log2(k + 1)) + 3 * steps + r * n_trees


def check_close(name, got, want, rtol, atol):
    import torch
    err = float((got - want).abs().max()) if got.numel() else 0.0
    torch.testing.assert_close(got, want, rtol=rtol, atol=atol,
                               equal_nan=True, msg=lambda m: f"{name}: {m}")
    print(f"  {name}: max |err| {err:.3g} (rtol {rtol}, atol {atol}) ok")
    return err


# ---------------------------------------------------------------------------
# Phases
# ---------------------------------------------------------------------------

def phase_device():
    import torch
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(f"device: {name}, count {torch.cuda.device_count()}, "
          f"torch {torch.__version__}, cuda {torch.version.cuda}")
    print(f"nvidia-smi: {smi}")
    return name, smi


def phase_build():
    from shifu_tpu_torch import _build
    t0 = time.monotonic()
    logs = _build.build_all(extra_flags=["-Xptxas", "-v"])
    print(f"build: {sorted(logs)} in {time.monotonic() - t0:.1f} s")
    for name, text in sorted(logs.items()):
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")


def k1_inputs(seed, n, device):
    import torch
    rng = np.random.default_rng(seed)
    mean, std = norm_params(rng)
    x = raw_rows(rng, n, mean, std)
    layer = nn_params(rng)[0]
    return [torch.as_tensor(a, device=device)
            for a in (x, mean, std, layer["w"], layer["b"])]


def phase_k1(report, device="cuda"):
    import torch
    from shifu_tpu_torch.ops import fused_score as fs
    errs = []
    for seed, n in ((1, 512), (2, 65536)):
        x, mean, std, w, b = k1_inputs(seed, n, device)
        got = fs.fused_first_layer(x, mean, std, CUTOFF, w, b)
        want = fs.fused_first_layer_plain(x, mean, std, CUTOFF, w, b)
        if device == "cuda":
            torch.cuda.synchronize()
        assert torch.isfinite(got).all(), "K1 output not finite"
        errs.append(check_close(f"K1 fused_score {n}x{NN_IN}->"
                                f"{NN_HIDDEN[0]}", got, want, 1e-5, 1e-5))
    report["fused_score"] = {"max_abs_err": max(errs)}


def k2_inputs(seed, r, device, kind="gbt", loss="log"):
    import torch
    from shifu_tpu_torch import weights
    from shifu_tpu_torch.models import gbdt
    rng = np.random.default_rng(seed)
    meta, params = tree_model(rng, kind, loss)
    ens = weights.to_torch(kind, meta, params, device)
    x = tree_rows(rng, r)
    fb = gbdt.make_fused_inputs(ens.tables, x, None, GBT_BINS,
                                device=device)
    # one +inf pad column in the cuts, as make_fused_inputs pads widths
    cuts = torch.nn.functional.pad(fb.cuts, (0, 1), value=math.inf)
    return ens.nodes, fb.valuesT, cuts.contiguous(), ens.statics


def phase_k2(report, device="cuda"):
    import torch
    from shifu_tpu_torch.ops import fused_trees as ft
    errs = []
    for seed, r, kind, loss in ((3, 512, "gbt", "log"),
                                (4, 512, "rf", "squared"),
                                (5, 1 << 20, "gbt", "log")):
        nodes, vT, cuts, kw = k2_inputs(seed, r, device, kind, loss)
        got, leaves = ft.predict_ensemble(nodes, vT, cuts, **kw,
                                          return_leaves=True)
        want, want_leaves = ft.predict_ensemble_plain(
            nodes, vT, cuts, **kw, return_leaves=True)
        if device == "cuda":
            torch.cuda.synchronize()
        assert torch.equal(leaves, want_leaves), \
            f"K2 {kind} R={r}: landing leaves differ from the plain walk"
        assert torch.isfinite(got).all(), "K2 output not finite"
        errs.append(check_close(f"K2 fused_trees {kind} R={r} (leaves "
                                "exact)", got, want, 1e-6, 1e-6))
    report["fused_trees"] = {"max_abs_err": max(errs)}


def _post(base, blocks):
    body = json.dumps({k: np.where(np.isfinite(v), v, None).tolist()
                       if v.dtype.kind == "f" else v.tolist()
                       for k, v in blocks.items()}).encode()
    req = urllib.request.Request(base + "/score", data=body,
                                 headers={"Content-Type":
                                          "application/json"})
    with urllib.request.urlopen(req, timeout=120) as resp:
        return json.loads(resp.read())["scores"]


def _serve_and_compare(name, gpu, cpu, base, make_rows, tol, seed,
                       reps=3):
    """Requests of every size: `reps` at once in process (so they share
    batches), one over HTTP; each answer against the CPU twin."""
    rng = np.random.default_rng(seed)
    for n in SIZES:
        batch = [make_rows(rng, n) for _ in range(reps)]
        reqs = [gpu.submit_async(**b) for b in batch]
        for b, req in zip(batch, reqs):
            got = req.wait(120)
            want = cpu.submit(**b, timeout=120)
            for k in want:
                assert got[k].shape == (n,) and np.isfinite(got[k]).all()
                np.testing.assert_allclose(got[k], want[k], **tol,
                                           err_msg=f"{name} n={n} {k}")
        over_http = _post(base, batch[0])
        # JSON has no inf/NaN: the HTTP request sends them as null →
        # NaN, so the HTTP answer is held against the CPU twin's answer
        # to the same NaN-for-inf rows
        json_blocks = {k: np.where(np.isfinite(v), v, np.nan)
                       .astype(v.dtype) for k, v in batch[0].items()}
        want = cpu.submit(**json_blocks, timeout=120)
        for k in want:
            np.testing.assert_allclose(np.asarray(over_http[k]), want[k],
                                       **tol, err_msg=f"{name} http n={n}")
    print(f"  {name}: served sizes {list(SIZES)} in process and over "
          "HTTP, matching the CPU twin")
    # a closed loop of one client for the percentiles: STREAM requests
    # per size, each sent when the previous one returned
    stages = ("queue_s", "pad_s", "h2d_s", "device_s", "d2h_s")
    out = {}
    for n in SIZES:
        rows = [make_rows(rng, n) for _ in range(8)]
        lat, split = [], {k: 0.0 for k in stages}
        for i in range(STREAM):
            _, timing = gpu.submit_timed(**rows[i % len(rows)])
            lat.append(timing["total_s"] * 1e3)
            for k in stages:
                split[k] += timing[k] * 1e3 / STREAM
        out[n] = {"n": STREAM, "p50_ms": float(np.percentile(lat, 50)),
                  "p95_ms": float(np.percentile(lat, 95)),
                  "p99_ms": float(np.percentile(lat, 99)),
                  "mean_stage_ms": split}
        if gpu.device.type == "cuda":
            # the device's idle share over a profiled closed-loop window
            wall, busy = device_busy(lambda: [
                gpu.submit_timed(**rows[i % len(rows)])
                for i in range(IDLE_WINDOW)])
            out[n]["idle_window"] = {"requests": IDLE_WINDOW,
                                     "wall_ms": wall, "device_ms": busy,
                                     "idle_share": 1.0 - busy / wall}
    return out


def phase_main_path(report, workdir, device="cuda"):
    from shifu_tpu_torch.models.spec import save_model
    from shifu_tpu_torch.ops import fused_score, fused_trees
    from shifu_tpu_torch.serve.http import HttpFrontEnd
    from shifu_tpu_torch.serve.service import ScorerService

    rng = np.random.default_rng(42)
    nn_dir = os.path.join(workdir, "nn", "models")
    tree_dir = os.path.join(workdir, "trees", "models")
    save_model(os.path.join(nn_dir, "model0.nn"), "nn",
               {"spec": {"input_dim": NN_IN, "hidden_dims": list(NN_HIDDEN),
                         "activations": ["relu", "relu"]}},
               nn_params(rng))
    for i, (kind, loss) in enumerate((("gbt", "log"), ("rf", "squared"))):
        meta, params = tree_model(rng, kind, loss)
        save_model(os.path.join(tree_dir, f"model{i}.{kind}"), kind, meta,
                   params)
    mean, std = norm_params(rng)
    norm = {"mean": mean, "std": std, "cutoff": CUTOFF}

    def nn_rows(r, n):
        return {"raw_dense": raw_rows(r, n, mean, std)}

    def tree_req(r, n):
        return {"raw_dense": tree_rows(r, n)}

    services, fronts = [], []
    try:
        nn_gpu = ScorerService(models_dir=nn_dir, norm=norm,
                               max_delay=0.002, device=device)
        nn_cpu = ScorerService(models_dir=nn_dir, norm=norm,
                               max_delay=0.002, device="cpu")
        tr_gpu = ScorerService(models_dir=tree_dir, max_delay=0.002,
                               device=device)
        tr_cpu = ScorerService(models_dir=tree_dir, max_delay=0.002,
                               device="cpu")
        services = [nn_gpu, nn_cpu, tr_gpu, tr_cpu]
        for svc, proto in ((nn_gpu, nn_rows(rng, 1)),
                           (nn_cpu, nn_rows(rng, 1)),
                           (tr_gpu, tree_req(rng, 1)),
                           (tr_cpu, tree_req(rng, 1))):
            svc.start(proto=proto)
        fronts = [HttpFrontEnd(s, host="127.0.0.1", port=0).start()
                  for s in (nn_gpu, tr_gpu)]
        bases = ["http://%s:%d" % f.address for f in fronts]

        fused_score.launches = 0
        fused_trees.launches = 0
        lat_nn = _serve_and_compare("nn+norm", nn_gpu, nn_cpu, bases[0],
                                    nn_rows, dict(rtol=1e-5, atol=1e-5), 7)
        lat_tr = _serve_and_compare("gbt+rf", tr_gpu, tr_cpu, bases[1],
                                    tree_req, dict(rtol=1e-6, atol=1e-6), 8)
        launches = {"fused_score": fused_score.launches,
                    "fused_trees": fused_trees.launches}
        for k, v in launches.items():
            assert v > 0, f"kernel {k} was not launched on the main path"
            report[k]["launches"] = v
        report["services"] = {
            "nn+norm": {"per_size": lat_nn,
                        "overall": nn_gpu.stats()["latency"],
                        "batcher": nn_gpu.stats()["batcher"]},
            "gbt+rf": {"per_size": lat_tr,
                       "overall": tr_gpu.stats()["latency"],
                       "batcher": tr_gpu.stats()["batcher"]}}
    finally:
        for f in fronts:
            f.close()
        for s in services:
            s.close()


def phase_timing(report):
    import torch
    from shifu_tpu_torch.ops import fused_score as fs
    from shifu_tpu_torch.ops import fused_trees as ft
    from shifu_tpu_torch.ops.normalize import zscore

    sweep = []
    for n in (512, 65536):
        x, mean, std, w, b = k1_inputs(11, n, "cuda")
        packed = fs.pack_norm(mean, std, CUTOFF)
        z = zscore(x, mean, std, CUTOFF)
        iters = 200 if n <= 512 else 20
        ms = cuda_ms(lambda: fs.fused_first_layer(x, mean, std, CUTOFF, w,
                                                  b, packed), iters)
        plain = cuda_ms(lambda: fs.fused_first_layer_plain(
            x, mean, std, CUTOFF, w, b), iters)
        lib = cuda_ms(lambda: torch.matmul(z, w), iters)
        dev = kernel_device_ms(lambda: fs.fused_first_layer(
            x, mean, std, CUTOFF, w, b, packed), iters, "fused_score_kernel")
        bnd, by = bound_ms(*k1_cost(n, NN_IN, NN_HIDDEN[0]))
        sweep.append({"name": "fused_score", "shape": f"{n}x{NN_IN}x"
                      f"{NN_HIDDEN[0]}", "ms": ms, "kernel_device_ms": dev,
                      "plain_ms": plain, "library_ms": lib,
                      "bound_ms": bnd, "bound_by": by})
    for r in (512, 1 << 20):
        nodes, vT, cuts, kw = k2_inputs(12, r, "cuda")
        _, leaves = ft.predict_ensemble_plain(nodes, vT, cuts, **kw,
                                              return_leaves=True)
        iters = 200 if r <= 512 else 20
        ms = cuda_ms(lambda: ft.predict_ensemble(nodes, vT, cuts, **kw),
                     iters)
        plain = cuda_ms(lambda: ft.predict_ensemble_plain(nodes, vT, cuts,
                                                          **kw), iters)
        dev = kernel_device_ms(lambda: ft.predict_ensemble(
            nodes, vT, cuts, **kw), iters, "fused_trees_kernel")
        bnd, by = bound_ms(*k2_cost(vT.shape[0], r, cuts.shape[1],
                                    nodes.shape[1], kw["n_trees"], leaves))
        sweep.append({"name": "fused_trees", "shape": f"R={r}x{GBT_COLS}"
                      f" T={GBT_TREES} d={GBT_DEPTH}", "ms": ms,
                      "kernel_device_ms": dev,
                      "plain_ms": plain, "library_ms": None,
                      "bound_ms": bnd, "bound_by": by})
    for row in sweep:
        print("  timing " + json.dumps(row))
    # the main path's shape: the top serving bucket (512 rows)
    for row in sweep[0], sweep[2]:
        report[row["name"]].update({k: row[k] for k in (
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")})
    report["sweep"] = sweep


# ---------------------------------------------------------------------------
# The tree-training slice: K3, K4 and K5, and `train` on the card
# ---------------------------------------------------------------------------

HIGGS_ROWS, HIGGS_TREES = 2_000_000, 10     # bench.py:178-179 (GBT_SMALL)
BIG_ROWS, BIG_TREES = 11_000_000, 20        # bench.py:171-176 (HIGGS)
TRAIN_ROWS = 262_144                        # the main path's model sets
TRAIN_DEPTH, TRAIN_LR = 6, 0.2
HIST_SLOTS = (1, 32)          # root level; leaf level with subtraction
SPLIT_NODES = (1, 32, 20 * 32)  # one tree's levels; a 20-tree forest level
LIMIT_S = 1200.0


def hist_inputs(seed, r, n_slots, device, integer, c=GBT_COLS,
                n_bins=GBT_BINS):
    """Raw (C, R) values with NaN and ±inf, (C, B-2) quantile cuts, their
    bins, and per-row slot (dump slot S and -1 included) / grad / hess,
    made on `device` from a seed."""
    import torch
    gen = torch.Generator(device=device).manual_seed(seed)
    vals = torch.randn((c, r), generator=gen, device=device)
    u = torch.rand((c, r), generator=gen, device=device)
    vals[u < 0.05] = math.nan
    vals[u > 0.998] = math.inf
    vals[(u > 0.996) & (u <= 0.998)] = -math.inf
    qs = torch.linspace(0, 1, n_bins, device=device)[1:-1]
    sample = torch.randn(20000, generator=gen, device=device)
    cuts = torch.quantile(sample, qs).expand(c, n_bins - 2).contiguous()
    from shifu_tpu_torch.ops.level_hist import bins_from_values_plain
    binsT = bins_from_values_plain(vals, cuts, n_bins)
    slot = torch.randint(-1, n_slots + 1, (r,), generator=gen,
                         device=device, dtype=torch.int32)
    if integer:
        grad = torch.randint(-3, 4, (r,), generator=gen,
                             device=device).float()
        hess = torch.randint(0, 3, (r,), generator=gen,
                             device=device).float()
    else:
        grad = torch.randn(r, generator=gen, device=device)
        hess = torch.rand(r, generator=gen, device=device)
    return vals, cuts, binsT, slot, grad, hess


def _hist_err(name, got, want, slot, w, n_slots, integer):
    """Exact for integer weights; otherwise |err| ≤ 1e-5·Σ|w| per slot."""
    import torch
    if integer:
        assert torch.equal(got, want), f"{name}: not bit-exact"
        print(f"  {name}: bit-exact")
        return 0.0
    ok = (slot >= 0) & (slot < n_slots)
    per_slot = torch.zeros(n_slots, dtype=torch.float64, device=w.device)
    per_slot.index_add_(0, slot[ok].long(), w[ok].abs().double())
    err = (got - want).abs().amax(dim=(1, 2)).double()
    tol = 1e-5 * per_slot
    assert bool((err <= tol).all()), \
        f"{name}: per-slot max |err| {err.tolist()} over {tol.tolist()}"
    print(f"  {name}: max |err| {float(err.max()):.3g} (≤ 1e-5·Σ|w| per "
          f"slot, tightest {float(tol.min()):.3g}) ok")
    return float(err.max())


def phase_k3_k4(report, device="cuda", r=HIGGS_ROWS):
    from shifu_tpu_torch.ops import level_hist as lh
    errs = {"level_hist": [0.0], "level_hist_fused": [0.0]}
    for s in HIST_SLOTS:
        for integer in (True, False):
            vals, cuts, binsT, slot, grad, hess = hist_inputs(
                20 + s + integer, r, s, device, integer)
            kind = "int" if integer else "real"
            want = lh.level_histograms_plain(binsT, slot, grad, hess, s,
                                             GBT_BINS)
            for name, got in (
                    ("level_hist", lh.level_histograms(
                        binsT, slot, grad, hess, s, GBT_BINS)),
                    ("level_hist_fused", lh.level_histograms_fused(
                        vals, cuts, slot, grad, hess, s, GBT_BINS))):
                for part, g, wv, w in zip("GH", got, want, (grad, hess)):
                    errs[name].append(_hist_err(
                        f"{name} R={r} S={s} {kind} {part}", g, wv, slot,
                        w, s, integer))
    for name, e in errs.items():
        report[name] = {"max_abs_err": max(e)}


def split_inputs(seed, n, device, c=GBT_COLS, n_bins=GBT_BINS):
    """Integer-valued (N, C, B) G/H (every cumsum exact), a planted tie
    (column 5 repeats column 2) and, for N > 1, an all-masked node 0."""
    import torch
    gen = torch.Generator(device=device).manual_seed(seed)
    g = torch.randint(-20, 21, (n, c, n_bins), generator=gen,
                      device=device).float()
    h = torch.randint(0, 30, (n, c, n_bins), generator=gen,
                      device=device).float()
    g[:, 5] = g[:, 2]
    h[:, 5] = h[:, 2]
    mask = (torch.rand((n, c), generator=gen, device=device) < 0.8).float()
    mask[:, 2] = 1.0
    mask[:, 5] = 1.0
    if n > 1:
        mask[0] = 0.0
    return g, h, mask


def phase_k5(report, device="cuda"):
    import torch
    from shifu_tpu_torch.ops import best_splits as bs
    err = 0.0
    for n in SPLIT_NODES:
        g, h, mask = split_inputs(30 + n, n, device)
        got = bs.best_splits(g, h, mask, 1.0, 2.0)
        want = bs.best_splits_plain(g, h, mask, 1.0, 2.0)
        for k in ("feature", "bin", "default_left"):
            assert torch.equal(got[k], want[k]), f"K5 N={n}: {k} differs"
        assert not bool((got["feature"] == 5).any()), \
            "K5: the tie went to the later column"
        if n > 1:
            assert got["gain"][0] == -math.inf and got["feature"][0] == 0 \
                and got["bin"][0] == 0, "K5: all-masked node not at index 0"
        for k, rtol in (("gain", 1e-5), ("g_tot", 1e-6), ("h_tot", 1e-6)):
            torch.testing.assert_close(got[k], want[k], rtol=rtol, atol=0.0,
                                       msg=lambda m: f"K5 N={n} {k}: {m}")
            fin = torch.isfinite(want[k])
            if bool(fin.any()):
                err = max(err, float((got[k][fin] - want[k][fin]).abs()
                                     .max()))
        print(f"  K5 best_splits N={n}: feature, bin, default_left exact")
    report["best_splits"] = {"max_abs_err": err}


def write_model_set(root, alg, params, seed, rows, valid_rate):
    """A model set from a seed, with the port's own writers: 28 numeric
    HIGGS-like columns with stats bin boundaries (63 bins → 64 with the
    missing slot), a binary target, and `tmp/CleanedData`."""
    from shifu_tpu_torch.config.column_config import (
        ColumnBinning, ColumnConfig, ColumnFlag, save_column_configs)
    from shifu_tpu_torch.config.model_config import ModelConfig
    from shifu_tpu_torch.fileio import atomic_write
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1, (rows, GBT_COLS)).astype(np.float32)
    logit = (x[:, 0] - 0.8 * x[:, 1] + 0.5 * x[:, 2] * x[:, 3]
             + np.where(x[:, 4] > 0.5, 1.0, -0.3)
             + rng.logistic(0, 1, rows))
    y = (logit > 0).astype(np.float32)
    x[rng.random(x.shape) < 0.02] = np.nan
    names = [f"f{j}" for j in range(GBT_COLS)]
    qs = np.linspace(0, 1, GBT_BINS - 1)[1:-1]
    ccs = []
    for j, name in enumerate(names):
        cuts = np.nanquantile(x[:, j], qs)
        ccs.append(ColumnConfig(
            columnNum=j, columnName=name,
            columnBinning=ColumnBinning(
                length=len(cuts) + 1,
                binBoundary=[-math.inf] + [float(v) for v in cuts])))
    ccs.append(ColumnConfig(columnNum=GBT_COLS, columnName="label",
                            columnFlag=ColumnFlag.Target))
    os.makedirs(os.path.join(root, "tmp", "CleanedData"))
    ModelConfig.from_dict({
        "basic": {"name": f"smoke{alg}"},
        "dataSet": {"targetColumnName": "label", "posTags": ["1"],
                    "negTags": ["0"]},
        "stats": {"maxNumBin": GBT_BINS - 1},
        "train": {"algorithm": alg, "validSetRate": valid_rate,
                  "params": params}}).save(root)
    save_column_configs(ccs, root)
    clean = os.path.join(root, "tmp", "CleanedData")
    np.savez(os.path.join(clean, "data.npz"), dense=x,
             index=np.zeros((rows, 0), np.int32), tags=y,
             weights=np.ones(rows, np.float32))
    with atomic_write(os.path.join(clean, "meta.json")) as f:
        json.dump({"denseNames": names, "indexNames": []}, f)
    return x, y


def run_train(root, device, env_extra=None):
    """`python -m shifu_tpu_torch --dir root train --device D` as a
    subprocess; returns its JSON report line."""
    env = dict(os.environ)
    env.update(env_extra or {})
    proc = subprocess.run(
        [sys.executable, "-m", "shifu_tpu_torch", "--dir", root, "train",
         "--device", device], capture_output=True, text=True, env=env,
        cwd=os.path.dirname(os.path.abspath(__file__)), timeout=600)
    if proc.returncode != 0:
        raise RuntimeError(f"train --device {device} on {root} failed "
                           f"(rc {proc.returncode}):\n{proc.stderr[-4000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def _model_file(root, kind):
    from shifu_tpu_torch.models.spec import load_model
    return load_model(os.path.join(root, "models", f"model0.{kind}"))


def auc(y, s):
    """Mann-Whitney AUC with average ranks for ties."""
    order = np.argsort(s, kind="mergesort")
    _, first, counts = np.unique(s[order], return_index=True,
                                 return_counts=True)
    ranks = np.empty(len(s))
    ranks[order] = np.repeat(first + (counts + 1) / 2.0, counts)
    pos = y > 0.5
    n_pos = int(pos.sum())
    n_neg = len(y) - n_pos
    return float((ranks[pos].sum() - n_pos * (n_pos + 1) / 2.0)
                 / (n_pos * n_neg))


def train_metrics(root, x, y):
    """Train log-loss and AUC of a saved GBT scored on the CPU."""
    import torch
    from shifu_tpu_torch import weights
    from shifu_tpu_torch.models import gbdt
    kind, meta, params = _model_file(root, "gbt")
    ens = weights.to_torch(kind, meta, params, "cpu")
    p = gbdt.predict(meta, ens, x, None).double().numpy()
    p = np.clip(p, 1e-7, 1 - 1e-7)
    loss = float(-np.mean(y * np.log(p) + (1 - y) * np.log(1 - p)))
    return loss, auc(y, p)


def phase_train_main_path(report, workdir, device="cuda", rows=TRAIN_ROWS):
    """`train` on the card and on the CPU for RF, one-round squared GBT
    and log-loss GBT (and log-loss GBT through K4), then the port's
    `serve` on the card-trained model."""
    import torch
    sets = {
        "rf": ("RF", {"TreeNum": 10, "MaxDepth": TRAIN_DEPTH,
                      "FeatureSubsetStrategy": "SQRT"}, 0.0),
        "gbt_sq": ("GBT", {"TreeNum": 1, "MaxDepth": TRAIN_DEPTH,
                           "LearningRate": TRAIN_LR, "Loss": "squared"},
                   0.1),
        "gbt_log": ("GBT", {"TreeNum": 10, "MaxDepth": TRAIN_DEPTH,
                            "LearningRate": TRAIN_LR, "Loss": "log"}, 0.1),
    }
    data = {}
    for name, (alg, params, vr) in sets.items():
        for where in ("card", "cpu"):
            data[name] = write_model_set(
                os.path.join(workdir, f"{name}_{where}"), alg, params, 40,
                rows, vr)
    fused_root = os.path.join(workdir, "gbt_log_fused")
    write_model_set(fused_root, *sets["gbt_log"][:2], 40, rows, 0.1)

    # each `train` run reports its kernels' launches (its process's
    # counters start at zero and are read before and after the run);
    # the main path's counts are the card runs' sums
    runs = {}
    for name in sets:
        runs[name] = run_train(os.path.join(workdir, f"{name}_card"), device)
        runs[name + "_cpu"] = run_train(os.path.join(workdir, f"{name}_cpu"),
                                        "cpu")
    runs["gbt_log_fused"] = run_train(fused_root, device,
                                      {"SHIFU_TPU_HIST_FUSED": "1"})
    launches = {k: sum(r["launches"][k] for n, r in runs.items()
                       if not n.endswith("_cpu"))
                for k in ("level_hist", "level_hist_fused", "best_splits")}
    for name, r in runs.items():
        print(f"  train {name}: {r['algorithm']} on {r['device']} in "
              f"{r['seconds']:.2f} s, launches {r['launches']}")
    for k, v in launches.items():
        assert v > 0, f"kernel {k} was not launched on the train path"
        report[k]["launches"] = v

    for name, kind in (("rf", "rf"), ("gbt_sq", "gbt")):
        _, meta_a, pa = _model_file(os.path.join(workdir, f"{name}_card"),
                                    kind)
        _, meta_b, pb = _model_file(os.path.join(workdir, f"{name}_cpu"),
                                    kind)
        assert meta_a == meta_b, f"{name}: meta differs"
        for part in ("trees", "tables"):
            for k in pb[part]:
                assert np.array_equal(pa[part][k], pb[part][k]), \
                    f"{name}: {part}.{k} differs between card and CPU"
        print(f"  {name}: card-trained file bit-exact with the CPU run")
    x, y = data["gbt_log"]
    ref = train_metrics(os.path.join(workdir, "gbt_log_cpu"), x, y)
    for name in ("gbt_log_card", "gbt_log_fused"):
        loss, a = train_metrics(os.path.join(workdir, name), x, y)
        assert abs(loss - ref[0]) <= 1e-4 * ref[0], \
            f"{name}: train log-loss {loss} vs CPU {ref[0]}"
        assert abs(a - ref[1]) <= 1e-3, f"{name}: AUC {a} vs CPU {ref[1]}"
        print(f"  {name}: train log-loss {loss:.6f} (CPU {ref[0]:.6f}), "
              f"AUC {a:.6f} (CPU {ref[1]:.6f}) ok")
    report["train_runs"] = runs

    # the port's serve scores the card-trained model, against the CPU
    from shifu_tpu_torch.serve.service import ScorerService
    models = os.path.join(workdir, "gbt_log_card", "models")
    rows_in = {"raw_dense": x[:512]}
    gpu = ScorerService(models_dir=models, max_delay=0.002, device=device)
    cpu = ScorerService(models_dir=models, max_delay=0.002, device="cpu")
    try:
        gpu.start(proto={"raw_dense": x[:1]})
        cpu.start(proto={"raw_dense": x[:1]})
        got, want = gpu.submit(**rows_in), cpu.submit(**rows_in)
    finally:
        gpu.close()
        cpu.close()
    for k in want:
        assert got[k].shape == (512,) and np.isfinite(got[k]).all()
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6, atol=1e-6)
    print("  serve: the card-trained GBT scores 512 rows on the card like "
          "the CPU twin")
    if device == "cuda":
        torch.cuda.synchronize()


def _gbt_data(r, device, seed=50):
    """HIGGS-width training data made on the card: (C, R) raw values
    with NaN/±inf, their (C, R) int32 bins of 64 (missing included) and
    cuts, and labels from the raw values."""
    import torch
    vals, cuts, binsT, _, _, _ = hist_inputs(seed, r, 1, device, False)
    v = torch.nan_to_num(vals, nan=0.0, posinf=3.0, neginf=-3.0)
    logit = v[0] - 0.8 * v[1] + 0.5 * v[2] * v[3] + (v[4] > 0.5).float()
    gen = torch.Generator(device=device).manual_seed(seed + 1)
    y = (logit + torch.randn(r, generator=gen, device=device) > 0).float()
    del v, logit
    return vals, binsT, cuts, y


def profile_by_kernel(fn):
    """(wall ms, {category: device ms}) over `fn` under torch.profiler:
    level_hist, best_splits, and everything else the build launches."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    cats = {"level_hist": 0.0, "best_splits": 0.0, "other": 0.0}
    counts = {"level_hist": 0, "best_splits": 0, "other": 0}
    by_name = {}
    for ev in prof.events():
        if ev.device_type != DeviceType.CUDA:
            continue
        key = "level_hist" if "level_hist" in ev.name else \
            "best_splits" if "best_splits" in ev.name else "other"
        ms = ev.self_device_time_total / 1e3
        cats[key] += ms
        counts[key] += 1
        n, t = by_name.get(ev.name[:90], (0, 0.0))
        by_name[ev.name[:90]] = (n + 1, t + ms)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:12]
    return wall_ms, cats, counts, [(k, n, t) for k, (n, t) in top]


def profile_levels(fn):
    """Per level of one tree built by `fn`, for the histograms
    (`_child_level_histograms`: K3 or K4 plus the sibling subtraction),
    the split search and fold (`_apply_level`: K5 plus the fold) and the
    routing step (`_route_level`): host ms (the range on the CPU),
    device span ms (first to last kernel of the range on the card's
    timeline, gaps included) and kernel ms (device time of the kernels
    and copies inside that span), from `torch.profiler` ranges put
    around those three builder functions for the run."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function
    from shifu_tpu_torch.models import gbdt
    names = {"_child_level_histograms": "hist", "_apply_level": "split",
             "_route_level": "route"}
    saved = {k: getattr(gbdt, k) for k in names}

    def wrap(key, f):
        def inner(*a, **kw):
            with record_function("tree." + names[key]):
                return f(*a, **kw)
        return inner

    torch.cuda.synchronize()
    try:
        for k, f in saved.items():
            setattr(gbdt, k, wrap(k, f))
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
    finally:
        for k, f in saved.items():
            setattr(gbdt, k, f)
    host = {v: [] for v in names.values()}
    spans = {v: [] for v in names.values()}
    kernels = []
    for ev in prof.events():
        t = ev.time_range
        if ev.name.startswith("tree."):
            side = spans if ev.device_type == DeviceType.CUDA else host
            side[ev.name[5:]].append((t.start, t.end))
        elif ev.device_type == DeviceType.CUDA:
            kernels.append((t.start, t.end))

    def busy(a, b):
        return sum(max(0, min(e, b) - max(s, a)) for s, e in kernels)

    rows = {}
    for key in names.values():
        h = sorted(host[key])
        g = sorted(spans[key])
        rows[key] = [{"host_ms": (he - hs) / 1e3,
                      "span_ms": (ge - gs) / 1e3 if i < len(g) else None,
                      "kernel_ms": busy(gs, ge) / 1e3 if i < len(g)
                      else None}
                     for i, ((hs, he), (gs, ge)) in enumerate(
                         zip(h, g + [(0, 0)] * (len(h) - len(g))))]
    return wall_ms, rows


def k3_cost(c, r_active, r, n_slots, n_bins):
    """Bytes: the bins of rows in a live slot, slot/grad/hess of every
    row, G and H written once. Operations: one add each into G and H
    per live (row, column)."""
    return (4 * c * r_active + 12 * r + 8 * n_slots * c * n_bins,
            2 * c * r_active)


def k4_cost(c, r_active, r, k, n_slots, n_bins):
    """K3's bytes with raw values in place of bins plus the cut table;
    operations add ⌈log2(K+1)⌉ compares per live cell for the bins."""
    return (4 * c * r_active + 4 * c * k + 12 * r
            + 8 * n_slots * c * n_bins,
            2 * c * r_active + c * r_active * math.ceil(math.log2(k + 1)))


def k5_cost(n, c, n_bins):
    """Bytes: G and H read once, the mask, the (5, N) result. Operations:
    two cumsum adds and ~22 flops for the two gains per (node, column,
    main bin)."""
    return 8 * n * c * n_bins + 4 * n * c + 20 * n, 24 * n * c * (n_bins - 1)


def phase_train_timing(report, t_start):
    """HIGGS widths (28 columns, depth 6, 64 bins, log loss, lr 0.2):
    per-kernel times at the main path's shapes, the end-to-end build at
    2M rows × 10 trees, one profiled tree, and 11M × 20 if the time
    limit allows."""
    import torch
    from shifu_tpu_torch.models import gbdt
    from shifu_tpu_torch.ops import best_splits as bs
    from shifu_tpu_torch.ops import level_hist as lh
    sweep = []
    r = HIGGS_ROWS
    for s in HIST_SLOTS:
        vals, cuts, binsT, slot, grad, hess = hist_inputs(60 + s, r, s,
                                                          "cuda", False)
        live = (slot >= 0) & (slot < s)
        r_active = int(live.sum())
        # the library call: bincount over the flat (slot, column, bin)
        # index with a trailing dump slot, once for G and once for H
        slot_d = torch.where(live, slot, s).long()
        flat = ((slot_d * GBT_COLS)[None, :]
                + torch.arange(GBT_COLS, device="cuda")[:, None]) \
            * GBT_BINS + binsT.long()
        flat = flat.reshape(-1)
        wg = grad.expand(GBT_COLS, r).reshape(-1)
        wh = hess.expand(GBT_COLS, r).reshape(-1)
        size = (s + 1) * GBT_COLS * GBT_BINS
        lib = cuda_ms(lambda: (torch.bincount(flat, weights=wg,
                                              minlength=size),
                               torch.bincount(flat, weights=wh,
                                              minlength=size)), 10)
        del flat, wg, wh
        for name, fn, plain, cost in (
                ("level_hist",
                 lambda: lh.level_histograms(binsT, slot, grad, hess, s,
                                             GBT_BINS),
                 lambda: lh.level_histograms_plain(binsT, slot, grad, hess,
                                                   s, GBT_BINS),
                 k3_cost(GBT_COLS, r_active, r, s, GBT_BINS)),
                ("level_hist_fused",
                 lambda: lh.level_histograms_fused(vals, cuts, slot, grad,
                                                   hess, s, GBT_BINS),
                 lambda: lh.level_histograms_plain(
                     lh.bins_from_values_plain(vals, cuts, GBT_BINS), slot,
                     grad, hess, s, GBT_BINS),
                 k4_cost(GBT_COLS, r_active, r, cuts.shape[1], s,
                         GBT_BINS))):
            ms = cuda_ms(fn, 20)
            dev = kernel_device_ms(fn, 20, "level_hist_kernel")
            pl_ms = cuda_ms(plain, 5, warmup=1)
            bnd, by = bound_ms(*cost)
            sweep.append({"name": name, "shape": f"R={r}x{GBT_COLS} S={s} "
                          f"B={GBT_BINS}", "ms": ms, "kernel_device_ms": dev,
                          "plain_ms": pl_ms,
                          "library_ms": lib if name == "level_hist"
                          else None, "bound_ms": bnd, "bound_by": by})
        del vals, cuts, binsT, slot, grad, hess
    for n in SPLIT_NODES:
        g, h, mask = split_inputs(70 + n, n, "cuda")
        fn = lambda: bs.best_splits(g, h, mask, 1.0, 1.0)  # noqa: E731
        bnd, by = bound_ms(*k5_cost(n, GBT_COLS, GBT_BINS))
        sweep.append({"name": "best_splits", "shape": f"N={n} C={GBT_COLS}"
                      f" B={GBT_BINS}", "ms": cuda_ms(fn, 100),
                      "kernel_device_ms": kernel_device_ms(
                          fn, 100, "best_splits_kernel"),
                      "plain_ms": cuda_ms(lambda: bs.best_splits_plain(
                          g, h, mask, 1.0, 1.0), 50),
                      "library_ms": None, "bound_ms": bnd, "bound_by": by})
    for row in sweep:
        print("  timing " + json.dumps(row))
    # the kernels line: K3/K4 at the leaf level (S = 32), K5 at N = 32
    for row in sweep:
        if (row["name"].startswith("level_hist") and "S=32" in row["shape"]) \
                or (row["name"] == "best_splits" and "N=32 " in row["shape"]):
            report[row["name"]].update({k: row[k] for k in (
                "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")})
    report["train_sweep"] = sweep

    cfg = gbdt.TreeConfig(max_depth=TRAIN_DEPTH, n_bins=GBT_BINS,
                          learning_rate=TRAIN_LR, loss="log")
    e2e = {}
    vals, binsT, cuts, y = _gbt_data(r, "cuda")
    w = torch.ones_like(y)
    walls = {}
    for route, bins in (("binned", binsT),
                        ("fused", gbdt.FusedBins(vals, cuts))):
        gbdt.build_gbt(cfg, bins, y, w, 1)                  # warm-up
        counts0 = (lh.launches, lh.fused_launches, bs.launches)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trees, _ = gbdt.build_gbt(cfg, bins, y, w, HIGGS_TREES)
        walls[route] = wall = time.perf_counter() - t0
        assert np.isfinite(trees["leaf_value"]).all()
        per_tree = {"level_hist": (lh.launches - counts0[0]) / HIGGS_TREES,
                    "level_hist_fused": (lh.fused_launches - counts0[1])
                    / HIGGS_TREES,
                    "best_splits": (bs.launches - counts0[2]) / HIGGS_TREES}
        wall_ms, cats, counts, top = profile_by_kernel(
            lambda: gbdt.build_gbt(cfg, bins, y, w, 1))
        busy = sum(cats.values())
        e2e[f"{route} {r}x{HIGGS_TREES}"] = {
            "wall_s": wall, "row_trees_per_s": r * HIGGS_TREES / wall,
            "launches_per_tree": per_tree,
            "profiled_tree": {"wall_ms": wall_ms, "device_ms": cats,
                              "device_launches": counts,
                              "idle_share": 1.0 - busy / wall_ms,
                              "top_kernels": top}}
        print(f"  train {route} {r} rows x {HIGGS_TREES} trees: "
              f"{wall:.3f} s")
    wall_ms, levels = profile_levels(
        lambda: gbdt.build_gbt(cfg, binsT, y, w, 1))
    e2e[f"binned {r}x{HIGGS_TREES}"]["per_level"] = {
        "wall_ms": wall_ms, "host_device_ms": levels}
    print("  per level of one profiled tree: " + json.dumps(levels))
    del vals, binsT, cuts, y, w
    wall = walls["binned"]
    elapsed = time.monotonic() - t_start
    projected = wall * (BIG_ROWS / r) * (BIG_TREES / HIGGS_TREES) * 1.5 + 30
    if elapsed + projected < LIMIT_S / 2:
        vals, binsT, _, y = _gbt_data(BIG_ROWS, "cuda")
        del vals
        w = torch.ones_like(y)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        gbdt.build_gbt(cfg, binsT, y, w, BIG_TREES)
        big = time.perf_counter() - t0
        e2e[f"binned {BIG_ROWS}x{BIG_TREES}"] = {
            "wall_s": big, "row_trees_per_s": BIG_ROWS * BIG_TREES / big}
        print(f"  train {BIG_ROWS} rows x {BIG_TREES} trees: {big:.3f} s")
        del binsT, y, w
    else:
        print(f"  train {BIG_ROWS} x {BIG_TREES}: skipped (projected "
              f"{projected:.0f} s after {elapsed:.0f} s)")
    print("  train end to end: " + json.dumps(e2e))
    report["train_e2e"] = e2e


SOURCES = {
    "fused_score": ("shifu_tpu_torch/csrc/fused_score.cu",
                    "shifu_tpu/ops/pallas_score.py:110"),
    "fused_trees": ("shifu_tpu_torch/csrc/fused_trees.cu",
                    "shifu_tpu/ops/pallas_trees.py:203"),
    "level_hist": ("shifu_tpu_torch/csrc/level_hist.cu",
                   "shifu_tpu/ops/pallas_hist.py:250"),
    "level_hist_fused": ("shifu_tpu_torch/csrc/level_hist.cu",
                         "shifu_tpu/ops/pallas_hist.py:338"),
    "best_splits": ("shifu_tpu_torch/csrc/best_splits.cu",
                    "shifu_tpu/ops/pallas_split.py:144"),
}


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import shifu_tpu_torch  # noqa: F401  (sets TF32 off)

    t_start = time.monotonic()
    name, smi = phase_device()
    print("phase 1: build")
    phase_build()
    report = {}
    print("phase 2: K1 fused_score vs plain")
    phase_k1(report)
    print("phase 3: K2 fused_trees vs plain")
    phase_k2(report)
    print("phase 4: main path (two services on the card vs CPU twins)")
    with tempfile.TemporaryDirectory() as workdir:
        phase_main_path(report, workdir)
    print("phase 5: timing (CUDA events)")
    phase_timing(report)
    print("services: " + json.dumps(report["services"]))
    print("phase 6: K3 level_hist and K4 level_hist_fused vs plain")
    phase_k3_k4(report)
    print("phase 7: K5 best_splits vs plain")
    phase_k5(report)
    print("phase 8: train main path (card vs CPU, then serve)")
    with tempfile.TemporaryDirectory() as workdir:
        phase_train_main_path(report, workdir)
    print("phase 9: training timing at the HIGGS widths")
    phase_train_timing(report, t_start)
    print(f"total: {time.monotonic() - t_start:.1f} s on {smi}")

    kernels = []
    for k, (src, replaces) in SOURCES.items():
        r = report[k]
        kernels.append({"name": k, "route": "cuda", "source": src,
                        "replaces": replaces, "launches": r["launches"],
                        "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                        "bound_by": r["bound_by"],
                        "library_ms": r["library_ms"]})
    print("kernels: " + ", ".join(f"{k['name']}={k['launches']}"
                                  for k in kernels))
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
