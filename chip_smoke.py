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
   over a profiled window of 200 more.

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
    fb = gbdt.make_fused_inputs(ens.tables, x, None, GBT_BINS, device)
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


SOURCES = {
    "fused_score": ("shifu_tpu_torch/csrc/fused_score.cu",
                    "shifu_tpu/ops/pallas_score.py:110"),
    "fused_trees": ("shifu_tpu_torch/csrc/fused_trees.cu",
                    "shifu_tpu/ops/pallas_trees.py:203"),
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
