"""Fused z-score normalize + first-layer matmul (kernel K1).

Counterpart of `shifu_tpu/ops/pallas_score.py`. `fused_first_layer`
turns raw (N, C) rows (NaN = missing) into the (N, H) first-layer
pre-activation ``zscore(values) @ w + b`` without writing the z-scored
matrix to device memory; `score_nn` runs the rest of the MLP.

Kernel: `csrc/fused_score.cu`, CUDA C++ for sm_90a. It replaces the TPU
kernel `_score_kernel` via `_fused_first_layer_pallas`
(shifu_tpu/ops/pallas_score.py:64,110). At the repo's wide NN shape
(C = 600, H = 512) the work is bound by f32 arithmetic (about 140
flops per byte moved), so the kernel is a tiled SIMT GEMM whose A-tile
load applies the normalize; the z matrix lives only in shared memory.

Routing has no knob: CUDA tensors launch the kernel (a failed build or
launch raises), CPU tensors take `fused_first_layer_plain`, the plain
PyTorch version of the same function. `launches` counts kernel launches.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from shifu_tpu_torch import _build
from shifu_tpu_torch.models import nn as nn_mod
from shifu_tpu_torch.ops.normalize import STD_EPS, zscore

__all__ = ["fused_first_layer", "fused_first_layer_plain", "score_nn",
           "launches"]

launches = 0  # kernel launches of this process (plain calls not counted)


def pack_norm(mean: torch.Tensor, std: torch.Tensor,
              cutoff: float) -> torch.Tensor:
    """(4, C) f32 block [mean, safe std, lo, hi] — `_pack_norm` of the
    TPU kernel. Columns with std < STD_EPS get lo = hi = mean and std 1,
    so the kernel's (clip(v) - mean) / std lands on exactly 0."""
    mean = mean.to(torch.float32)
    std = std.to(torch.float32)
    ok = std >= STD_EPS
    return torch.stack([
        mean,
        torch.where(ok, std, 1.0),
        torch.where(ok, mean - cutoff * std, mean),
        torch.where(ok, mean + cutoff * std, mean),
    ]).contiguous()


def fused_first_layer_plain(values: torch.Tensor, mean: torch.Tensor,
                            std: torch.Tensor, cutoff: float,
                            w: torch.Tensor,
                            b: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: `zscore` then an f32 matmul plus bias."""
    z = zscore(values.to(torch.float32), mean.to(torch.float32),
               std.to(torch.float32), cutoff)
    return torch.matmul(z, w.to(torch.float32)) + b.to(torch.float32)


def _check(values, mean, std, w, b) -> None:
    if values.dim() != 2:
        raise ValueError(f"values must be (N, C), got {tuple(values.shape)}")
    c = values.shape[1]
    if w.dim() != 2 or w.shape[0] != c:
        raise ValueError(f"w must be ({c}, H), got {tuple(w.shape)}")
    h = w.shape[1]
    if tuple(mean.shape) != (c,) or tuple(std.shape) != (c,):
        raise ValueError(f"mean/std must be ({c},), got "
                         f"{tuple(mean.shape)} / {tuple(std.shape)}")
    if tuple(b.shape) != (h,):
        raise ValueError(f"b must be ({h},), got {tuple(b.shape)}")
    devices = {t.device for t in (values, mean, std, w, b)}
    if len(devices) != 1:
        raise ValueError(f"inputs lie on several devices: {devices}")
    for name, t in (("values", values), ("w", w), ("b", b)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def fused_first_layer(values: torch.Tensor, mean: torch.Tensor,
                      std: torch.Tensor, cutoff: float, w: torch.Tensor,
                      b: torch.Tensor,
                      packed: Optional[torch.Tensor] = None
                      ) -> torch.Tensor:
    """(N, C) raw values → (N, H) ``zscore(values) @ w + b``. On a CUDA
    tensor this launches the kernel; on a CPU tensor it runs the plain
    version. `packed` is `pack_norm(mean, std, cutoff)` computed once
    by a caller that scores many batches (the service)."""
    _check(values, mean, std, w, b)
    if values.device.type == "cpu":
        return fused_first_layer_plain(values, mean, std, cutoff, w, b)
    if values.device.type != "cuda":
        raise ValueError(f"no kernel for device {values.device}")
    global launches
    lib = _lib()
    n, c = values.shape
    h = w.shape[1]
    norm = pack_norm(mean, std, float(cutoff)) if packed is None else packed
    if (tuple(norm.shape) != (4, c) or norm.device != values.device
            or norm.dtype != torch.float32 or not norm.is_contiguous()):
        raise ValueError(f"packed norm must be a contiguous float32 "
                         f"(4, {c}) block on {values.device}")
    out = torch.empty((n, h), dtype=torch.float32, device=values.device)
    stream = torch.cuda.current_stream(values.device).cuda_stream
    rc = lib.fused_score_launch(values.data_ptr(), norm.data_ptr(),
                                w.data_ptr(), b.data_ptr(), out.data_ptr(),
                                n, c, h, stream)
    _build.check(rc, "fused_score", lib.fused_score_error_string)
    launches += 1
    return out


def _lib() -> ctypes.CDLL:
    lib = _build.load("fused_score")
    if lib.fused_score_launch.argtypes is None:
        p = ctypes.c_void_p
        lib.fused_score_launch.argtypes = [p, p, p, p, p, ctypes.c_int,
                                           ctypes.c_int, ctypes.c_int, p]
        lib.fused_score_launch.restype = ctypes.c_int
        lib.fused_score_error_string.argtypes = [ctypes.c_int]
        lib.fused_score_error_string.restype = ctypes.c_char_p
    return lib


def score_nn(mlp, values: torch.Tensor, mean: torch.Tensor,
             std: torch.Tensor, cutoff: float,
             packed: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Full MLP forward over RAW inputs with the normalize and layer-0
    matmul fused (scoring only, f32 throughout) — mirrors
    `pallas_score.score_nn`; layers ≥ 1 are plain f32 `torch.matmul`."""
    spec = mlp.spec
    ws, bs = list(mlp.w), list(mlp.b)
    h = fused_first_layer(values, mean, std, cutoff, ws[0], bs[0], packed)
    if len(ws) == 1:
        out = h
    else:
        h = nn_mod.activation(spec.activations[0])(h)
        for i in range(1, len(ws) - 1):
            h = torch.matmul(h, ws[i]) + bs[i]
            h = nn_mod.activation(spec.activations[i])(h)
        out = torch.matmul(h, ws[-1]) + bs[-1]
    if spec.output_activation == "softmax":
        return torch.softmax(out, dim=-1)
    out = nn_mod.activation(spec.output_activation)(out)
    return out[..., 0] if spec.output_dim == 1 else out
