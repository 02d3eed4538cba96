"""Multi-task learning — counterpart of `shifu_tpu/models/mtl.py`
(`mtl/MultiTaskModel.java:72-219`): a shared trunk and one logistic
head a task; targetColumnName with '|'-separated names makes a set
multi-task.

The params keep the JAX package's layout: ``trunk`` (the port's
`nn` layer list; the last hidden width is the trunk's output, its
activation the trunk's output activation), ``heads_w`` (T, H) and
``heads_b`` (T,). Every function takes one model's params or
bag-stacked ones (a leading bag axis) and returns (N, T) or (B, N, T)
probabilities; the heads' product goes through `nn.mm_f32` (bf16
operands under the bf16 `ComputeDtype`). A NaN label (a task the row
has no tag for) adds nothing to the loss or the metric; it is replaced
before the log, so no NaN reaches the gradient.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, Optional

import numpy as np
import torch

from shifu_tpu_torch import resolve_device
from shifu_tpu_torch.models import nn as nn_mod


@dataclass(frozen=True)
class MTLSpec:
    input_dim: int
    n_tasks: int
    hidden_dims: tuple = (64, 32)
    activations: tuple = ("relu", "relu")
    l2: float = 0.0
    compute_dtype: str = "float32"

    @classmethod
    def from_train_params(cls, params: Dict[str, Any], input_dim: int,
                          n_tasks: int) -> "MTLSpec":
        get = nn_mod.param_getter(params)
        nodes, acts = nn_mod.parse_arch_params(
            params, default_nodes=(64, 32), default_acts=("relu",),
            honor_num_layers=False)
        return cls(input_dim=input_dim, n_tasks=n_tasks,
                   hidden_dims=nodes, activations=acts,
                   l2=float(get("RegularizedConstant", 0.0) or 0.0),
                   compute_dtype=nn_mod.resolve_compute_dtype(
                       get("ComputeDtype"), model_knob=None))

    @classmethod
    def from_meta(cls, spec: Dict[str, Any]) -> "MTLSpec":
        return cls(**{**spec, "hidden_dims": tuple(spec["hidden_dims"]),
                      "activations": tuple(spec["activations"])})

    @property
    def trunk_out(self) -> int:
        return self.hidden_dims[-1] if self.hidden_dims else self.input_dim

    @property
    def trunk_spec(self) -> nn_mod.MLPSpec:
        return nn_mod.MLPSpec(
            input_dim=self.input_dim,
            hidden_dims=self.hidden_dims[:-1] if self.hidden_dims else (),
            activations=self.activations[:-1] if self.hidden_dims else (),
            output_dim=self.trunk_out,
            output_activation=self.activations[-1] if self.hidden_dims
            else "linear",
            compute_dtype=self.compute_dtype)


def init_params(spec: MTLSpec, generator: torch.Generator
                ) -> Dict[str, Any]:
    """One model's initial params from `generator`: the trunk by
    `nn.init_params`, heads N(0, 1/H), head biases zero."""
    dev = generator.device
    trunk = nn_mod.init_params(spec.trunk_spec, generator)
    heads_w = torch.randn((spec.n_tasks, spec.trunk_out),
                          generator=generator, device=dev) \
        * (1.0 / math.sqrt(spec.trunk_out))
    return {"trunk": trunk, "heads_w": heads_w,
            "heads_b": torch.zeros(spec.n_tasks, device=dev)}


def forward(spec: MTLSpec, params: Dict[str, Any],
            x: torch.Tensor) -> torch.Tensor:
    """(N, D) → (N, T) per-task probabilities, (B, N, T) bag-stacked."""
    h = nn_mod.forward(spec.trunk_spec, params["trunk"], x)
    if spec.trunk_out == 1:
        h = h.unsqueeze(-1)   # nn.forward drops a width-1 output axis
    hw = params["heads_w"].transpose(-1, -2)
    if spec.compute_dtype == "bfloat16":
        h, hw = h.to(torch.bfloat16), hw.to(torch.bfloat16)
    logits = nn_mod.mm_f32(h, hw) + params["heads_b"].unsqueeze(-2)
    return torch.sigmoid(logits)


def _masked(y: torch.Tensor):
    valid = ~torch.isnan(y)
    return valid, torch.where(valid, y, torch.zeros((), device=y.device))


def _bag_sum_sq(t: torch.Tensor, stacked: bool) -> torch.Tensor:
    return torch.sum(torch.square(t), dim=tuple(range(1 if stacked else 0,
                                                      t.dim())))


def loss_fn(spec: MTLSpec, params, x, y, w) -> torch.Tensor:
    """Sum of the tasks' weighted cross-entropies over the labelled
    cells, divided by their weight; per bag for bag-stacked params (w
    then (B, N))."""
    p = forward(spec, params, x)
    eps = 1e-7
    valid, ys = _masked(y)
    per = -(ys * torch.log(p + eps) + (1 - ys) * torch.log(1 - p + eps))
    per = torch.where(valid, per, torch.zeros((), device=p.device)) \
        * w.unsqueeze(-1)
    mass = torch.sum(valid * w.unsqueeze(-1), dim=(-2, -1))
    loss = torch.sum(per, dim=(-2, -1)) / torch.clamp_min(mass, 1e-12)
    if spec.l2 > 0:
        stacked = params["heads_w"].dim() == 3
        reg = sum(_bag_sum_sq(l["w"], stacked) for l in params["trunk"])
        loss = loss + spec.l2 * (reg + _bag_sum_sq(params["heads_w"],
                                                   stacked))
    return loss


def error_sum(spec: MTLSpec, params, x, y, w) -> torch.Tensor:
    """The masked weighted squared error summed over rows and tasks
    (`mse`'s numerator)."""
    p = forward(spec, params, x)
    valid, ys = _masked(y)
    err = torch.where(valid, torch.square(ys - p),
                      torch.zeros((), device=p.device))
    return torch.sum(err * w.unsqueeze(-1), dim=(-2, -1))


def labelled_mass(y: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """`mse`'s denominator: the weight of the labelled cells."""
    return torch.sum((~torch.isnan(y)) * w.unsqueeze(-1), dim=(-2, -1))


def mse(spec: MTLSpec, params, x, y, w) -> torch.Tensor:
    return error_sum(spec, params, x, y, w) / torch.clamp_min(
        labelled_mass(y, w), 1e-12)


class MTLModel:
    """A scoring MTL model (`weights.to_torch`): the spec and one
    model's params as tensors on one device. Calling it gives the mean
    over tasks (N,), `tasks` the (N, T) probabilities."""

    def __init__(self, meta: Dict[str, Any], params: Any,
                 device: torch.device):
        from shifu_tpu_torch.models.wdl import _tree
        self.spec = MTLSpec.from_meta(meta["spec"])
        self.device = resolve_device(device)
        self.params = _tree(params, self.device)

    @torch.inference_mode()
    def tasks(self, dense) -> torch.Tensor:
        x = torch.as_tensor(dense, dtype=torch.float32, device=self.device)
        return forward(self.spec, self.params, x)

    def __call__(self, dense, idx=None) -> torch.Tensor:
        return self.tasks(dense).mean(dim=1)


def predict(meta: Dict[str, Any], params: Any, dense: np.ndarray,
            idx: Optional[np.ndarray] = None,
            device: "str | torch.device" = "cuda") -> np.ndarray:
    """(N,) mean-over-tasks score of one saved model on `device`."""
    return MTLModel(meta, params, device)(dense).cpu().numpy()


def predict_tasks(meta: Dict[str, Any], params: Any, dense: np.ndarray,
                  device: "str | torch.device" = "cuda") -> np.ndarray:
    return MTLModel(meta, params, device).tasks(dense).cpu().numpy()
