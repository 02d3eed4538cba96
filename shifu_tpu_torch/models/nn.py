"""Feed-forward NN for scoring — counterpart of `shifu_tpu/models/nn.py`.

`MLPSpec`, the activation table, and an inference-only `MLP` module
whose `forward` mirrors `nn.forward`: weights keep the JAX layout
(``w`` is (in, out)), the bfloat16 compute mode casts GEMM operands
and stored activations to bf16 while every product accumulates in f32,
and a softmax head serves multi-class models. Initialisation, losses
and optimizers belong to the training slice.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List

import numpy as np
import torch
from torch import nn


def _log_act(x: torch.Tensor) -> torch.Tensor:
    """Encog ActivationLOG: sign-symmetric log."""
    return torch.where(x >= 0, torch.log1p(x), -torch.log1p(-x))


ACTIVATIONS: Dict[str, Callable[[torch.Tensor], torch.Tensor]] = {
    "sigmoid": torch.sigmoid,
    "tanh": torch.tanh,
    "relu": torch.relu,
    "leakyrelu": lambda x: torch.nn.functional.leaky_relu(x, 0.01),
    "swish": lambda x: x * torch.sigmoid(x),
    "gaussian": lambda x: torch.exp(-torch.square(x)),
    "log": _log_act,
    "sin": torch.sin,
    "linear": lambda x: x,
    "ptanh": torch.tanh,  # reference alias
}


def activation(name: str) -> Callable[[torch.Tensor], torch.Tensor]:
    fn = ACTIVATIONS.get(str(name).lower())
    if fn is None:
        raise ValueError(f"unknown ActivationFunc {name!r}; known: "
                         f"{sorted(ACTIVATIONS)}")
    return fn


@dataclass(frozen=True)
class MLPSpec:
    """Static architecture, as saved in a spec's ``meta["spec"]``."""
    input_dim: int
    hidden_dims: tuple
    activations: tuple
    output_dim: int = 1
    output_activation: str = "sigmoid"
    dropout_rate: float = 0.0
    l2: float = 0.0
    l1: float = 0.0
    loss: str = "squared"
    weight_init: str = "xavier"
    compute_dtype: str = "float32"

    @classmethod
    def from_meta(cls, spec: Dict) -> "MLPSpec":
        sd = dict(spec)
        sd["hidden_dims"] = tuple(sd.get("hidden_dims", ()))
        sd["activations"] = tuple(sd.get("activations", ()))
        return cls(**sd)

    @property
    def layer_dims(self) -> List[int]:
        return [self.input_dim] + list(self.hidden_dims) + [self.output_dim]


def mm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Matmul that accumulates in f32 whatever the operand type: bf16
    operands are widened exactly, so the product is that of the bf16
    values and never rounds to bf16 (`preferred_element_type=f32`)."""
    return torch.matmul(a.to(torch.float32), b.to(torch.float32))


class MLP(nn.Module):
    """Inference-only MLP over the JAX parameter list
    ``[{"w": (in, out), "b": (out,)}, ...]``."""

    def __init__(self, spec: MLPSpec, layers: List[Dict[str, np.ndarray]]):
        super().__init__()
        if len(layers) != len(spec.layer_dims) - 1:
            raise ValueError(f"{len(layers)} layers for dims "
                             f"{spec.layer_dims}")
        self.spec = spec

        def param(a) -> nn.Parameter:
            return nn.Parameter(torch.tensor(np.asarray(a, np.float32)),
                                requires_grad=False)

        self.w = nn.ParameterList([param(l["w"]) for l in layers])
        self.b = nn.ParameterList([param(l["b"]) for l in layers])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        spec = self.spec
        bf16 = spec.compute_dtype == "bfloat16"

        def cast(a: torch.Tensor) -> torch.Tensor:
            return a.to(torch.bfloat16) if bf16 else a

        h = cast(x)
        for i in range(len(self.w) - 1):
            h = mm_f32(h, cast(self.w[i])) + self.b[i]
            h = activation(spec.activations[i])(h)
            h = cast(h)
        out = mm_f32(h, cast(self.w[-1])) + self.b[-1]
        if spec.output_activation == "softmax":
            return torch.softmax(out, dim=-1)
        out = activation(spec.output_activation)(out)
        return out[..., 0] if spec.output_dim == 1 else out
