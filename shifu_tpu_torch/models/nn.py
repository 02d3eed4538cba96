"""Feed-forward NN — counterpart of `shifu_tpu/models/nn.py`.

`MLPSpec` (with `from_train_params` over `train#params`), the
activation table, the weight initialisers, continuous training's
`compare_structure` / `absorb_params`, and two forwards over the JAX
parameter layout (``w`` is (in, out)):

- the functional `forward` / `loss_fn` / `mse` the trainer
  differentiates, over a list ``[{"w", "b"}, ...]`` of tensors that are
  either one network's ((in, out), (out,)) or bag-stacked ((B, in, out),
  (B, out)): the bags' products are one GEMM over the shared rows for
  the first layer and `torch.bmm` after it, so every bag trains in one
  pass (the JAX package's `vmap`), and the losses come back per bag;
- the inference-only `MLP` module the scorer and kernel K1 read.

The bfloat16 compute mode casts GEMM operands and stored activations
to bf16 while every product accumulates in f32 (the operands are
widened exactly), and a softmax head serves multi-class models.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch
from torch import nn

from shifu_tpu_torch.config.environment import knob_is_set, knob_str

Params = List[Dict[str, torch.Tensor]]


def resolve_compute_dtype(explicit: Optional[str] = None,
                          model_knob: Optional[str] =
                          "SHIFU_TPU_NN_COMPUTE") -> str:
    """One precedence chain for the mixed-precision dtype: explicit
    train#params ComputeDtype > the model-family env knob (set) >
    package-wide SHIFU_TPU_COMPUTE_DTYPE > float32. Returns the
    normalized name ("float32" | "bfloat16")."""
    cd = explicit
    if cd is None and model_knob and knob_is_set(model_knob):
        cd = knob_str(model_knob)
    if cd is None:
        cd = knob_str("SHIFU_TPU_COMPUTE_DTYPE")
    cd = str(cd or "float32").lower()
    return "bfloat16" if cd in ("bf16", "bfloat16") else "float32"


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


def param_getter(params: Dict[str, Any]):
    """Case-insensitive train#params lookup (reference keys are
    TitleCase: NumHiddenLayers, LearningRate, ...)."""
    def get(key, default=None):
        for k, v in params.items():
            if k.lower() == key.lower():
                return v
        return default
    return get


def parse_arch_params(params: Dict[str, Any],
                      default_nodes=(50,), default_acts=("tanh",),
                      honor_num_layers: bool = True):
    """Normalize NumHiddenNodes / ActivationFunc lists (scalars become
    one-element lists; short lists repeat their tail; NumHiddenLayers
    truncates/extends when honored). Returns (nodes, acts)."""
    get = param_getter(params)
    nodes = get("NumHiddenNodes", list(default_nodes))
    acts = get("ActivationFunc", list(default_acts))
    if not isinstance(nodes, list):
        nodes = [nodes]
    if not isinstance(acts, list):
        acts = [acts]
    nodes = [int(n) for n in nodes]
    acts = [str(a) for a in acts]
    if honor_num_layers:
        n_layers = int(get("NumHiddenLayers", len(nodes)) or 0)
        nodes = nodes[:n_layers]
        acts = acts[:n_layers]
        while len(nodes) < n_layers:
            nodes.append(nodes[-1] if nodes else int(default_nodes[0]))
    while len(acts) < len(nodes):
        acts.append(acts[-1] if acts else str(default_acts[0]))
    return tuple(nodes), tuple(acts[:len(nodes)])


@dataclass(frozen=True)
class MLPSpec:
    """Static architecture, derived from train#params or saved in a
    spec's ``meta["spec"]``."""
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
    def from_train_params(cls, params: Dict[str, Any], input_dim: int,
                          output_dim: int = 1) -> "MLPSpec":
        get = param_getter(params)
        nodes, acts = parse_arch_params(params)
        reg = float(get("RegularizedConstant", 0.0) or 0.0)
        l1orl2 = str(get("L1orL2", "L2") or "L2").upper()
        return cls(
            input_dim=input_dim, hidden_dims=nodes,
            activations=acts, output_dim=output_dim,
            dropout_rate=float(get("DropoutRate", 0.0) or 0.0),
            l2=reg if l1orl2 != "L1" else 0.0,
            l1=reg if l1orl2 == "L1" else 0.0,
            loss=str(get("Loss", "squared") or "squared").lower(),
            weight_init=str(get("WeightInitializer", "xavier")
                            or "xavier").lower(),
            compute_dtype=resolve_compute_dtype(get("ComputeDtype")),
        )

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


def init_params(spec: MLPSpec, generator: torch.Generator) -> Params:
    """Weight init families from `core/dtrain/random/*` (Xavier/He/Lecun
    + uniform default), the JAX package's distributions drawn from
    `generator` (on its device); biases start at zero."""
    params: Params = []
    dims = spec.layer_dims
    dev = generator.device
    for fan_in, fan_out in zip(dims[:-1], dims[1:]):
        shape = (fan_in, fan_out)
        if spec.weight_init == "he":
            w = torch.randn(shape, generator=generator, device=dev) \
                * math.sqrt(2.0 / fan_in)
        elif spec.weight_init == "lecun":
            w = torch.randn(shape, generator=generator, device=dev) \
                * math.sqrt(1.0 / fan_in)
        elif spec.weight_init == "zero":
            w = torch.zeros(shape, device=dev)
        else:  # xavier / default
            limit = math.sqrt(6.0 / (fan_in + fan_out))
            u = torch.rand(shape, generator=generator, device=dev)
            w = -limit + 2.0 * limit * u
        params.append({"w": w.to(torch.float32),
                       "b": torch.zeros(fan_out, device=dev)})
    return params


def compare_structure(old_dims: Sequence[int],
                      new_dims: Sequence[int]) -> int:
    """0 = identical, 1 = the new network can absorb the old one, -1 =
    it cannot (`NNStructureComparator.compare` with
    `TrainModelProcessor.inputOutputModelCheckSuccess`'s equal output
    counts). `*_dims` are forward-order widths [input, *hidden, output];
    old layer i aligns with new layer i (extra new layers sit nearest the
    output) and every aligned old width must fit."""
    old, new = list(old_dims), list(new_dims)
    if old == new:
        return 0
    if len(new) < len(old) or new[-1] != old[-1]:
        return -1
    ok = all(new[i] >= old[i] for i in range(len(old)))
    return 1 if ok else -1


def absorb_params(old_params, new_params: Params,
                  fixed_layers: Optional[Sequence[int]] = None,
                  fixed_bias: bool = True):
    """Fit a smaller trained network into a freshly initialized larger
    one (`NNMaster.fitExistingModelIn:644-684`): each old layer's weights
    copy into the top-left corner of the aligned new layer, biases into
    the leading slots, and the cross-block rows ``w[old_in:, :old_out]``
    are zeroed so that same-depth growth starts as an exact functional
    copy of the old model. Returns (params, grad_mask): the mask zeros
    the absorbed positions of the 1-based `fixed_layers` (the grown part
    of a fixed layer still trains)."""
    params = [{k: v.clone() for k, v in layer.items()}
              for layer in new_params]
    grad_mask = [{k: torch.ones_like(v) for k, v in layer.items()}
                 for layer in new_params]
    fixed = {int(f) for f in (fixed_layers or ())}
    for i, old_layer in enumerate(old_params):
        w_old = torch.as_tensor(np.asarray(old_layer["w"], np.float32))
        oi, oo = w_old.shape
        w = params[i]["w"]
        w[:oi, :oo] = w_old.to(w.device)
        w[oi:, :oo] = 0.0
        params[i]["b"][:oo] = torch.as_tensor(
            np.asarray(old_layer["b"], np.float32)).to(w.device)
        if (i + 1) in fixed:
            grad_mask[i]["w"][:oi, :oo] = 0.0
            if fixed_bias:
                grad_mask[i]["b"][:oo] = 0.0
    return params, grad_mask


def _mm(h: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``h @ w`` accumulated in f32 for a shared (N, in) or per-bag
    (B, N, in) `h` and an (in, out) or bag-stacked (B, in, out) `w`.
    Shared rows against stacked weights are one GEMM over the bags'
    concatenated columns, so the rows are read once for every bag."""
    if h.dim() == 2 and w.dim() == 3:
        n_bags, n_in, n_out = w.shape
        cat = w.to(torch.float32).permute(1, 0, 2).reshape(n_in,
                                                           n_bags * n_out)
        out = mm_f32(h, cat)
        return out.reshape(h.shape[0], n_bags, n_out).transpose(0, 1)
    return mm_f32(h, w)


def _bias(layer: Dict[str, torch.Tensor]) -> torch.Tensor:
    b = layer["b"]
    return b.unsqueeze(-2) if layer["w"].dim() == 3 else b


def forward(spec: MLPSpec, params: Params, x: torch.Tensor,
            generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Batched forward → (N,) scores for one network, (B, N) for
    bag-stacked params ((…, C) for a multi-class head). With a
    `generator` and a dropout rate, each hidden unit is kept with
    probability 1 − p and scaled by 1/(1 − p) (train time only,
    `NNMaster.doCompute:323`)."""
    bf16 = spec.compute_dtype == "bfloat16"

    def cast(a: torch.Tensor) -> torch.Tensor:
        return a.to(torch.bfloat16) if bf16 else a

    h = cast(x)
    for i, layer in enumerate(params[:-1]):
        h = _mm(h, cast(layer["w"])) + _bias(layer)
        h = activation(spec.activations[i])(h)
        if generator is not None and spec.dropout_rate > 0.0:
            keep = torch.rand(h.shape, generator=generator,
                              device=h.device) < 1.0 - spec.dropout_rate
            h = torch.where(keep, h / (1.0 - spec.dropout_rate),
                            torch.zeros((), dtype=h.dtype, device=h.device))
        h = cast(h)
    out = _mm(h, cast(params[-1]["w"])) + _bias(params[-1])
    if spec.output_activation == "softmax":
        return torch.softmax(out, dim=-1)
    out = activation(spec.output_activation)(out)
    return out[..., 0] if spec.output_dim == 1 else out


def _regularized(spec: MLPSpec, params: Params,
                 loss: torch.Tensor) -> torch.Tensor:
    """`Weight.java`'s L1/L2 terms, each bag over its own weights."""
    if spec.l2 > 0.0:
        loss = loss + spec.l2 * sum(torch.sum(torch.square(p["w"]),
                                              dim=(-2, -1)) for p in params)
    if spec.l1 > 0.0:
        loss = loss + spec.l1 * sum(torch.sum(torch.abs(p["w"]),
                                              dim=(-2, -1)) for p in params)
    return loss


def _onehot(spec: MLPSpec, y: torch.Tensor) -> torch.Tensor:
    """One-hot of the class indices; an index outside [0, C) is all
    zeros, as `jax.nn.one_hot` makes it. A comparison, not
    `F.one_hot`, whose range check would read the card from the host."""
    classes = torch.arange(spec.output_dim, device=y.device)
    return (y.to(torch.int64).unsqueeze(-1) == classes).to(torch.float32)


def loss_fn(spec: MLPSpec, params: Params, x: torch.Tensor, y: torch.Tensor,
            w: torch.Tensor,
            generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Weighted loss (`core/dtrain/loss/*`: squared / log / absolute; a
    multi-class head takes cross-entropy or Brier over the one-hot class
    indices) normalized by the weight sum, plus L1/L2. For bag-stacked
    params `w` is (B, N) and the result is each bag's loss, (B,): their
    sum differentiates to every bag's own gradient."""
    pred = forward(spec, params, x, generator)
    if spec.output_dim > 1:
        onehot = _onehot(spec, y)
        if spec.loss.startswith("log"):
            per = -torch.sum(onehot * torch.log(pred + 1e-7), dim=-1)
        else:
            per = 0.5 * torch.sum(torch.square(onehot - pred), dim=-1)
    elif spec.loss.startswith("log"):
        eps = 1e-7
        per = -(y * torch.log(pred + eps)
                + (1 - y) * torch.log(1 - pred + eps))
    elif spec.loss.startswith("abs"):
        per = torch.abs(y - pred)
    else:
        per = 0.5 * torch.square(y - pred)
    total_w = torch.clamp_min(torch.sum(w, dim=-1), 1e-12)
    return _regularized(spec, params, torch.sum(per * w, dim=-1) / total_w)


def mse(spec: MLPSpec, params: Params, x: torch.Tensor, y: torch.Tensor,
        w: torch.Tensor) -> torch.Tensor:
    """Validation error — the reference reports mean squared error per
    epoch whatever the training loss (NNMaster trainError); per bag for
    bag-stacked params."""
    pred = forward(spec, params, x)
    total_w = torch.clamp_min(torch.sum(w, dim=-1), 1e-12)
    if spec.output_dim > 1:
        per = torch.mean(torch.square(_onehot(spec, y) - pred), dim=-1)
        return torch.sum(per * w, dim=-1) / total_w
    return torch.sum(torch.square(y - pred) * w, dim=-1) / total_w


def num_params(spec: MLPSpec) -> int:
    dims = spec.layer_dims
    return sum(dims[i] * dims[i + 1] + dims[i + 1]
               for i in range(len(dims) - 1))


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
