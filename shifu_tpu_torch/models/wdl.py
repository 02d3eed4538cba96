"""Wide-and-Deep — counterpart of `shifu_tpu/models/wdl.py`
(`wdl/WideAndDeep.java:78-249`).

The params keep the JAX package's layout: ``embed`` (Cc, V, E), every
categorical column's embedding table stacked into one tensor;
``wide_cat`` (Cc, V) and ``wide_dense`` (Dd,) and ``wide_bias`` (), the
wide part; ``deep``, the MLP's layer list over [dense ⊕ flattened
embeddings]. The output is sigmoid(wide logit + deep logit), trained
with log loss; L2 covers the deep weights and ``embed``, never the wide
tables. Inputs are the *_INDEX norm families' two blocks: an f32 dense
block and an int32 index block (missing category = the vocab_len slot),
each index clamped into [0, V).

As in `models/nn.py`, every function takes one model's params or
bag-stacked ones (a leading bag axis on every tensor, ``wide_bias``
then (B,)) and returns (N,) or (B, N). The lookups run as one
`F.embedding` over the tables flattened to (B·Cc·V, E) rows — row
``(b·Cc + c)·V + idx`` is ``embed[b, c, idx]`` — so the gradient of a
table is the embedding backward's sum per id: ids no row uses get a
zero gradient. The deep trunk is the port's `nn.forward` (its bf16
`ComputeDtype` included); embeddings, the wide logit and the loss stay
f32.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from shifu_tpu_torch import resolve_device
from shifu_tpu_torch.models import nn as nn_mod


@dataclass(frozen=True)
class WDLSpec:
    dense_dim: int
    n_cat: int
    vocab_size: int               # padded per-column vocab incl. missing slot
    embed_size: int = 8
    hidden_dims: tuple = (64, 32)
    activations: tuple = ("relu", "relu")
    l2: float = 0.0
    wide_enable: bool = True
    deep_enable: bool = True
    compute_dtype: str = "float32"

    @classmethod
    def from_train_params(cls, params: Dict[str, Any], dense_dim: int,
                          n_cat: int, vocab_size: int) -> "WDLSpec":
        get = nn_mod.param_getter(params)
        nodes, acts = nn_mod.parse_arch_params(
            params, default_nodes=(64, 32), default_acts=("relu",),
            honor_num_layers=False)
        return cls(
            dense_dim=dense_dim, n_cat=n_cat, vocab_size=vocab_size,
            embed_size=int(get("EmbedSize", get("EmbedColumnNum", 8) or 8)
                           or 8),
            hidden_dims=nodes, activations=acts,
            l2=float(get("RegularizedConstant", 0.0) or 0.0),
            wide_enable=bool(get("WideEnable", True)),
            deep_enable=bool(get("DeepEnable", True)),
            compute_dtype=nn_mod.resolve_compute_dtype(
                get("ComputeDtype"), model_knob=None))

    @classmethod
    def from_meta(cls, spec: Dict[str, Any]) -> "WDLSpec":
        return cls(**{**spec, "hidden_dims": tuple(spec["hidden_dims"]),
                      "activations": tuple(spec["activations"])})

    @property
    def deep_input_dim(self) -> int:
        return self.dense_dim + self.n_cat * self.embed_size

    @property
    def deep_spec(self) -> nn_mod.MLPSpec:
        return nn_mod.MLPSpec(
            input_dim=self.deep_input_dim, hidden_dims=self.hidden_dims,
            activations=self.activations, output_dim=1,
            output_activation="linear", compute_dtype=self.compute_dtype)


def init_params(spec: WDLSpec, generator: torch.Generator
                ) -> Dict[str, Any]:
    """One model's initial params, drawn from `generator` (on its
    device): embeddings N(0, 0.05²), wide tables zero, the deep MLP by
    `nn.init_params`."""
    dev = generator.device
    params: Dict[str, Any] = {}
    if spec.n_cat:
        params["embed"] = torch.randn(
            (spec.n_cat, spec.vocab_size, spec.embed_size),
            generator=generator, device=dev) * 0.05
        params["wide_cat"] = torch.zeros((spec.n_cat, spec.vocab_size),
                                         device=dev)
    params["wide_dense"] = torch.zeros(spec.dense_dim, device=dev)
    params["wide_bias"] = torch.zeros((), device=dev)
    params["deep"] = nn_mod.init_params(spec.deep_spec, generator)
    return params


def _lookup(table: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """(B, Cc, V, E) or (B, Cc, V) tables at the (N, Cc) clamped ids →
    (B, N, Cc, E) or (B, N, Cc)."""
    n_bags, n_cat, vocab = table.shape[:3]
    flat = table.reshape(n_bags * n_cat * vocab, -1)
    base = (torch.arange(n_bags, device=rows.device)[:, None] * n_cat
            + torch.arange(n_cat, device=rows.device)[None, :]) * vocab
    out = F.embedding(base[:, None, :] + rows[None], flat)
    return out if table.dim() == 4 else out[..., 0]


def forward(spec: WDLSpec, params: Dict[str, Any], dense: torch.Tensor,
            idx: torch.Tensor) -> torch.Tensor:
    """(N, Dd) dense + (N, Cc) int indices → (N,) probabilities, or
    (B, N) for bag-stacked params."""
    stacked = params["wide_bias"].dim() == 1
    if not stacked:
        params = _stack1(params)
    n_bags = params["wide_bias"].shape[0]
    n = dense.shape[0] if spec.dense_dim else idx.shape[0]
    dev = params["wide_bias"].device
    logit = torch.zeros((n_bags, n), device=dev)
    deep_in = [dense.to(torch.float32).expand(n_bags, n, spec.dense_dim)] \
        if spec.dense_dim else []
    if spec.n_cat:
        safe = torch.clamp(idx.to(dev, torch.int64), 0, spec.vocab_size - 1)
        if spec.wide_enable:
            logit = logit + _lookup(params["wide_cat"], safe).sum(dim=2)
        emb = _lookup(params["embed"], safe)               # (B, N, Cc, E)
        deep_in.append(emb.reshape(n_bags, n, -1))
    if spec.wide_enable and spec.dense_dim:
        logit = logit + nn_mod.mm_f32(
            params["wide_dense"], dense.to(torch.float32).T)
    logit = logit + params["wide_bias"][:, None]
    if spec.deep_enable and deep_in:
        logit = logit + nn_mod.forward(spec.deep_spec, params["deep"],
                                       torch.cat(deep_in, dim=2))
    p = torch.sigmoid(logit)
    return p if stacked else p[0]


def _stack1(params: Dict[str, Any]) -> Dict[str, Any]:
    out = {k: v[None] for k, v in params.items() if k != "deep"}
    out["deep"] = [{k: v[None] for k, v in layer.items()}
                   for layer in params["deep"]]
    return out


def _bag_sum_sq(t: torch.Tensor, stacked: bool) -> torch.Tensor:
    return torch.sum(torch.square(t), dim=tuple(range(1 if stacked else 0,
                                                      t.dim())))


def loss_fn(spec: WDLSpec, params, dense, idx, y, w) -> torch.Tensor:
    """Weighted cross-entropy + L2, per bag for bag-stacked params (w
    then (B, N))."""
    p = forward(spec, params, dense, idx)
    eps = 1e-7
    per = -(y * torch.log(p + eps) + (1 - y) * torch.log(1 - p + eps))
    loss = torch.sum(per * w, dim=-1) / torch.clamp_min(
        torch.sum(w, dim=-1), 1e-12)
    if spec.l2 > 0:
        stacked = params["wide_bias"].dim() == 1
        reg = sum(_bag_sum_sq(l["w"], stacked) for l in params["deep"])
        if spec.n_cat:
            reg = reg + _bag_sum_sq(params["embed"], stacked)
        loss = loss + spec.l2 * reg
    return loss


def mse(spec: WDLSpec, params, dense, idx, y, w) -> torch.Tensor:
    p = forward(spec, params, dense, idx)
    return torch.sum(torch.square(y - p) * w, dim=-1) / torch.clamp_min(
        torch.sum(w, dim=-1), 1e-12)


class WDLModel:
    """A scoring WDL model (`weights.to_torch`): the spec and one
    model's params as tensors on one device."""

    def __init__(self, meta: Dict[str, Any], params: Any,
                 device: torch.device):
        self.spec = WDLSpec.from_meta(meta["spec"])
        self.device = resolve_device(device)
        self.params = _tree(params, self.device)

    @torch.inference_mode()
    def __call__(self, dense, idx) -> torch.Tensor:
        spec = self.spec
        n = (dense.shape[0] if dense is not None else idx.shape[0])
        d = torch.as_tensor(dense if dense is not None
                            else np.zeros((n, 0), np.float32),
                            dtype=torch.float32, device=self.device)
        i = torch.as_tensor(idx if idx is not None
                            else np.zeros((n, 0), np.int32),
                            device=self.device)
        return forward(spec, self.params, d, i)


def _tree(params: Any, device: torch.device) -> Any:
    if isinstance(params, dict):
        return {k: _tree(v, device) for k, v in params.items()}
    if isinstance(params, (list, tuple)):
        return [_tree(v, device) for v in params]
    return torch.as_tensor(np.asarray(params, np.float32), device=device)


def predict(meta: Dict[str, Any], params: Any, dense: Optional[np.ndarray],
            idx: Optional[np.ndarray],
            device: "str | torch.device" = "cuda") -> np.ndarray:
    """(N,) scores of one saved model (numpy params) on `device`."""
    return WDLModel(meta, params, device)(dense, idx).cpu().numpy()
