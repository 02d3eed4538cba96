"""Optimizer mapping: Shifu `Propagation` codes → update rules over
bag-stacked tensors — the port of `shifu_tpu/train/optimizers.py`.

The reference's master-side weight updater (`core/dtrain/Weight.java:
33,122-190`) implements BackProp(B) / QuickProp(Q) / Resilient(R) /
ADAM / AdaGrad / RMSProp / Momentum(M) / Nesterov(N), applied once per
iteration to the aggregated gradient. Here each rule is an `Optimizer`:
`init(params)` → state, `update(grads, state)` → (updates, state), over
lists of tensors whose first axis is the bag. The state is a dict of
tensors, every one of them bag-first, its step `count` (B,) included,
so a stopped bag can freeze all of it (`freeze`). The JAX package runs
optax 0.2.6's transforms; these functions are the same arithmetic op
for op (adam's eps outside the root and bias correction by count;
adagrad's 0.1 start and `where(acc > 0, rsqrt(acc + 1e-7), 0)`;
rmsprop's `rsqrt(nu + 1e-8)` from a zero start; momentum's
``g + m·trace``) — `torch.optim`'s adagrad and rmsprop differ. No
update reads a tensor on the host or copies one to the card, so an
epoch's updates queue on the card without a sync. RPROP
and QuickProp keep the reference's constants (initial delta 0.1,
eta+ 1.2 / eta− 0.5, max step 50; growth cap 1.75).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, NamedTuple, Tuple

import torch

Tensors = List[torch.Tensor]
State = Dict[str, Any]


class Optimizer(NamedTuple):
    init: Callable[[Tensors], State]
    update: Callable[[Tensors, State], Tuple[Tensors, State]]


def _bags(mask: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """A (B,) per-bag tensor shaped to broadcast against a bag-first
    tensor."""
    return mask.reshape(mask.shape + (1,) * (like.dim() - 1))


def _count(params: Tensors) -> torch.Tensor:
    return torch.zeros(params[0].shape[0], dtype=torch.int32,
                       device=params[0].device)


def freeze(stopped: torch.Tensor, new: State, old: State) -> State:
    """The state of every bag in `stopped` (B,) stays `old`, its count
    included (`jnp.where(stopped, old, new)` over the whole optimizer
    state, as the JAX trainer does)."""
    out: State = {}
    for k, v in new.items():
        if isinstance(v, list):
            out[k] = [torch.where(_bags(stopped, a), b, a)
                      for a, b in zip(v, old[k])]
        else:
            out[k] = torch.where(_bags(stopped, v), old[k], v)
    return out


def rprop(init_delta: float = 0.1, eta_plus: float = 1.2,
          eta_minus: float = 0.5, max_delta: float = 50.0,
          min_delta: float = 1e-6) -> Optimizer:
    """iRPROP− (`Weight.java` RESILIENTPROPAGATION branch; Encog
    ResilientPropagation constants). Sign-driven per-weight step sizes;
    the learning rate is ignored, as in the reference."""

    def init(params):
        return {"count": _count(params),
                "deltas": [torch.full_like(p, init_delta) for p in params],
                "prev_grad": [torch.zeros_like(p) for p in params]}

    def update(grads, state):
        deltas, prev, updates = [], [], []
        for g, d, gp in zip(grads, state["deltas"], state["prev_grad"]):
            sign = g * gp
            nd = torch.where(sign > 0, torch.clamp_max(d * eta_plus, max_delta),
                             torch.where(sign < 0,
                                         torch.clamp_min(d * eta_minus,
                                                         min_delta), d))
            eff = torch.where(sign < 0, torch.zeros_like(g), g)
            deltas.append(nd)
            prev.append(eff)
            updates.append(-torch.sign(eff) * nd)
        return updates, {"count": state["count"] + 1, "deltas": deltas,
                         "prev_grad": prev}

    return Optimizer(init, update)


def quickprop(learning_rate: float, max_growth: float = 1.75) -> Optimizer:
    """QuickProp (`Weight.java` QUICKPROPAGATION branch; Fahlman 1988):
    quadratic step dw = dw_prev · g / (g_prev − g), growth-capped, with
    gradient-descent fallback on a bag's first step or an unstable
    denominator."""

    def init(params):
        return {"count": _count(params),
                "prev_grad": [torch.zeros_like(p) for p in params],
                "prev_update": [torch.zeros_like(p) for p in params]}

    def update(grads, state):
        first = state["count"] == 0
        updates = []
        for g, gp, up in zip(grads, state["prev_grad"],
                             state["prev_update"]):
            denom = gp - g
            small = torch.abs(denom) < 1e-12
            quick = up * g / torch.where(small, torch.full_like(denom, 1e-12),
                                         denom)
            cap = torch.clamp_min(torch.abs(up) * max_growth, 1e-12)
            quick = torch.clamp(quick, -cap, cap)
            use_gd = _bags(first, g) | (torch.abs(up) < 1e-12) | small
            updates.append(torch.where(use_gd, -learning_rate * g, quick))
        return updates, {"count": state["count"] + 1, "prev_grad": list(grads),
                         "prev_update": updates}

    return Optimizer(init, update)


def _schedule(learning_rate: float, learning_decay: float):
    """The step size a bag takes at its count (before the update):
    ``lr · (1 − decay)^count`` (`Weight.java` learningDecay), or the
    constant rate."""
    if learning_decay > 0.0:
        def step(count, like):
            t = count.to(torch.float32)
            return _bags(learning_rate * torch.pow(1.0 - learning_decay, t),
                         like)
        return step
    return lambda count, like: learning_rate


def sgd(learning_rate: float, learning_decay: float = 0.0,
        momentum: float = 0.0, nesterov: bool = False) -> Optimizer:
    """optax.sgd: an optional trace (``t = g + m·t``; Nesterov's update
    ``g + m·t_new``), then the (scheduled) negative learning rate."""
    lr = _schedule(learning_rate, learning_decay)

    def init(params):
        state = {"count": _count(params)}
        if momentum:
            state["trace"] = [torch.zeros_like(p) for p in params]
        return state

    def update(grads, state):
        new = {"count": state["count"] + 1}
        if momentum:
            trace = [g + momentum * t for g, t in zip(grads, state["trace"])]
            new["trace"] = trace
            grads = [g + momentum * t for g, t in zip(grads, trace)] \
                if nesterov else trace
        updates = [-lr(state["count"], g) * g for g in grads]
        return updates, new

    return Optimizer(init, update)


def adam(learning_rate: float, learning_decay: float = 0.0,
         b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8) -> Optimizer:
    """optax.adam (eps_root 0): bias-corrected moments by the bag's
    count, ``m̂ / (sqrt(v̂) + eps)``."""
    lr = _schedule(learning_rate, learning_decay)

    def init(params):
        return {"count": _count(params),
                "mu": [torch.zeros_like(p) for p in params],
                "nu": [torch.zeros_like(p) for p in params]}

    def update(grads, state):
        count = state["count"] + 1
        t = count.to(torch.float32)
        c1 = 1 - torch.pow(b1, t)
        c2 = 1 - torch.pow(b2, t)
        mu = [(1 - b1) * g + b1 * m for g, m in zip(grads, state["mu"])]
        nu = [(1 - b2) * (g ** 2) + b2 * v for g, v in zip(grads, state["nu"])]
        updates = [-lr(state["count"], m)
                   * ((m / _bags(c1, m)) / (torch.sqrt(v / _bags(c2, v)) + eps))
                   for m, v in zip(mu, nu)]
        return updates, {"count": count, "mu": mu, "nu": nu}

    return Optimizer(init, update)


def adagrad(learning_rate: float, learning_decay: float = 0.0,
            initial_accumulator_value: float = 0.1,
            eps: float = 1e-7) -> Optimizer:
    """optax.adagrad: ``acc += g²``, ``g · where(acc > 0, rsqrt(acc +
    eps), 0)``."""
    lr = _schedule(learning_rate, learning_decay)

    def init(params):
        return {"count": _count(params),
                "sum_of_squares": [torch.full_like(p, initial_accumulator_value)
                                   for p in params]}

    def update(grads, state):
        acc = [torch.square(g) + s
               for g, s in zip(grads, state["sum_of_squares"])]
        updates = [-lr(state["count"], g)
                   * (torch.where(a > 0, torch.rsqrt(a + eps),
                                  torch.zeros_like(a)) * g)
                   for g, a in zip(grads, acc)]
        return updates, {"count": state["count"] + 1, "sum_of_squares": acc}

    return Optimizer(init, update)


def rmsprop(learning_rate: float, learning_decay: float = 0.0,
            decay: float = 0.9, eps: float = 1e-8) -> Optimizer:
    """optax.rmsprop (uncentered, eps inside the root, initial scale 0):
    ``nu = (1 − d)·g² + d·nu``, ``g · rsqrt(nu + eps)``."""
    lr = _schedule(learning_rate, learning_decay)

    def init(params):
        return {"count": _count(params),
                "nu": [torch.zeros_like(p) for p in params]}

    def update(grads, state):
        nu = [(1 - decay) * (g ** 2) + decay * v
              for g, v in zip(grads, state["nu"])]
        updates = [-lr(state["count"], g) * (torch.rsqrt(v + eps) * g)
                   for g, v in zip(grads, nu)]
        return updates, {"count": state["count"] + 1, "nu": nu}

    return Optimizer(init, update)


def make_optimizer(propagation: str, learning_rate: float,
                   learning_decay: float = 0.0,
                   momentum: float = 0.5,
                   adam_beta1: float = 0.9,
                   adam_beta2: float = 0.999) -> Optimizer:
    """`Weight.calculateWeights` dispatch; learning_decay shrinks the
    rate each step: lr_t = lr · (1 − decay)^t."""
    p = (propagation or "Q").strip().upper()
    if p in ("B", "BACKPROP", "SGD"):
        return sgd(learning_rate, learning_decay)
    if p in ("Q", "QUICK", "QUICKPROP"):
        return quickprop(learning_rate)
    if p in ("R", "RESILIENT", "RPROP"):
        return rprop()
    if p in ("M", "MOMENTUM"):
        return sgd(learning_rate, learning_decay, momentum=momentum)
    if p in ("N", "NESTEROV"):
        return sgd(learning_rate, learning_decay, momentum=momentum,
                   nesterov=True)
    if p == "ADAM":
        return adam(learning_rate, learning_decay, adam_beta1, adam_beta2)
    if p == "ADAGRAD":
        return adagrad(learning_rate, learning_decay)
    if p == "RMSPROP":
        return rmsprop(learning_rate, learning_decay)
    raise ValueError(f"unknown Propagation {propagation!r}")


def optimizer_from_params(params: Dict[str, Any]) -> Optimizer:
    from shifu_tpu_torch.models.nn import param_getter
    get = param_getter(params)
    return make_optimizer(
        propagation=str(get("Propagation", "Q")),
        learning_rate=float(get("LearningRate", 0.1) or 0.1),
        learning_decay=float(get("LearningDecay", 0.0) or 0.0),
        momentum=float(get("Momentum", 0.5) or 0.5),
        adam_beta1=float(get("AdamBeta1", 0.9) or 0.9),
        adam_beta2=float(get("AdamBeta2", 0.999) or 0.999))
