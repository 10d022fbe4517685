"""Optimizers and learning-rate schedules, in PyTorch, with optax's
semantics.

Counterpart of ``analytics_zoo_tpu/learn/optimizers.py`` (ref
``pyzoo/zoo/orca/learn/optimizers_impl.py`` and ``schedule.py``). The JAX
package builds an optax transformation from each wrapper; the port
applies the same update rules to a list of parameters in place, with
PyTorch's multi-tensor (``torch._foreach_*``) ops, so a step is a few
launches over all parameters rather than a few per parameter:

- ``Adam``: ``mu = (1-b1)·g + b1·mu``, ``nu = (1-b2)·g² + b2·nu``, bias
  correction by ``1 - b^t`` at the t-th update, ``mu_hat / (sqrt(nu_hat)
  + eps)`` (eps outside the square root), times ``-lr``.
- ``AdamWeightDecay`` (optax ``adamw``): the Adam update plus ``wd·p``,
  times ``-lr``; every parameter decays. With ``total`` and
  ``warmup_portion`` the rate follows optax's warmup-cosine schedule.
- ``SGD``: optional ``g + wd·p``, then optax ``trace`` momentum
  (``t = g + m·t``; Nesterov ``g + m·t``), times ``-lr``.
- A schedule is evaluated at optax's count, the number of updates taken
  before this one, so the first update uses ``schedule(0)``.

Each optimizer also says how its state maps onto the tree of the optax
transformation the JAX package builds from it (``optax_state`` and
``from_optax_state``), which is what a checkpoint holds
(learn/checkpoint.py): ``adam`` is ``{"0": {"count", "mu", "nu"}, "1":
{}}``, ``adamw`` ``{"0": adam, "1": {}, "2": {}}`` and ``sgd`` ``{"0":
{"0": {"trace"} or {}, "1": {}}}``, with ``{"0": {}, "1": ...}`` around
it when it decays weights. A schedule's optax state is ``{"count"}`` in
place of the last ``{}``; ``count`` is an int32 scalar. The moments and
the trace are trees shaped like the parameters, made by the caller's
``tree``.

The other optimizer names of the JAX package (rmsprop, adagrad, adadelta,
adamax, nadam, lars, lamb, lbfgs) raise: porting them is ROADMAP A3.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional

import numpy as np
import torch


# ---------------- schedules (ref orca/learn/schedule.py) ----------------

def _linear(init: float, end: float, steps: int):
    return _polynomial(init, end, 1.0, steps)


def _polynomial(init: float, end: float, power: float, steps: int):
    """optax ``polynomial_schedule``."""
    if steps <= 0:
        return lambda count: init

    def schedule(count: int) -> float:
        count = min(max(count, 0), steps)
        return (init - end) * (1 - count / steps) ** power + end

    return schedule


def _exponential(init: float, steps: int, rate: float,
                 staircase: bool = False):
    """optax ``exponential_decay`` (no transition_begin, no end value)."""
    if steps <= 0 or rate == 0:
        return lambda count: init

    def schedule(count: int) -> float:
        p = count / steps
        if staircase:
            p = math.floor(p)
        return init if count <= 0 else init * rate ** p

    return schedule


def _warmup_cosine(init: float, peak: float, warmup: int, decay: int,
                   end: float = 0.0):
    """optax ``warmup_cosine_decay_schedule``: linear from ``init`` to
    ``peak`` over ``warmup`` steps, then cosine decay to ``end`` by step
    ``decay`` (joined at ``warmup``)."""
    if decay - warmup <= 0:
        raise ValueError(f"cosine decay needs decay_steps > warmup_steps, "
                         f"got {decay} and {warmup}")
    alpha = 0.0 if peak == 0.0 else end / peak
    warm = _linear(init, peak, warmup)
    span = float(decay - warmup)

    def schedule(count: int) -> float:
        if count < warmup:
            return warm(count)
        t = min(float(count - warmup), span)
        cosine = 0.5 * (1 + math.cos(math.pi * t / span))
        return peak * ((1 - alpha) * cosine + alpha)

    return schedule


class LRSchedule:
    def build(self, base_lr: float):
        """The schedule as a function of optax's update count."""
        raise NotImplementedError


class Default(LRSchedule):
    def build(self, base_lr):
        return lambda count: base_lr


class Poly(LRSchedule):
    """(ref schedule.py Poly: lr * (1 - iter/max)^power)"""

    def __init__(self, power: float, max_iteration: int):
        self.power, self.max_iteration = power, max_iteration

    def build(self, base_lr):
        return _polynomial(base_lr, 0.0, self.power, self.max_iteration)


class Exponential(LRSchedule):
    def __init__(self, decay_step: int, decay_rate: float,
                 stair_case: bool = False):
        self.decay_step, self.decay_rate = decay_step, decay_rate
        self.stair_case = stair_case

    def build(self, base_lr):
        return _exponential(base_lr, self.decay_step, self.decay_rate,
                            self.stair_case)


class Step(LRSchedule):
    def __init__(self, step_size: int, gamma: float):
        self.step_size, self.gamma = step_size, gamma

    def build(self, base_lr):
        return _exponential(base_lr, self.step_size, self.gamma, True)


class Warmup(LRSchedule):
    """Linear warmup then constant (ref schedule.py Warmup delta)."""

    def __init__(self, warmup_steps: int):
        self.warmup_steps = warmup_steps

    def build(self, base_lr):
        return _linear(0.0, base_lr, self.warmup_steps)


class WarmupCosine(LRSchedule):
    def __init__(self, warmup_steps: int, total_steps: int,
                 end_value: float = 0.0):
        self.warmup_steps, self.total_steps = warmup_steps, total_steps
        self.end_value = end_value

    def build(self, base_lr):
        return _warmup_cosine(0.0, base_lr, self.warmup_steps,
                              self.total_steps, self.end_value)


def _lr(learning_rate: float, schedule: Optional[LRSchedule]):
    return (schedule or Default()).build(learning_rate)


# ---------------- optimizers (ref orca/learn/optimizers_impl.py) --------

_NOT_PORTED = ("rmsprop", "adagrad", "adadelta", "adamax", "nadam", "lars",
               "lamb", "lbfgs")


def _has_schedule(schedule: Optional[LRSchedule]) -> bool:
    """Whether the JAX package gives optax a schedule (a state with a
    count) rather than a constant rate."""
    return schedule is not None and not isinstance(schedule, Default)


def _count(count: int) -> np.ndarray:
    return np.asarray(count, np.int32)


class Optimizer:
    """An update rule over a list of parameters. ``init`` makes its state;
    ``step`` applies one update in place, given the gradients and the
    number of updates taken before it (optax's count). ``_lr`` (the rate
    as a function of the count) is rebuilt after unpickling."""

    def init(self, params: List[torch.Tensor]) -> Dict[str, list]:
        return {}

    def _make_lr(self):
        raise NotImplementedError

    def __getstate__(self):
        state = dict(self.__dict__)
        state.pop("_lr", None)
        return state

    def __setstate__(self, state):
        self.__dict__.update(state)
        self._lr = self._make_lr()

    def optax_state(self, state: dict, tree: Callable[[list], dict]) -> dict:
        """``state`` (with its ``count``) as the optax tree; ``tree`` turns
        a list of per-parameter tensors into a parameter-shaped tree."""
        raise NotImplementedError(
            f"{type(self).__name__} has no optax state mapping")

    def from_optax_state(self, opt: dict, untree: Callable[[dict], list]
                         ) -> dict:
        """The inverse of ``optax_state``; ``untree`` turns a
        parameter-shaped tree back into the list of tensors."""
        raise NotImplementedError(
            f"{type(self).__name__} has no optax state mapping")

    def step(self, params: List[torch.Tensor], grads: List[torch.Tensor],
             state: Dict[str, list], count: int) -> None:
        raise NotImplementedError

    @staticmethod
    def get(opt) -> "Optimizer":
        if isinstance(opt, Optimizer):
            return opt
        if isinstance(opt, str):
            name = opt.lower()
            table = {"sgd": SGD, "adam": Adam, "adamw": AdamWeightDecay}
            if name in table:
                return table[name]()
            if name in _NOT_PORTED:
                raise NotImplementedError(
                    f"optimizer {opt!r} is not ported yet (ROADMAP A3); "
                    "use sgd, adam or adamw")
            raise ValueError(f"unknown optimizer {opt!r}")
        raise TypeError(f"cannot build optimizer from {type(opt)}")


def _apply(params, updates, lr: float) -> None:
    """p + (-lr)·u, rounded after the product as optax's ``scale`` then
    ``apply_updates`` do."""
    torch._foreach_add_(params, torch._foreach_mul(updates, -lr))


class SGD(Optimizer):
    """(ref optimizers_impl.py SGD: momentum/nesterov/wd + schedule)"""

    def __init__(self, learningrate: float = 1e-3, momentum: float = 0.0,
                 nesterov: bool = False, weightdecay: float = 0.0,
                 leaningrate_schedule: Optional[LRSchedule] = None):
        self.lr, self.momentum, self.nesterov = learningrate, momentum, nesterov
        self.weightdecay, self.schedule = weightdecay, leaningrate_schedule
        self._lr = self._make_lr()

    def _make_lr(self):
        return _lr(self.lr, self.schedule)

    def init(self, params):
        if not self.momentum:
            return {}
        return {"trace": [torch.zeros_like(p) for p in params]}

    def optax_state(self, state, tree):
        # optax.sgd: chain(trace or identity, scale_by_learning_rate),
        # inside the JAX wrapper's chain (after add_decayed_weights)
        inner = {"0": ({"trace": tree(state["trace"])} if self.momentum
                       else {}),
                 "1": ({"count": _count(state["count"])}
                       if _has_schedule(self.schedule) else {})}
        return {"0": {}, "1": inner} if self.weightdecay else {"0": inner}

    def from_optax_state(self, opt, untree):
        inner = opt["1"] if self.weightdecay else opt["0"]
        # without a schedule optax keeps no count; the rate is constant
        out = {"count": int(inner["1"].get("count", 0))}
        if self.momentum:
            out["trace"] = untree(inner["0"]["trace"])
        return out

    def step(self, params, grads, state, count):
        g = list(grads)
        if self.weightdecay:
            g = torch._foreach_add(g, torch._foreach_mul(params,
                                                         self.weightdecay))
        if self.momentum:
            trace = state["trace"]
            # t = g + m·t, in place
            torch._foreach_mul_(trace, self.momentum)
            torch._foreach_add_(trace, g)
            g = torch._foreach_add(g, torch._foreach_mul(
                trace, self.momentum)) if self.nesterov else trace
        _apply(params, g, self._lr(count))


class Adam(Optimizer):
    def __init__(self, learningrate: float = 1e-3, beta1: float = 0.9,
                 beta2: float = 0.999, epsilon: float = 1e-8,
                 leaningrate_schedule: Optional[LRSchedule] = None):
        self.lr, self.b1, self.b2, self.eps = (learningrate, beta1, beta2,
                                               epsilon)
        self.schedule = leaningrate_schedule
        self._lr = self._make_lr()

    def _make_lr(self):
        return _lr(self.lr, self.schedule)

    def init(self, params):
        return {"mu": [torch.zeros_like(p) for p in params],
                "nu": [torch.zeros_like(p) for p in params]}

    #: empty optax states between scale_by_adam and the rate (adamw's
    #: add_decayed_weights)
    _decay_states = 0

    def _scheduled(self) -> bool:
        return _has_schedule(self.schedule)

    def optax_state(self, state, tree):
        # chain(scale_by_adam, [add_decayed_weights,] scale_by_learning_rate)
        count = _count(state["count"])
        parts = [{"count": count, "mu": tree(state["mu"]),
                  "nu": tree(state["nu"])}]
        parts += [{}] * self._decay_states
        parts.append({"count": count} if self._scheduled() else {})
        return {str(i): p for i, p in enumerate(parts)}

    def from_optax_state(self, opt, untree):
        adam = opt["0"]
        return {"count": int(adam["count"]), "mu": untree(adam["mu"]),
                "nu": untree(adam["nu"])}

    def _adam(self, grads, state, count) -> List[torch.Tensor]:
        """optax ``scale_by_adam``: updates the moments in place and
        returns ``mu_hat / (sqrt(nu_hat) + eps)``."""
        mu, nu = state["mu"], state["nu"]
        b1, b2 = self.b1, self.b2
        # (1 - b)·g^k + b·m, each product rounded, then the sum
        torch._foreach_mul_(mu, b1)
        torch._foreach_add_(mu, torch._foreach_mul(grads, 1 - b1))
        torch._foreach_mul_(nu, b2)
        torch._foreach_add_(nu, torch._foreach_mul(
            torch._foreach_mul(grads, grads), 1 - b2))
        # 1 - b^t in fp32, as optax takes the power of a weak float
        t = np.float32(count + 1)
        mu_hat = torch._foreach_div(mu, float(1 - np.float32(b1) ** t))
        nu_hat = torch._foreach_div(nu, float(1 - np.float32(b2) ** t))
        denom = torch._foreach_sqrt(nu_hat)
        torch._foreach_add_(denom, self.eps)
        return torch._foreach_div(mu_hat, denom)

    def step(self, params, grads, state, count):
        _apply(params, self._adam(grads, state, count), self._lr(count))


class AdamWeightDecay(Adam):
    """(ref optimizers_impl.py AdamWeightDecay — the BERT optimizer;
    optax ``adamw``)"""

    def __init__(self, learningrate: float = 1e-3, weight_decay: float = 0.01,
                 beta1: float = 0.9, beta2: float = 0.999,
                 epsilon: float = 1e-6, total: int = -1,
                 warmup_portion: float = -1.0):
        self.wd = weight_decay
        self.total, self.warmup_portion = total, warmup_portion
        super().__init__(learningrate, beta1, beta2, epsilon)

    _decay_states = 1

    def _scheduled(self) -> bool:
        return self.total > 0 and self.warmup_portion > 0

    def _make_lr(self):
        if self._scheduled():
            return _warmup_cosine(0.0, self.lr,
                                  int(self.total * self.warmup_portion),
                                  self.total)
        return _lr(self.lr, None)

    def step(self, params, grads, state, count):
        upd = self._adam(grads, state, count)
        torch._foreach_add_(upd, torch._foreach_mul(params, self.wd))
        _apply(params, upd, self._lr(count))
