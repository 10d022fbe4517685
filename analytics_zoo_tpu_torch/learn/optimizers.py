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

The other eight follow optax 0.2.6's transformations, each in optax's
order of rounding:

- ``RMSprop`` (optax ``rmsprop``): ``nu = (1-d)·g² + d·nu`` from 0, the
  update ``rsqrt(nu + eps)·g`` (eps inside the root); state ``{"0":
  {"nu"}, "1": {}, "2": {}}``.
- ``Adagrad`` (``adagrad``): the sum of squares starts at 0.1, ``t = g² +
  t``, the update ``where(t > 0, rsqrt(t + 1e-7), 0)·g``; state ``{"0":
  {"sum_of_squares"}, "1": {}}``.
- ``Adadelta`` (``adadelta``, no weight decay): ``e_g`` from ``g²``, the
  update ``sqrt(e_x + eps) / sqrt(e_g + eps)·g``, then ``e_x`` from the
  update's square; state ``{"0": {}, "1": {"e_g", "e_x"}, "2": {}}``.
- ``Adamax`` (``adamax``): ``mu`` as Adam's, ``nu = max(|g| + eps,
  b2·nu)`` (the infinity norm), the update ``mu_hat / nu``; state
  ``{"0": {"count", "mu", "nu"}, "1": {}}``.
- ``Nadam`` (``nadam``, Adam with ``nesterov=True``): ``mu_hat = b1·mu /
  (1 - b1^(t+1)) + (1-b1)·g / (1 - b1^t)``; Adam's state.
- ``LARS`` (``lars``): weight decay, then the trust ratio ``0.001·|p| /
  |u|`` (1 where either norm is 0), both under an all-true mask, then
  ``-lr``, then the momentum trace; state ``{"0": {"inner_state": {}},
  "1": {"inner_state": {}}, "2": {}, "3": {"trace"}}``.
- ``LAMB`` (``lamb``): Adam's update with eps 1e-6, ``+ wd·p``, the
  trust ratio ``|p| / |u|``, ``-lr``; state ``{"0": adam, "1": {}, "2":
  {}, "3": {}}``.
- ``LBFGS`` (``lbfgs(memory_size=ncorrection, linesearch=None)``): the
  two-loop recursion over a ring of ``ncorrection`` parameter and gradient
  differences, the first step scaled by ``min(1, 1/|g|)`` and later ones
  by ``<dg, dp> / |dg|²``; state ``{"0": {"count", "params", "updates",
  "diff_params_memory", "diff_updates_memory", "weights_memory"}, "1": {},
  "2": {}}``, the two memories ``[ncorrection, *param.shape]`` (``tree``
  is called with ``lead=(ncorrection,)`` for them). The loops visit only
  the slots written so far: an unwritten slot holds zeros and weight 0,
  and optax's step over it changes nothing.

A state without a count in optax's tree (RMSprop, Adagrad, Adadelta,
LARS; SGD without a schedule) restores with count 0: its rate is
constant.
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

    def optax_state(self, state: dict, tree: Callable[..., dict]) -> dict:
        """``state`` (with its ``count``) as the optax tree; ``tree`` turns
        a list of per-parameter tensors into a parameter-shaped tree
        (``tree(tensors, lead=(m,))`` for tensors with ``m`` slots in
        front of each parameter's shape)."""
        raise NotImplementedError(
            f"{type(self).__name__} has no optax state mapping")

    def from_optax_state(self, opt: dict, untree: Callable[..., list]
                         ) -> dict:
        """The inverse of ``optax_state``; ``untree`` turns a
        parameter-shaped tree back into the list of tensors
        (``untree(tree, lead=1)`` past one leading axis)."""
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
            table = {"sgd": SGD, "adam": Adam, "adamw": AdamWeightDecay,
                     "rmsprop": RMSprop, "adagrad": Adagrad,
                     "adadelta": Adadelta, "adamax": Adamax, "nadam": Nadam,
                     "lars": LARS, "lamb": LAMB, "lbfgs": LBFGS}
            if name not in table:
                raise ValueError(f"unknown optimizer {opt!r}")
            return table[name]()
        raise TypeError(f"cannot build optimizer from {type(opt)}")


def _apply(params, updates, lr: float) -> None:
    """p + (-lr)·u, rounded after the product as optax's ``scale`` then
    ``apply_updates`` do."""
    torch._foreach_add_(params, torch._foreach_mul(updates, -lr))


def _moment(m, g, decay: float) -> None:
    """optax ``update_moment``, in place: ``(1 - d)·g + d·m``, each
    product rounded, then the sum (``g`` already raised to its order)."""
    torch._foreach_mul_(m, decay)
    torch._foreach_add_(m, torch._foreach_mul(g, 1 - decay))


def _correction(decay: float, t: int) -> float:
    """optax ``bias_correction``'s ``1 - decay^t``, in fp32 as optax takes
    the power of a weak float to an int32 count."""
    return float(1 - np.float32(decay) ** np.float32(t))


def _trust_ratio(params, updates, coefficient: float, eps: float) -> None:
    """optax ``scale_by_trust_ratio`` (``min_norm`` 0), in place:
    ``u·(c·|p| / (|u| + eps))``, or ``u`` where either norm is 0."""
    pn = torch.stack(torch._foreach_norm(params))
    un = torch.stack(torch._foreach_norm(updates))
    ratio = torch.where((pn == 0) | (un == 0), torch.ones_like(pn),
                        coefficient * pn / (un + eps))
    torch._foreach_mul_(updates, list(ratio.unbind()))


def _tree_vdot(xs, ys) -> torch.Tensor:
    """optax ``tree.vdot``: each leaf's dot product, then their sum."""
    return torch.stack([torch.dot(x.reshape(-1), y.reshape(-1))
                        for x, y in zip(xs, ys)]).sum()


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

    #: Nadam's Nesterov form of the first moment
    _nesterov = False

    def _adam(self, grads, state, count) -> List[torch.Tensor]:
        """optax ``scale_by_adam``: updates the moments in place and
        returns ``mu_hat / (sqrt(nu_hat) + eps)``."""
        mu, nu = state["mu"], state["nu"]
        b1, b2 = self.b1, self.b2
        # (1 - b)·g^k + b·m, each product rounded, then the sum
        _moment(mu, grads, b1)
        _moment(nu, torch._foreach_mul(grads, grads), b2)
        t = count + 1
        if self._nesterov:
            # b1·mu / (1 - b1^(t+1)) + (1 - b1)·g / (1 - b1^t)
            mu_hat = torch._foreach_mul(
                torch._foreach_div(mu, _correction(b1, t + 1)), b1)
            torch._foreach_add_(mu_hat, torch._foreach_mul(
                torch._foreach_div(grads, _correction(b1, t)), 1 - b1))
        else:
            mu_hat = torch._foreach_div(mu, _correction(b1, t))
        nu_hat = torch._foreach_div(nu, _correction(b2, t))
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


class _Constant(Optimizer):
    """An optimizer whose rate is a constant ``lr`` (the JAX wrapper
    takes no schedule)."""

    def _make_lr(self):
        return _lr(self.lr, None)


class RMSprop(_Constant):
    """optax ``rmsprop(lr, decay, eps)``: eps inside the root, the second
    moment from 0."""

    def __init__(self, learningrate: float = 1e-2, decayrate: float = 0.9,
                 epsilon: float = 1e-8):
        self.lr, self.decay, self.eps = learningrate, decayrate, epsilon
        self._lr = self._make_lr()

    def init(self, params):
        return {"nu": [torch.zeros_like(p) for p in params]}

    def optax_state(self, state, tree):
        # chain(scale_by_rms, scale_by_learning_rate, identity)
        return {"0": {"nu": tree(state["nu"])}, "1": {}, "2": {}}

    def from_optax_state(self, opt, untree):
        return {"count": 0, "nu": untree(opt["0"]["nu"])}

    def step(self, params, grads, state, count):
        nu = state["nu"]
        _moment(nu, torch._foreach_mul(grads, grads), self.decay)
        scale = torch._foreach_rsqrt(torch._foreach_add(nu, self.eps))
        _apply(params, torch._foreach_mul(scale, grads), self._lr(count))


class Adagrad(_Constant):
    """optax ``adagrad(lr)``: the sum of squares from 0.1, eps 1e-7."""

    #: optax ``scale_by_rss``'s defaults
    initial_accumulator_value, eps = 0.1, 1e-7

    def __init__(self, learningrate: float = 1e-2):
        self.lr = learningrate
        self._lr = self._make_lr()

    def init(self, params):
        return {"sum_of_squares": [
            torch.full_like(p, self.initial_accumulator_value)
            for p in params]}

    def optax_state(self, state, tree):
        return {"0": {"sum_of_squares": tree(state["sum_of_squares"])},
                "1": {}}

    def from_optax_state(self, opt, untree):
        return {"count": 0,
                "sum_of_squares": untree(opt["0"]["sum_of_squares"])}

    def step(self, params, grads, state, count):
        sums = state["sum_of_squares"]
        torch._foreach_add_(sums, torch._foreach_mul(grads, grads))
        root = torch._foreach_rsqrt(torch._foreach_add(sums, self.eps))
        scale = [torch.where(t > 0, r, torch.zeros_like(r))
                 for t, r in zip(sums, root)]
        _apply(params, torch._foreach_mul(scale, grads), self._lr(count))


class Adadelta(_Constant):
    """optax ``adadelta(lr, rho, eps)`` (its weight decay 0 adds
    nothing)."""

    def __init__(self, learningrate: float = 1.0, decayrate: float = 0.9,
                 epsilon: float = 1e-6):
        self.lr, self.rho, self.eps = learningrate, decayrate, epsilon
        self._lr = self._make_lr()

    def init(self, params):
        return {"e_g": [torch.zeros_like(p) for p in params],
                "e_x": [torch.zeros_like(p) for p in params]}

    def optax_state(self, state, tree):
        # chain(add_decayed_weights, scale_by_adadelta, scale_by_lr)
        return {"0": {}, "1": {"e_g": tree(state["e_g"]),
                               "e_x": tree(state["e_x"])}, "2": {}}

    def from_optax_state(self, opt, untree):
        return {"count": 0, "e_g": untree(opt["1"]["e_g"]),
                "e_x": untree(opt["1"]["e_x"])}

    def step(self, params, grads, state, count):
        e_g, e_x = state["e_g"], state["e_x"]
        _moment(e_g, torch._foreach_mul(grads, grads), self.rho)
        ratio = torch._foreach_div(
            torch._foreach_sqrt(torch._foreach_add(e_x, self.eps)),
            torch._foreach_sqrt(torch._foreach_add(e_g, self.eps)))
        upd = torch._foreach_mul(ratio, grads)
        _moment(e_x, torch._foreach_mul(upd, upd), self.rho)
        _apply(params, upd, self._lr(count))


class Adamax(_Constant):
    """optax ``adamax(lr, b1, b2)`` (eps 1e-8)."""

    eps = 1e-8

    def __init__(self, learningrate: float = 2e-3, beta1: float = 0.9,
                 beta2: float = 0.999):
        self.lr, self.b1, self.b2 = learningrate, beta1, beta2
        self._lr = self._make_lr()

    def init(self, params):
        return {"mu": [torch.zeros_like(p) for p in params],
                "nu": [torch.zeros_like(p) for p in params]}

    def optax_state(self, state, tree):
        return {"0": {"count": _count(state["count"]),
                      "mu": tree(state["mu"]), "nu": tree(state["nu"])},
                "1": {}}

    def from_optax_state(self, opt, untree):
        part = opt["0"]
        return {"count": int(part["count"]), "mu": untree(part["mu"]),
                "nu": untree(part["nu"])}

    def step(self, params, grads, state, count):
        mu, nu = state["mu"], state["nu"]
        _moment(mu, grads, self.b1)
        # nu = max(|g| + eps, b2·nu)
        torch._foreach_mul_(nu, self.b2)
        torch._foreach_maximum_(nu, torch._foreach_add(
            torch._foreach_abs(grads), self.eps))
        mu_hat = torch._foreach_div(mu, _correction(self.b1, count + 1))
        _apply(params, torch._foreach_div(mu_hat, nu), self._lr(count))


class Nadam(Adam):
    """optax ``nadam(lr)``: Adam with the Nesterov first moment."""

    _nesterov = True

    def __init__(self, learningrate: float = 2e-3):
        super().__init__(learningrate)


class LARS(_Constant):
    """Layer-wise adaptive rate scaling: optax ``lars(lr, weight_decay,
    momentum=momentum)`` (trust coefficient 0.001, masks all true)."""

    trust_coefficient = 0.001

    def __init__(self, learningrate: float = 1e-1, momentum: float = 0.9,
                 weight_decay: float = 1e-4):
        self.lr, self.momentum, self.wd = learningrate, momentum, weight_decay
        self._lr = self._make_lr()

    def init(self, params):
        return {"trace": [torch.zeros_like(p) for p in params]}

    def optax_state(self, state, tree):
        # chain(masked(add_decayed_weights), masked(scale_by_trust_ratio),
        #       scale_by_learning_rate, trace)
        return {"0": {"inner_state": {}}, "1": {"inner_state": {}},
                "2": {}, "3": {"trace": tree(state["trace"])}}

    def from_optax_state(self, opt, untree):
        return {"count": 0, "trace": untree(opt["3"]["trace"])}

    def step(self, params, grads, state, count):
        upd = torch._foreach_add(grads, torch._foreach_mul(params, self.wd))
        _trust_ratio(params, upd, self.trust_coefficient, 0.0)
        upd = torch._foreach_mul(upd, -self._lr(count))
        trace = state["trace"]
        # t = u + m·t
        torch._foreach_mul_(trace, self.momentum)
        torch._foreach_add_(trace, upd)
        torch._foreach_add_(params, trace)


class LAMB(Adam):
    """optax ``lamb(lr, weight_decay=wd)``: Adam's update (eps 1e-6), the
    decay, the trust ratio ``|p| / |u|``, then the rate."""

    def __init__(self, learningrate: float = 1e-3, weight_decay: float = 0.0):
        self.wd = weight_decay
        super().__init__(learningrate, epsilon=1e-6)

    def optax_state(self, state, tree):
        out = super().optax_state(state, tree)
        return {"0": out["0"], "1": {}, "2": {}, "3": {}}

    def step(self, params, grads, state, count):
        upd = self._adam(grads, state, count)
        torch._foreach_add_(upd, torch._foreach_mul(params, self.wd))
        _trust_ratio(params, upd, 1.0, 0.0)
        _apply(params, upd, self._lr(count))


class LBFGS(_Constant):
    """Memory-limited BFGS (ref optimizers_impl.py:99 LBFGS): the JAX
    package's ``optax.lbfgs(lr, memory_size=ncorrection,
    linesearch=None)``, fixed steps of ``learningrate`` along the two-loop
    direction. ``max_iter``, ``max_eval``, ``tolfun`` and ``tolx`` (BigDL's
    inner loop) are accepted and ignored, as in JAX; a line search
    raises."""

    def __init__(self, max_iter: int = 20, max_eval=None,
                 tolfun: float = 1e-5, tolx: float = 1e-9,
                 ncorrection: int = 100, learningrate: float = 1.0,
                 verbose: bool = False, linesearch=None,
                 linesearch_options=None):
        if linesearch is not None:
            raise ValueError("custom line-search functions are not "
                             "supported inside the jitted step; use the "
                             "default fixed-step mode")
        self.lr = learningrate
        self.ncorrection = int(ncorrection)
        if self.ncorrection < 1:
            raise ValueError("memory_size must be >= 1")
        self._lr = self._make_lr()

    def init(self, params):
        m = self.ncorrection
        dev = params[0].device if params else None
        return {"params": [torch.zeros_like(p) for p in params],
                "updates": [torch.zeros_like(p) for p in params],
                "diff_params_memory": [p.new_zeros((m, *p.shape))
                                       for p in params],
                "diff_updates_memory": [p.new_zeros((m, *p.shape))
                                        for p in params],
                "weights_memory": torch.zeros(m, device=dev)}

    def optax_state(self, state, tree):
        # chain(scale_by_lbfgs, scale_by_learning_rate, identity); the
        # fields in ScaleByLBFGSState's order, as flax writes them
        m = (self.ncorrection,)
        weights = state["weights_memory"]      # None in a checkpoint spec
        return {"0": {
            "count": _count(state["count"]),
            "params": tree(state["params"]),
            "updates": tree(state["updates"]),
            "diff_params_memory": tree(state["diff_params_memory"], lead=m),
            "diff_updates_memory": tree(state["diff_updates_memory"],
                                        lead=m),
            "weights_memory": (torch.empty(m, device="meta")
                               if weights is None
                               else weights.detach().cpu())},
            "1": {}, "2": {}}

    def from_optax_state(self, opt, untree):
        part = opt["0"]
        w = torch.as_tensor(np.asarray(part["weights_memory"]))
        out = {"count": int(part["count"]),
               "params": untree(part["params"]),
               "updates": untree(part["updates"]),
               "diff_params_memory": untree(part["diff_params_memory"],
                                            lead=1),
               "diff_updates_memory": untree(part["diff_updates_memory"],
                                             lead=1)}
        dev = out["params"][0].device if out["params"] else None
        out["weights_memory"] = w.to(dev, torch.float32, copy=True)
        return out

    def step(self, params, grads, state, count):
        m = self.ncorrection
        dw, du_mem = state["diff_params_memory"], state["diff_updates_memory"]
        rho = state["weights_memory"]
        prev = (count - 1) % m
        # 1. the newest differences into slot count - 1 (zeros at count 0)
        if count > 0:
            dp = torch._foreach_sub(params, state["params"])
            du = torch._foreach_sub(grads, state["updates"])
            vd = _tree_vdot(du, dp)
            weight = torch.where(vd == 0, torch.zeros_like(vd), 1.0 / vd)
        else:
            dp = [torch.zeros_like(p) for p in params]
            du = [torch.zeros_like(p) for p in params]
            weight = torch.zeros((), device=rho.device)
        for mem, d in zip(dw, dp):
            mem[prev].copy_(d)
        for mem, d in zip(du_mem, du):
            mem[prev].copy_(d)
        rho[prev] = weight
        # 2. the initial scale: <du, dp> / |du|² (1 where |du| is 0); at
        # count 0, min(1, 1/|g|)
        if count > 0:
            den = torch.stack([torch.sum(d * d) for d in du]).sum()
            scale = torch.where(den > 0, vd / den, torch.ones_like(den))
        else:
            norm = torch.sqrt(torch.stack([torch.sum(g * g)
                                           for g in grads]).sum())
            scale = torch.minimum(torch.ones_like(norm), 1.0 / norm)
        # 3. the two loops over the ring, from the newest slot back; slots
        # not yet written (zeros, weight 0) change nothing and are skipped
        live = min(count, m)
        order = [i for i in ((count % m + j) % m for j in range(m))
                 if i < live]
        vec = list(grads)
        alphas = {}
        for i in reversed(order):
            a = rho[i] * _tree_vdot([mem[i] for mem in dw], vec)
            vec = torch._foreach_add(vec, torch._foreach_mul(
                [mem[i] for mem in du_mem], -a))
            alphas[i] = a
        vec = torch._foreach_mul(vec, scale)
        for i in order:
            b = rho[i] * _tree_vdot([mem[i] for mem in du_mem], vec)
            vec = torch._foreach_add(vec, torch._foreach_mul(
                [mem[i] for mem in dw], alphas[i] - b))
        torch._foreach_copy_(state["params"], params)
        torch._foreach_copy_(state["updates"], grads)
        _apply(params, vec, self._lr(count))
