"""Weight regularizers — L1/L2 penalties added to the training objective.

Counterpart of ``analytics_zoo_tpu/keras/regularizers.py`` (ref BigDL
``L1L2Regularizer`` on every layer's ``wRegularizer``/``bRegularizer``;
keras-1 ``Dense(W_regularizer=...)``). The penalty is a function of the
parameters that the estimator adds to the mean loss before the gradients
(learn/estimator.py), as the JAX package adds it inside its train step.
The sums accumulate in float32 whatever the parameter's dtype.
"""

from __future__ import annotations

import torch


class Regularizer:
    """l1·Σ|w| + l2·Σw² (Keras semantics: coefficients multiply the sums)."""

    def __init__(self, l1: float = 0.0, l2: float = 0.0):
        self.l1 = float(l1)
        self.l2 = float(l2)

    def __call__(self, w: torch.Tensor):
        w = w.float()
        total = 0.0
        if self.l1:
            # |w| with jnp.abs's derivative: +1 at w == 0 (torch.abs has
            # 0 there, so a zero bias would not move as JAX's does)
            total += self.l1 * torch.sum(torch.where(w >= 0, w, -w))
        if self.l2:
            total += self.l2 * torch.sum(torch.square(w))
        return total

    def __repr__(self):
        return f"Regularizer(l1={self.l1}, l2={self.l2})"


# BigDL spelling (ref com.intel.analytics.bigdl.optim.L1L2Regularizer)
L1L2Regularizer = Regularizer
L1L2 = Regularizer


def l1(l: float = 0.01) -> Regularizer:
    return Regularizer(l1=l)


def l2(l: float = 0.01) -> Regularizer:
    return Regularizer(l2=l)


def l1_l2(l1: float = 0.01, l2: float = 0.01) -> Regularizer:
    return Regularizer(l1=l1, l2=l2)


def get(spec):
    """None | Regularizer | callable | 'l1' | 'l2' | 'l1_l2' → a
    regularizer or None."""
    if spec is None or isinstance(spec, Regularizer):
        return spec
    if callable(spec):
        return spec
    table = {"l1": l1, "l2": l2, "l1_l2": l1_l2, "l1l2": l1_l2}
    if isinstance(spec, str) and spec.lower() in table:
        return table[spec.lower()]()
    raise ValueError(f"unknown regularizer {spec!r}")
