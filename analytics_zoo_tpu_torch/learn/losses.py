"""Loss functions (objectives), in PyTorch.

Counterpart of ``analytics_zoo_tpu/learn/losses.py`` (ref zoo Keras
objectives). Every loss is ``fn(y_true, y_pred) -> per-sample loss
[batch]``, so the train step can mask padded rows before reducing. The
same registry names, the same formulas, and the same precision rule
(``_f32``): predictions compute in fp32 even under a bf16 compute dtype,
and so do targets wherever they enter a log or a ratio (msle, mape, kld,
poisson).
"""

from __future__ import annotations

import torch

_EPS = 1e-7


def _flatten_trailing(a: torch.Tensor) -> torch.Tensor:
    return a.reshape(a.shape[0], -1) if a.ndim > 1 else a[:, None]


def _f32(a: torch.Tensor) -> torch.Tensor:
    """Floating tensors in fp32 (the loss is a scalar tail, not a matmul:
    log/exp/divide in bf16 would cost accuracy for nothing); integer
    labels stay as they are."""
    return a.float() if a.is_floating_point() else a


def mean_squared_error(y_true, y_pred):
    y_pred = _f32(y_pred)
    return torch.square(_flatten_trailing(y_pred)
                        - _flatten_trailing(y_true)).mean(-1)


def mean_absolute_error(y_true, y_pred):
    y_pred = _f32(y_pred)
    return torch.abs(_flatten_trailing(y_pred)
                     - _flatten_trailing(y_true)).mean(-1)


def mean_absolute_percentage_error(y_true, y_pred):
    y_pred, y_true = _f32(y_pred), _f32(y_true)
    t = _flatten_trailing(y_true)
    return (100.0 * torch.abs((t - _flatten_trailing(y_pred))
                              / torch.clamp(torch.abs(t), min=_EPS))
            ).mean(-1)


def mean_squared_logarithmic_error(y_true, y_pred):
    y_pred, y_true = _f32(y_pred), _f32(y_true)
    a = torch.log1p(torch.clamp(_flatten_trailing(y_pred), min=_EPS))
    b = torch.log1p(torch.clamp(_flatten_trailing(y_true), min=_EPS))
    return torch.square(a - b).mean(-1)


def binary_crossentropy(y_true, y_pred):
    y_pred = _f32(y_pred)
    p = torch.clamp(_flatten_trailing(y_pred), _EPS, 1 - _EPS)
    t = _flatten_trailing(y_true)
    return -(t * torch.log(p) + (1 - t) * torch.log1p(-p)).mean(-1)


def binary_crossentropy_from_logits(y_true, y_pred):
    y_pred = _f32(y_pred)
    z = _flatten_trailing(y_pred)
    t = _flatten_trailing(y_true)
    return (torch.clamp(z, min=0) - z * t
            + torch.log1p(torch.exp(-torch.abs(z)))).mean(-1)


def categorical_crossentropy(y_true, y_pred):
    y_pred = _f32(y_pred)
    p = torch.clamp(y_pred, _EPS, 1.0)
    return -(y_true * torch.log(p)).sum(-1)


def _take_label(values: torch.Tensor, y_true: torch.Tensor) -> torch.Tensor:
    """``jnp.take_along_axis(values, labels[..., None], -1)[..., 0]`` under
    JAX's rule: labels in ``[-C, C)`` index the last axis (negative ones
    wrap), any other label gives NaN. The index is clamped into range
    first, so no device reads out of bounds."""
    c = values.shape[-1]
    idx = y_true.to(torch.int64)
    valid = (idx >= -c) & (idx < c)
    idx = torch.clamp(torch.where(idx < 0, idx + c, idx), 0, c - 1)
    taken = torch.take_along_dim(values, idx[..., None], dim=-1)[..., 0]
    return torch.where(valid, taken, float("nan"))


def sparse_categorical_crossentropy(y_true, y_pred):
    y_pred = _f32(y_pred)
    logp = torch.log(torch.clamp(y_pred, _EPS, 1.0))
    return -_take_label(logp, y_true)


def logsumexp(x: torch.Tensor) -> torch.Tensor:
    """Over the last axis, kept: ``m + log(sum(exp(x - m)))`` as the JAX
    package writes it."""
    m = torch.amax(x, dim=-1, keepdim=True)
    return m + torch.log(torch.sum(torch.exp(x - m), dim=-1, keepdim=True))


def sparse_categorical_crossentropy_from_logits(y_true, y_pred):
    y_pred = _f32(y_pred)
    out = -_take_label(y_pred - logsumexp(y_pred), y_true)
    if out.ndim > 1:  # e.g. sequence models: mean over time
        out = out.mean(dim=tuple(range(1, out.ndim)))
    return out


def hinge(y_true, y_pred):
    return torch.clamp(1.0 - _flatten_trailing(y_true)
                       * _flatten_trailing(y_pred), min=0.0).mean(-1)


def squared_hinge(y_true, y_pred):
    return torch.square(torch.clamp(
        1.0 - _flatten_trailing(y_true) * _flatten_trailing(y_pred),
        min=0.0)).mean(-1)


def kullback_leibler_divergence(y_true, y_pred):
    t = torch.clamp(_f32(y_true), _EPS, 1.0)
    p = torch.clamp(_f32(y_pred), _EPS, 1.0)
    return (t * torch.log(t / p)).sum(-1)


def poisson(y_true, y_pred):
    y_pred, y_true = _f32(y_pred), _f32(y_true)
    return (_flatten_trailing(y_pred) - _flatten_trailing(y_true)
            * torch.log(_flatten_trailing(y_pred) + _EPS)).mean(-1)


def cosine_proximity(y_true, y_pred):
    t = _flatten_trailing(y_true)
    p = _flatten_trailing(y_pred)
    t = t / torch.clamp(torch.linalg.vector_norm(t, dim=-1, keepdim=True),
                        min=_EPS)
    p = p / torch.clamp(torch.linalg.vector_norm(p, dim=-1, keepdim=True),
                        min=_EPS)
    return -(t * p).sum(-1)


def huber(y_true, y_pred, delta: float = 1.0):
    err = _flatten_trailing(y_pred) - _flatten_trailing(y_true)
    abs_err = torch.abs(err)
    quad = torch.clamp(abs_err, max=delta)
    return (0.5 * quad ** 2 + delta * (abs_err - quad)).mean(-1)


_REGISTRY = {
    "mse": mean_squared_error, "mean_squared_error": mean_squared_error,
    "mae": mean_absolute_error, "mean_absolute_error": mean_absolute_error,
    "mape": mean_absolute_percentage_error,
    "msle": mean_squared_logarithmic_error,
    "binary_crossentropy": binary_crossentropy,
    "bce_logits": binary_crossentropy_from_logits,
    "categorical_crossentropy": categorical_crossentropy,
    "sparse_categorical_crossentropy": sparse_categorical_crossentropy,
    "sparse_categorical_crossentropy_logits":
        sparse_categorical_crossentropy_from_logits,
    "hinge": hinge, "squared_hinge": squared_hinge,
    "kld": kullback_leibler_divergence,
    "poisson": poisson,
    "cosine_proximity": cosine_proximity,
    "huber": huber,
}


def get(loss):
    if callable(loss):
        return loss
    if isinstance(loss, str):
        key = loss.lower()
        if key not in _REGISTRY:
            raise ValueError(f"unknown loss {loss!r}; known: "
                             f"{sorted(_REGISTRY)}")
        return _REGISTRY[key]
    raise TypeError(f"loss must be str or callable, got {type(loss)}")
