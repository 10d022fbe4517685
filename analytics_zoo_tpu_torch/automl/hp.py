"""Hyperparameter sampling DSL.

The port's copy of ``analytics_zoo_tpu/automl/hp.py`` (numpy only): the
same samplers draw the same values from the same ``numpy`` generator, so a
seed gives the JAX package's configs bit for bit.

API-parity with ``zoo.orca.automl.hp`` (ref pyzoo/zoo/orca/automl/hp.py —
thin wrappers over ray.tune sampling). Here each primitive is a small
self-describing sampler so the search engine needs no external tuner.

Usage::

    space = {
        "lr": hp.loguniform(1e-4, 1e-1),
        "hidden": hp.choice([32, 64, 128]),
        "layers": hp.randint(1, 4),
        "dropout": hp.uniform(0.0, 0.5),
        "batch_size": hp.grid_search([32, 64]),
    }
"""

from __future__ import annotations

import math
from typing import Any, List, Sequence

import numpy as np


class Sampler:
    """Base: one hyperparameter's distribution."""

    def sample(self, rng: np.random.Generator) -> Any:
        raise NotImplementedError

    # grid_search overrides; everything else is a point draw
    grid: "List[Any] | None" = None


class Choice(Sampler):
    def __init__(self, categories: Sequence[Any]):
        self.categories = list(categories)

    def sample(self, rng):
        return self.categories[int(rng.integers(len(self.categories)))]

    def __repr__(self):
        return f"choice({self.categories})"


class Uniform(Sampler):
    def __init__(self, lower: float, upper: float):
        self.lower, self.upper = float(lower), float(upper)

    def sample(self, rng):
        return float(rng.uniform(self.lower, self.upper))

    def __repr__(self):
        return f"uniform({self.lower}, {self.upper})"


class QUniform(Uniform):
    def __init__(self, lower, upper, q):
        super().__init__(lower, upper)
        self.q = float(q)

    def sample(self, rng):
        v = super().sample(rng)
        return _snap_to_q(v, self.q, self.lower, self.upper)


def _snap_to_q(v: float, q: float, lower: float, upper: float) -> float:
    """Round to a multiple of q, then clamp to the in-range multiples so
    both the quantization and the bound contracts hold."""
    lo = math.ceil(lower / q - 1e-9) * q
    hi = math.floor(upper / q + 1e-9) * q
    if lo > hi:
        # no multiple of q inside [lower, upper]; bounds win over quantization
        return min(max(v, lower), upper)
    v = float(np.round(v / q) * q)
    return min(max(v, lo), hi)


class LogUniform(Sampler):
    def __init__(self, lower: float, upper: float, base: float = 10.0):
        self.lower, self.upper, self.base = float(lower), float(upper), base

    def sample(self, rng):
        lo, hi = math.log(self.lower, self.base), math.log(self.upper, self.base)
        return float(self.base ** rng.uniform(lo, hi))

    def __repr__(self):
        return f"loguniform({self.lower}, {self.upper})"


class QLogUniform(LogUniform):
    def __init__(self, lower, upper, q, base=10.0):
        super().__init__(lower, upper, base)
        self.q = float(q)

    def sample(self, rng):
        return _snap_to_q(super().sample(rng), self.q, self.lower, self.upper)


class RandInt(Sampler):
    """Integer in ``[lower, upper)`` (ray.tune.randint convention)."""

    def __init__(self, lower: int, upper: int):
        self.lower, self.upper = int(lower), int(upper)

    def sample(self, rng):
        return int(rng.integers(self.lower, self.upper))

    def __repr__(self):
        return f"randint({self.lower}, {self.upper})"


class QRandInt(RandInt):
    def __init__(self, lower, upper, q):
        super().__init__(lower, upper)
        self.q = int(q)

    def sample(self, rng):
        return int(_snap_to_q(super().sample(rng), self.q, self.lower,
                              self.upper - 1))


class RandN(Sampler):
    def __init__(self, mean: float = 0.0, sd: float = 1.0):
        self.mean, self.sd = float(mean), float(sd)

    def sample(self, rng):
        return float(rng.normal(self.mean, self.sd))


class Subset(Sampler):
    """A random non-empty subset of ``items``, order-preserving (the ref's
    RandomSample over all_available_features — feature selection axis)."""

    def __init__(self, items: Sequence[Any], min_items: int = 1):
        self.items = list(items)
        self.min_items = max(1, int(min_items))
        if self.min_items > len(self.items):
            raise ValueError(f"min_items {min_items} > {len(self.items)} items")

    def sample(self, rng):
        k = int(rng.integers(self.min_items, len(self.items) + 1))
        picked = set(rng.choice(len(self.items), size=k, replace=False)
                     .tolist())
        return [it for i, it in enumerate(self.items) if i in picked]

    def __repr__(self):
        return f"subset({self.items})"


class GridSearch(Sampler):
    """Exhaustive axis: the engine enumerates all values (cross-product with
    other grid axes), matching ray.tune ``grid_search``."""

    def __init__(self, values: Sequence[Any]):
        self.grid = list(values)

    def sample(self, rng):
        return self.grid[int(rng.integers(len(self.grid)))]

    def __repr__(self):
        return f"grid_search({self.grid})"


def choice(categories):
    return Choice(categories)


def uniform(lower, upper):
    return Uniform(lower, upper)


def quniform(lower, upper, q):
    return QUniform(lower, upper, q)


def loguniform(lower, upper, base=10.0):
    return LogUniform(lower, upper, base)


def qloguniform(lower, upper, q, base=10.0):
    return QLogUniform(lower, upper, q, base)


def randint(lower, upper):
    return RandInt(lower, upper)


def qrandint(lower, upper, q):
    return QRandInt(lower, upper, q)


def randn(mean=0.0, sd=1.0):
    return RandN(mean, sd)


def subset(items, min_items: int = 1):
    return Subset(items, min_items)


def grid_search(values):
    return GridSearch(values)


def sample_config(space: dict, rng: np.random.Generator,
                  grid_point: "dict | None" = None) -> dict:
    """Materialize one config: fixed values pass through, samplers draw,
    grid axes take their value from ``grid_point``."""
    out = {}
    for k, v in space.items():
        if grid_point and k in grid_point:
            out[k] = grid_point[k]
        elif isinstance(v, Sampler):
            out[k] = v.sample(rng)
        elif isinstance(v, dict):
            out[k] = sample_config(v, rng, grid_point)
        else:
            out[k] = v
    return out


def grid_points(space: dict) -> List[dict]:
    """Cross-product of every GridSearch axis in ``space`` (flat keys only).
    Returns ``[{}]`` when no grid axes exist."""
    axes = [(k, v.grid) for k, v in space.items()
            if isinstance(v, GridSearch)]
    points: List[dict] = [{}]
    for key, values in axes:
        points = [dict(p, **{key: val}) for p in points for val in values]
    return points
