"""Mixed-precision dtype policy for the zoo-keras API.

Counterpart of ``analytics_zoo_tpu/keras/policy.py``, with torch dtypes:

    from analytics_zoo_tpu_torch.keras import policy
    policy.set_dtype_policy("mixed_bfloat16")
    model = ...   # layers built from here on compute in bf16
    policy.set_dtype_policy("float32")

``mixed_bfloat16`` means bf16 compute with fp32 parameters: layers cast
their parameters and inputs to bf16 in the forward pass, and
``FusedEmbeddings`` casts its tables before the lookup. The policy is
snapshotted when a layer object is constructed, so later flips do not
change layers already built.
"""

from __future__ import annotations

from contextlib import contextmanager
from typing import Optional

import torch

_POLICIES = {
    "float32": None,            # parameters' own dtype: fp32
    "mixed_bfloat16": torch.bfloat16,
    "bfloat16": torch.bfloat16,  # alias (params stay fp32 either way)
}

_current = "float32"


def set_dtype_policy(name: str) -> None:
    global _current
    if name not in _POLICIES:
        raise ValueError(
            f"unknown dtype policy {name!r}; one of {sorted(_POLICIES)}")
    _current = name


def dtype_policy() -> str:
    return _current


def compute_dtype() -> Optional[torch.dtype]:
    """The compute dtype of layers built under the current policy (None =
    the parameters' dtype, fp32)."""
    return _POLICIES[_current]


@contextmanager
def policy_scope(name: str):
    """Temporarily switch the policy (e.g. build one model in bf16)."""
    prev = _current
    set_dtype_policy(name)
    try:
        yield
    finally:
        set_dtype_policy(prev)
