"""Turn the JAX package's parameters into the port's.

``flax_to_state_dict`` takes a flax parameter tree as numpy arrays (from
``jax.device_get(variables["params"])``) and returns the torch
``state_dict`` of the same model in the port, names kept:

- ``kernel`` -> ``weight`` in ``nn.Linear``'s ``[out, in]`` layout. A
  flax kernel is ``[in dims..., out dims...]`` and its bias has the out
  dims, so the kernel is flattened to ``[in, out]`` and transposed:
  ``nn.Dense`` ``[in, out]``, the attention projections ``[in, h, d]``
  (bias ``[h, d]``) and the attention output ``[h, d, out]`` (bias
  ``[out]``) all land as 2-D weights. A kernel without a bias has one out
  dim.
- ``bias`` -> ``bias``, flattened.
- ``scale`` (LayerNorm) -> ``weight``.
- ``embedding`` stays ``[vocab, dim]``.

flax derives its initial values from module paths, so the two packages
never initialise alike: this is how tests make both compute the same
function. Reading a saved ``state.msgpack`` checkpoint is later work.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

#: flax leaf name -> torch leaf name
_LEAVES = {"kernel": "weight", "bias": "bias", "scale": "weight",
           "embedding": "embedding"}


def _linear_weight(kernel: np.ndarray, bias) -> np.ndarray:
    n_out = 1 if bias is None else max(np.ndim(bias), 1)
    n_in = kernel.ndim - n_out
    rows = int(np.prod(kernel.shape[:n_in]))
    return kernel.reshape(rows, -1).T


def flax_to_state_dict(params: Mapping, prefix: str = ""
                       ) -> Dict[str, torch.Tensor]:
    """Flatten a flax ``params`` tree into a torch state dict."""
    out: Dict[str, torch.Tensor] = {}
    for name, sub in params.items():
        key = f"{prefix}{name}"
        if isinstance(sub, Mapping):
            out.update(flax_to_state_dict(sub, prefix=key + "."))
            continue
        if name not in _LEAVES:
            raise KeyError(f"no torch counterpart for flax leaf {key!r}")
        arr = np.asarray(sub)
        if name == "kernel" and arr.ndim >= 2:
            arr = _linear_weight(arr, params.get("bias"))
        elif name == "bias":
            arr = arr.reshape(-1)
        out[f"{prefix}{_LEAVES[name]}"] = torch.tensor(
            np.ascontiguousarray(arr), dtype=torch.float32)
    return out
