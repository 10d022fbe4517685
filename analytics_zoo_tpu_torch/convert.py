"""Turn the JAX package's parameters into the port's, and back.

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
- flax's RNN cells (``GRUCell_0``, ``OptimizedLSTMCell_0``,
  ``SimpleCell_0``) are trees of Denses named ``ir``/``iz``/``in``/
  ``hr``/``hz``/``hn`` (GRU), ``ii``/``if``/``ig``/``io``/``hi``/... (LSTM)
  or ``i``/``h``; their kernels and biases follow the rules above, and the
  port's cells (keras/layers.py) register their Linears under the same
  names, ``in`` and ``if`` included.

``state_dict_to_flax`` is its inverse: the port's ``state_dict`` as a
flax tree of numpy arrays, shaped like a given flax tree (a 2-D weight
cannot say how its dims split into ``[in, h, d]``, so the tree's leaves
give the shapes).

flax derives its initial values from module paths, so the two packages
never initialise alike: this is how tests make both compute the same
function, and compare the parameters after training. Reading a saved
``state.msgpack`` checkpoint is later work (ROADMAP A6).
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


def state_dict_to_flax(state_dict: Mapping, like: Mapping, prefix: str = ""
                       ) -> Dict:
    """The inverse of ``flax_to_state_dict``: a flax ``params`` tree of
    fp32 numpy arrays with the structure and leaf shapes of ``like`` (any
    tree whose leaves have ``.shape``), filled from ``state_dict``."""
    out: Dict = {}
    for name, sub in like.items():
        key = f"{prefix}{name}"
        if isinstance(sub, Mapping):
            out[name] = state_dict_to_flax(state_dict, sub, prefix=key + ".")
            continue
        if name not in _LEAVES:
            raise KeyError(f"no torch counterpart for flax leaf {key!r}")
        arr = state_dict[f"{prefix}{_LEAVES[name]}"].detach().cpu().float()
        arr = arr.numpy()
        if name == "kernel" and arr.ndim == 2:
            arr = arr.T
        out[name] = np.ascontiguousarray(arr.reshape(tuple(sub.shape)))
    return out
