"""Turn the JAX package's parameters into the port's.

``flax_to_state_dict`` takes a flax parameter tree as numpy arrays (from
``jax.device_get(variables["params"])``) and returns the torch
``state_dict`` of the same model in the port: ``<module>/kernel``
``[in, out]`` becomes ``<module>.weight`` ``[out, in]`` (transposed, the
``nn.Linear`` layout), ``bias`` stays ``bias`` and ``embedding`` stays
``[vocab, dim]``. flax derives its initial values from module paths, so
the two packages never initialise alike: this is how tests make both
compute the same function. Reading a saved ``state.msgpack`` checkpoint
is later work.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

#: flax leaf name -> (torch leaf name, transpose a 2-D leaf)
_LEAVES = {"kernel": ("weight", True), "bias": ("bias", False),
           "embedding": ("embedding", False)}


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
        tname, transpose = _LEAVES[name]
        arr = np.asarray(sub)
        if transpose and arr.ndim == 2:
            arr = arr.T
        out[f"{prefix}{tname}"] = torch.tensor(arr, dtype=torch.float32)
    return out
