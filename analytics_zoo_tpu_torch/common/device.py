"""Device resolution for the port's entry points.

Every entry point takes ``device=None`` and runs on ``cuda``; the CPU is
used only when the caller names it, as the tests do. There is no silent
fallback: asking for CUDA on a machine without it raises.
"""

from __future__ import annotations

import threading
from typing import Optional, Union

import numpy as np
import torch

DeviceLike = Optional[Union[str, torch.device]]

#: held while torch's global generators are seeded and drawn from (a
#: step's dropout, a module's initial weights): threads that train side by
#: side (``automl.search``'s ``n_parallel``) then draw what each would
#: draw alone
RNG_LOCK = threading.RLock()


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` → ``cuda``. A CUDA device raises when CUDA is absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but CUDA is not available; "
            "pass device='cpu' to run on the host")
    return dev


def as_tensor(a, device: torch.device) -> torch.Tensor:
    """One model input as a tensor on ``device``. float64 arrays become
    float32, as JAX (without x64) treats them; a tensor is moved as it is
    (float64 cast likewise)."""
    if isinstance(a, torch.Tensor):
        return a.to(device, torch.float32 if a.dtype == torch.float64
                    else a.dtype)
    arr = np.ascontiguousarray(a)
    if arr.dtype == np.float64:
        arr = arr.astype(np.float32)
    return torch.from_numpy(arr).to(device)


def to_numpy(out):
    """Model output(s) on the host as numpy; bf16 becomes float32 (numpy
    has no bf16)."""
    if isinstance(out, tuple):
        return tuple(to_numpy(o) for o in out)
    out = out.detach()
    if out.dtype == torch.bfloat16:
        out = out.float()
    return out.cpu().numpy()
