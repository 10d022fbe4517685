"""Seeded shape-dependent-branch-in-jit violations.

Python branches on traced values inside the compiled region: a shape
branch and a value branch in a decorated entry, a value branch in a
helper the call graph proves is reached from a compiled body, and a
shape branch in a function run under a CUDA-graph capture. ``is None``
tests and the eager caller around the capture are the negative
controls. Never imported; fixture data for chip_smoke.py's phase 26
and tests/test_torch_zoolint_dataflow.py.
"""

import torch


@torch.compile
def scale_clamped(x, limit):
    # VIOLATION shape-dependent-branch-in-jit: one graph compiled per
    # input length
    if x.shape[0] > 8:
        return x[:8]
    # VIOLATION shape-dependent-branch-in-jit: traced-scalar branch
    # breaks the graph
    if limit > 0:
        return x * limit
    return x


def _helper_norm(v, eps):
    # VIOLATION shape-dependent-branch-in-jit: `eps` is fed from a
    # traced caller value — this helper traces inside `normalize`
    if eps > 0:
        return v / eps
    return v


@torch.compile(dynamic=False)
def normalize(v, eps):
    return _helper_norm(v, eps)


def _captured_step(x):
    # VIOLATION shape-dependent-branch-in-jit: the capture bakes in the
    # branch taken at capture time
    if len(x) > 4:
        return x[:4]
    return x


def capture(graph, x):
    """Negative control: the caller branches eagerly, outside the
    capture; the captured callee is the entry."""
    if x is None:
        return None
    with torch.cuda.graph(graph):
        y = _captured_step(x)
    return y


@torch.compile
def with_default(x, bias):
    """Negative control: `is None` is static when traced."""
    if bias is None:
        return x
    return x + bias
