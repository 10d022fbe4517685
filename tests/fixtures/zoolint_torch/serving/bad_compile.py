"""Seeded jit-compile-in-serve-loop violations.

Hot-path (``serving/`` segment) module whose drain loop compiles,
builds kernels, autotunes and captures graphs in-band — the stall the
warm-up path exists to prevent. Never imported; fixture data for
chip_smoke.py's phase 26 and tests/test_torch_zoolint.py.
"""

import torch

from analytics_zoo_tpu_torch.ops import _build, autotune


def serve_drain_loop(model, rungs, graph):
    outs = []
    for batch in rungs:
        # VIOLATION jit-compile-in-serve-loop (x5): a compile, a kernel
        # build, an autotune measurement, a queued tune and a capture
        step = torch.compile(model)
        _build.load("flash_attention")
        autotune.tune_attention(batch, 128, 12, 64)
        autotune.tune_pending()
        with torch.cuda.graph(graph):
            outs.append(step(batch))
    return outs


def warm_up(model, rungs):
    """Exempt: warm-named functions are the sanctioned build path."""
    return [torch.compile(model) for _ in rungs]


def produce_names(rows):
    for r in rows:
        # str.lower() and re-style compiles are not builds
        yield r.name.lower()
