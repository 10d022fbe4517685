"""Seeded tainted-host-sync violations.

Function names deliberately avoid the lexical rule's hot-name tokens
(dispatch/serve/step/...) so every finding here belongs to the taint
rule, not ``hotpath-host-sync`` — that is the point: the dataflow rule
follows the value into helpers the name heuristic misses. Never
imported; fixture data for chip_smoke.py's phase 26 and
tests/test_torch_zoolint_dataflow.py.
"""

import numpy as np
import torch


def _step_impl(params, tok):
    return tok


def autoregress(params, seq, steps):
    step = torch.compile(_step_impl)
    out = seq
    host = None
    for _t in range(steps):
        out = step(params, out)
        # VIOLATION tainted-host-sync: np.asarray on the compiled output
        # forces a device->host copy every iteration
        host = np.asarray(out)
        # VIOLATION tainted-host-sync: implicit truthiness on a card
        # value blocks on the transfer each iteration
        if out:
            break
    return host


def accumulate(predict_fn, batches):
    total = 0.0
    for b in batches:
        y = predict_fn(b)
        # VIOLATION tainted-host-sync: float() on the *_fn apply output
        total += float(y)
    return total


def score(model, batches, device):
    hits = []
    for b in batches:
        logits = model(b.to(device))
        # VIOLATION tainted-host-sync: .item() on a module call's output
        hits.append(logits.argmax().item())
        mask = torch.ones(4, device=device)
        # VIOLATION tainted-host-sync: .cpu() of a factory made on the card
        hits.append(mask.cpu())
    return hits


def host_math(xs):
    """Negative control: nothing here is device-tainted."""
    total = 0.0
    for x in xs:
        total += float(x)
    return total


def fenced(params, seq, steps):
    """Negative control: the single sync sits outside the loop."""
    step = torch.compile(_step_impl)
    out = seq
    for _t in range(steps):
        out = step(params, out)
    return np.asarray(out)
