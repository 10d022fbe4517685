"""Seeded wallclock-hotpath and hotpath-host-sync violations.

Lives under a ``serving/`` path segment so zoolint classifies it as a
hot-path module. Never imported — fixture data for chip_smoke.py's
phase 26 and tests/test_torch_zoolint.py.
"""

import time

import numpy as np
import torch


def dispatch_loop(batches, fences):
    t0 = time.time()  # VIOLATION wallclock-hotpath
    total = 0.0
    for batch in batches:  # VIOLATION hotpath-host-sync (x7 below)
        total += float(batch.loss)
        total += batch.loss.item()
        total += int(batch.count)
        rows = batch.logits.cpu().numpy()
        total += len(batch.ids.to("cpu").tolist())
        torch.cuda.synchronize()
        fences.synchronize()
    host = [np.asarray(b) for b in batches]  # VIOLATION hotpath-host-sync
    return total, host, rows, time.time() - t0  # VIOLATION wallclock-hotpath


def dispatch_sampled(batches, sampled):
    """Suppressions and sampling guards must keep this half clean."""
    t0 = time.time()  # zoolint: disable=wallclock-hotpath
    for batch in batches:
        if sampled:
            torch.cuda.synchronize()  # guarded: not a finding
    return time.time() - t0  # zoolint: disable=wallclock-hotpath
