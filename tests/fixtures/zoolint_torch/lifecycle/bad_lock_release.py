"""Seeded lock-release-path violations.

Bare ``.acquire()`` calls a path never releases: one early return, one
unguarded call between acquire and release (the exception edge leaks
the lock). The try/finally twin is the negative control. Never
imported; fixture data for chip_smoke.py's phase 26 and
tests/test_torch_zoolint_dataflow.py.
"""

import threading

_lock = threading.Lock()


def submit_unbalanced(jobs):
    # VIOLATION lock-release-path: the empty-jobs return leaves it held
    _lock.acquire()
    if not jobs:
        return 0
    n = len(jobs)
    _lock.release()
    return n


def submit_fragile(jobs):
    # VIOLATION lock-release-path: encode() raising skips the release
    _lock.acquire()
    payload = jobs.encode()
    _lock.release()
    return payload


def submit_guarded(jobs):
    """Negative control: released in a finally on every path."""
    _lock.acquire()
    try:
        return len(jobs)
    finally:
        _lock.release()
