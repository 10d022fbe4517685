"""Module-level locks plus the A->B half of a cross-file lock-order
inversion — bad_lock_cycle.py imports these locks and takes them B->A,
which only the whole-program acquisition graph can see. Never
imported."""

import threading

LOCK_ALPHA = threading.Lock()
LOCK_BETA = threading.Lock()


def grab_forward():
    with LOCK_ALPHA:
        with LOCK_BETA:
            pass
