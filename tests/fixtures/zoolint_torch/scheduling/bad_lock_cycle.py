"""The B->A half of the cross-file lock-order inversion seeded in
locks_shared.py (lock-order-inversion). Never imported."""

from tests.fixtures.zoolint_torch.scheduling.locks_shared import LOCK_ALPHA, LOCK_BETA


def grab_backward():
    with LOCK_BETA:
        with LOCK_ALPHA:  # VIOLATION lock-order-inversion (cross-file)
            pass
