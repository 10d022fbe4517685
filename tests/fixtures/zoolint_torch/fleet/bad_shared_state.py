"""Seeded cross-thread state races for the fleet lane
(cross-thread-unlocked-state): an unlocked instance-attr write hidden
behind a helper method, an unlocked module global touched from two
roots, and — as the negative control — a helper that is only ever
called with the lock held, which the must-held propagation must keep
quiet. Never imported."""

import threading

BEATS = 0


def record_beat():
    global BEATS
    BEATS += 1  # VIOLATION cross-thread-unlocked-state (module global)


class RacyHeartbeater:
    def __init__(self):
        self._lock = threading.Lock()
        self.last_beat = 0.0
        self.sent = 0
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        while True:
            self._bump()
            record_beat()

    def _bump(self):
        self.sent += 1  # VIOLATION cross-thread-unlocked-state (helper)

    def _locked_bump(self):
        # OK: every caller holds self._lock — must-held propagation
        self.last_beat += 1.0

    def beat_now(self):
        with self._lock:
            self._locked_bump()

    def reset(self):
        with self._lock:
            self._locked_bump()
        self.sent = 0  # VIOLATION cross-thread-unlocked-state (main side)
        record_beat()
