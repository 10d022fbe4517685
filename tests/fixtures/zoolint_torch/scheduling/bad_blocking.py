"""Seeded blocking-under-lock for the scheduling lane: the loop thread
sleeps while holding a lock the submit path also needs, so every
submitter stalls for the full sleep — priority lanes and deadlines
can't help a request that is stuck behind a held mutex. Never
imported."""

import threading
import time


class SleepyScheduler:
    def __init__(self):
        self._lock = threading.Lock()
        self.pending = 0
        self._t = threading.Thread(target=self._loop, daemon=True)
        self._t.start()

    def _loop(self):
        while True:
            with self._lock:
                time.sleep(0.5)  # VIOLATION blocking-under-lock

    def submit(self, n):
        with self._lock:
            self.pending += n
