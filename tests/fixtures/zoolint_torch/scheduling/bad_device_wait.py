"""Seeded blocking-under-lock on the card: the step thread waits for the
device while holding a lock the submit path also needs, so every
submitter stalls for the whole of the card's queue. Never imported."""

import threading

import torch


class SyncingStepper:
    def __init__(self):
        self._lock = threading.Lock()
        self.pending = 0
        self._t = threading.Thread(target=self._loop, daemon=True)
        self._t.start()

    def _loop(self):
        while True:
            with self._lock:
                torch.cuda.synchronize()  # VIOLATION blocking-under-lock

    def submit(self, n):
        with self._lock:
            self.pending += n
