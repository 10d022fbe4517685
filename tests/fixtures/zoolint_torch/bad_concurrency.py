"""Seeded concurrency violations (engine-unlocked-write, lock-order).
Never imported."""

import threading


class LeakyEngine:
    def __init__(self):
        self._lock = threading.Lock()
        self.count = 0
        self._thread = None

    def start(self):
        self._thread = threading.Thread(target=self._run)
        self._thread.start()

    def _run(self):
        while True:
            self.count += 1  # VIOLATION engine-unlocked-write

    def reset(self):
        self.count = 0  # VIOLATION engine-unlocked-write (caller side)


class AbbaLocks:
    def __init__(self):
        self.lock_a = threading.Lock()
        self.lock_b = threading.Lock()

    def forward(self):
        with self.lock_a:
            with self.lock_b:
                pass

    def backward(self):
        with self.lock_b:
            with self.lock_a:  # VIOLATION lock-order
                pass
