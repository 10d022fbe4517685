"""Seeded thread-lifecycle leak for the chaos lane (thread-leak): a
non-daemon thread that is started but never joined blocks interpreter
shutdown — exactly the hang the chaos drills' kill paths would surface
at the worst time. The daemon spawn below is the negative control.
Never imported."""

import threading


def _pump():
    while True:
        pass


def launch_pump():
    t = threading.Thread(target=_pump)  # VIOLATION thread-leak
    t.start()


class Drainer:
    def __init__(self):
        # OK: daemon threads cannot block shutdown
        self._t = threading.Thread(target=self._drain, daemon=True)
        self._t.start()

    def _drain(self):
        pass
