"""Negative control for the call graph (cross-thread-unlocked-state): a
call on a name imported from outside the project, ``torch.cuda.stream(s)``
on a worker thread, never reaches the project's only ``stream`` method by
the method's name. That method writes unlocked state which only the main
thread reaches; were the worker's call joined to it, the write would read
as a race between two roots. Never imported."""

import threading

import torch


class StreamTable:
    def __init__(self):
        self.streams = {}

    def stream(self, name):
        # OK: only the main thread calls this; the worker's
        # torch.cuda.stream(s) is torch's own, not this method
        self.streams[name] = self.streams.get(name, 0) + 1
        return name


def _worker(s):
    with torch.cuda.stream(s):
        pass


def start(s):
    t = threading.Thread(target=_worker, args=(s,), daemon=True)
    t.start()
    table = StreamTable()
    table.stream("main")
    return t
