"""Seeded span-pairing violations.

Enter/exit call pairs (attach/detach, arm/disarm) a path leaves
unbalanced. Long-lived attaches with no exit call anywhere in the
function are deliberately out of scope — ``install_forever`` is the
negative control for that carve-out, ``traced_guarded`` for the
try/finally fix. Never imported; fixture data for chip_smoke.py's phase 26
and tests/test_torch_zoolint_dataflow.py.
"""


def traced_submit(tracer, batch):
    # VIOLATION span-pairing: the batch-is-None return skips the detach
    tracer.attach("submit")
    if batch is None:
        return None
    out = list(batch)
    tracer.detach("submit")
    return out


def armed_flush(watchdog, payload):
    # VIOLATION span-pairing: encode() raising skips the disarm
    watchdog.arm(5.0)
    result = payload.encode()
    watchdog.disarm()
    return result


def traced_guarded(tracer, batch):
    """Negative control: the detach sits in a finally."""
    tracer.attach("submit")
    try:
        return list(batch)
    finally:
        tracer.detach("submit")


def install_forever(tracer):
    """Negative control: a process-lifetime hook never detaches — the
    rule requires a matching exit call somewhere in the function."""
    tracer.attach("process-lifetime")
    return tracer
