"""Seeded record-ack-leak violations.

Lives under a ``serving/`` path segment so the rule treats it as broker
code. Three shapes of the defect — an exception-free leak (a branch
that finishes the iteration without settling), a double settlement, and
an ack list that is never flushed — with a clean drain as the negative
control. Never imported; fixture data for chip_smoke.py's phase 26 and
tests/test_torch_zoolint_dataflow.py.
"""


def drain_leaky(client, stream, group):
    entries = client.xreadgroup(group, "w0", {stream: ">"}, count=64)
    acks = []
    buckets = []
    # VIOLATION record-ack-leak: the `payload is None` branch continues
    # without an ack or a re-bin — that record's lease leaks forever
    for eid, payload in entries:
        if payload is None:
            continue
        if payload.get("expired"):
            acks.append(("XACK", stream, group, eid))
            continue
        buckets.append((eid, payload))
    if acks:
        client.pipeline(acks)
    return buckets


def drain_double(client, stream, group):
    entries = client.xreadgroup(group, "w0", {stream: ">"})
    acks = []
    buckets = []
    # VIOLATION record-ack-leak: every record is both re-binned and
    # acked — a crash after the flush double-serves or loses the copy
    for eid, payload in entries:
        buckets.append((eid, payload))
        acks.append(("XACK", stream, group, eid))
    client.pipeline(acks)
    return buckets


def drain_unflushed(client, stream, group):
    entries = client.xreadgroup(group, "w0", {stream: ">"})
    acks = []
    for eid, _payload in entries:
        # VIOLATION record-ack-leak: `acks` is never flushed or
        # returned — the XACKs are dropped on the floor
        acks.append(("XACK", stream, group, eid))


def drain_clean(client, stream, group):
    """Negative control: every path settles exactly once and the ack
    list flushes behind a truthiness guard."""
    entries = client.xreadgroup(group, "w0", {stream: ">"})
    acks = []
    buckets = []
    for eid, payload in entries:
        if payload is None:
            acks.append(("XACK", stream, group, eid))
            continue
        buckets.append((eid, payload))
    if acks:
        client.pipeline(acks)
    return buckets
