"""Broker — the serving data plane: a stream in, a hash out.

The port's own copy of ``analytics_zoo_tpu/serving/broker.py``. The
reference's data plane is a Redis server; here it is ``zbroker``, a native
C++ broker (the port's own ``serving/native/zbroker.cpp``) compiled at
first use and launched as a subprocess, or the pure-Python broker with the
identical wire protocol (an in-process threaded TCP server, the protocol's
executable spec). Either package's clients and engines talk to either
package's brokers.

Protocol: newline-delimited text; payloads are opaque base64 (the command
set is in zbroker.cpp's header). Entries carry a *lane* tag (priority
class) so the engine can dequeue interactive traffic ahead of batch work;
per-lane XSHED flags let admission control refuse new enqueues at the
broker; XCLAIM hands a dead consumer's leased entries to a live one.

The native binary lands in ``build/native/`` at the repository root,
named by a digest of its source and flags (as ``ops/_build.py`` names the
kernels), written under a temporary name and renamed into place, so
processes that build at once never run a half-written binary.
"""

from __future__ import annotations

import errno
import hashlib
import logging
import os
import shutil
import socket
import socketserver
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, List, Optional

logger = logging.getLogger(__name__)

NATIVE_SRC = Path(__file__).resolve().parent / "native" / "zbroker.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
CXX_FLAGS = ("-O2", "-std=c++17", "-pthread")

# lane of entries enqueued without an explicit priority — mirrors
# schema.DEFAULT_PRIORITY (the broker stays importable on its own)
DEFAULT_LANE = "default"

_build_lock = threading.Lock()


class ShedError(RuntimeError):
    """XADD rejected because the target lane is shedding (admission
    control). Typed so enqueueing clients fail fast instead of burning
    their poll timeout waiting for a result that will never exist."""


def native_binary_path() -> Path:
    """Where the binary of the current source and flags lives."""
    digest = hashlib.sha256(
        NATIVE_SRC.read_bytes() + " ".join(CXX_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"zbroker-{digest[:16]}"


def build_native_broker() -> Path:
    """The native broker's binary, compiled first if it is not built yet
    (``c++ -O2 -std=c++17 -pthread``). Raises ``RuntimeError`` with the
    compiler's output when there is no compiler or the build fails."""
    binary = native_binary_path()
    with _build_lock:
        if binary.exists():
            return binary
        cxx = os.environ.get("CXX") or shutil.which("c++") \
            or shutil.which("g++")
        if not cxx:
            raise RuntimeError("native broker build failed: no C++ "
                               "compiler (c++, g++ or $CXX)")
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = binary.with_name(
            f"{binary.name}.{os.getpid()}.{threading.get_ident()}.tmp")
        try:
            proc = subprocess.run(
                [cxx, *CXX_FLAGS, "-o", str(tmp), str(NATIVE_SRC)],
                capture_output=True, text=True, timeout=300)
        except (OSError, subprocess.SubprocessError) as e:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"native broker build failed: {e}") from e
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(
                f"native broker build failed ({cxx} exited "
                f"{proc.returncode}):\n{proc.stderr}")
        # atomic: a concurrent build never runs a half-written binary
        os.replace(tmp, binary)
        return binary


def _reconnects_total():
    from analytics_zoo_tpu_torch.common import telemetry
    return telemetry.get_registry().counter(
        "zoo_broker_reconnects_total",
        "transparent client reconnects after transient socket errors")


class BrokerClient:
    """One TCP connection to the broker. Thread-compatible: callers must
    not share one client across threads (make one per thread — connects
    are cheap; matches redis-py usage in the reference client)."""

    # commands safe to transparently resend after a transient socket
    # error: pure reads plus XACK (double-ack is a no-op returning 0).
    # XADD/HSET/HDEL/DEL are NOT here — resending them after an ambiguous
    # failure could duplicate a record or clobber a newer write.
    _IDEMPOTENT = frozenset({
        "PING", "XLEN", "XREADGROUP", "XCLAIM", "XPENDING", "XACK",
        "HGET", "HKEYS", "XSHED",  # XSHED writes an absolute flag value
    })
    RECONNECT_TRIES = 3
    RECONNECT_BACKOFF_S = 0.05

    def __init__(self, host: str = "127.0.0.1", port: int = 6399,
                 timeout: float = 30.0):
        self.addr = (host, port)
        self._timeout = timeout
        self.sock = socket.create_connection(self.addr, timeout=timeout)
        self.sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self._buf = b""
        # bumped on every transparent _reconnect: callers holding state
        # keyed by broker entry ids (the engine's dedupe ring) watch this
        # to learn the peer may be a RESTARTED broker with fresh ids
        self.generation = 0

    # --- wire ---
    def _send(self, *parts: str):
        self.sock.sendall((" ".join(parts) + "\n").encode())

    def _readline(self) -> str:
        while b"\n" not in self._buf:
            chunk = self.sock.recv(65536)
            if not chunk:
                raise ConnectionError("broker closed connection")
            self._buf += chunk
        line, self._buf = self._buf.split(b"\n", 1)
        return line.decode()

    def _reply(self, raise_on_error: bool = True):
        line = self._readline()
        kind, rest = line[0], line[1:]
        if kind == "+":
            return rest
        if kind == ":":
            return int(rest)
        if kind == "$":
            return None if rest == "-1" else rest
        if kind == "*":
            return [self._readline() for _ in range(int(rest))]
        if kind == "-":
            # -SHED is a typed refusal (lane admission control), not a
            # protocol failure — callers catch ShedError specifically
            if rest.startswith("SHED"):
                err: RuntimeError = ShedError(rest)
            else:
                err = RuntimeError(f"broker error: {rest}")
            if raise_on_error:
                raise err
            return err
        raise RuntimeError(f"bad reply line: {line!r}")

    @staticmethod
    def _transient(e: BaseException) -> bool:
        """ECONNRESET/EPIPE-class errors worth one transparent retry.
        A clean peer close (empty recv → ConnectionError in _readline)
        counts: that is how a broker restart looks to this client.
        Timeouts do NOT — the command may still be executing."""
        if isinstance(e, (socket.timeout, TimeoutError)):
            return False
        if isinstance(e, (ConnectionResetError, BrokenPipeError,
                          ConnectionError)):
            return True
        return getattr(e, "errno", None) in (errno.ECONNRESET, errno.EPIPE)

    def _reconnect(self):
        """Redial self.addr with bounded exponential backoff and count the
        reconnect (zoo_broker_reconnects_total)."""
        try:
            self.sock.close()
        except OSError:
            pass
        self._buf = b""
        delay = self.RECONNECT_BACKOFF_S
        last: Optional[BaseException] = None
        for _ in range(self.RECONNECT_TRIES):
            try:
                self.sock = socket.create_connection(
                    self.addr, timeout=self._timeout)
                self.sock.setsockopt(
                    socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
                self.generation += 1
                _reconnects_total().inc()
                return
            except OSError as e:
                last = e
                time.sleep(delay)
                delay *= 2
        raise ConnectionError(
            f"broker reconnect to {self.addr} failed: {last}")

    def _cmd(self, *parts: str):
        try:
            self._send(*parts)
            return self._reply()
        except (ConnectionError, OSError) as e:
            if parts[0] not in self._IDEMPOTENT or not self._transient(e):
                raise
            # reconnect once, resend once: at-most-one transparent retry
            # per command keeps the backoff bounded under a dead broker
            self._reconnect()
            self._send(*parts)
            return self._reply()

    # writes are chunked so the broker can drain its send buffer between
    # chunks — one giant sendall can deadlock both peers once the replies
    # fill the kernel buffers while the client is still writing
    PIPELINE_CHUNK = 512

    def pipeline(self, cmds) -> list:
        """Send commands in chunked batches, reading each chunk's replies
        before the next write (same contract as redis-py pipelines in the
        reference client). ``cmds`` is an iterable of argument tuples.
        ALL replies are read before an error is raised, so the connection
        stays in sync even when a command fails."""
        cmds = list(cmds)
        out: list = []
        for start in range(0, len(cmds), self.PIPELINE_CHUNK):
            chunk = cmds[start:start + self.PIPELINE_CHUNK]
            blob = "".join(" ".join(parts) + "\n" for parts in chunk)
            self.sock.sendall(blob.encode())
            out.extend(self._reply(raise_on_error=False) for _ in chunk)
        for r in out:
            if isinstance(r, RuntimeError):
                raise r
        return out

    # --- commands ---
    def ping(self) -> bool:
        return self._cmd("PING") == "PONG"

    def xadd(self, stream: str, payload_b64: str,
             lane: Optional[str] = None) -> int:
        """Append to the stream, tagged with ``lane`` (priority class).
        Raises ShedError when the lane's shed flag is set (XSHED)."""
        if lane is None:
            return int(self._cmd("XADD", stream, payload_b64))
        return int(self._cmd("XADD", stream, payload_b64, lane))

    def xlen(self, stream: str, lane: Optional[str] = None) -> int:
        if lane is None:
            return self._cmd("XLEN", stream)
        return self._cmd("XLEN", stream, lane)

    def xreadgroup(self, group: str, consumer: str, stream: str,
                   count: int, block_ms: int = 0,
                   lanes: Optional[str] = None) -> List[tuple]:
        """Read up to ``count`` new entries for the group. With ``lanes``
        (comma-separated priority order, e.g. "interactive,default,batch")
        delivery drains lanes in that order and each result is an
        ``(id, lane, payload)`` 3-tuple; the legacy laneless form returns
        ``(id, payload)`` and delivers all lanes in id order."""
        old = self.sock.gettimeout()
        if block_ms:
            self.sock.settimeout(max(old or 0, block_ms / 1000.0 + 10))
        try:
            parts = ["XREADGROUP", group, consumer, stream,
                     str(count), str(block_ms)]
            if lanes:
                parts.append(lanes)
            lines = self._cmd(*parts)
        finally:
            self.sock.settimeout(old)
        out: List[tuple] = []
        for ln in lines:
            if lanes:
                i, lane, payload = ln.split(" ", 2)
                out.append((int(i), lane, payload))
            else:
                i, payload = ln.split(" ", 1)
                out.append((int(i), payload))
        return out

    def xclaim(self, stream: str, group: str, consumer: str,
               min_idle_ms: int, count: int,
               lanes: Optional[str] = None) -> List[tuple]:
        """Re-deliver pending entries idle >= min_idle_ms that belong to
        OTHER consumers, transferring ownership to ``consumer`` (dead-
        consumer recovery; Redis XAUTOCLAIM analog). A consumer's own
        in-flight entries are never handed back to it — idle time is a
        lease, and you cannot steal your own lease. With ``lanes`` the
        claim drains lanes in the given order (a dead replica's
        interactive entries come back before its batch backlog) and each
        result is ``(id, lane, payload)``."""
        parts = ["XCLAIM", stream, group, consumer,
                 str(min_idle_ms), str(count)]
        if lanes:
            parts.append(lanes)
        lines = self._cmd(*parts)
        out: List[tuple] = []
        for ln in lines:
            if lanes:
                i, lane, payload = ln.split(" ", 2)
                out.append((int(i), lane, payload))
            else:
                i, payload = ln.split(" ", 1)
                out.append((int(i), payload))
        return out

    def xshed_set(self, stream: str, lane: str, shedding: bool) -> str:
        """Set/clear the shed flag on one lane: while set, XADDs to that
        lane are rejected with -SHED (absolute write — safe to repeat)."""
        return self._cmd("XSHED", stream, lane, "1" if shedding else "0")

    def xshed(self, stream: str) -> List[str]:
        """Names of lanes currently shedding on this stream."""
        return self._cmd("XSHED", stream)

    def xack(self, stream: str, group: str, entry_id: int) -> int:
        return self._cmd("XACK", stream, group, str(entry_id))

    def xpending(self, stream: str, group: str) -> int:
        return self._cmd("XPENDING", stream, group)

    def xpending_detail(self, stream: str, group: str) -> Dict[str, int]:
        """Per-consumer pending breakdown: consumer id -> count of
        delivered-but-unacked entries it currently owns (Redis
        ``XPENDING <key> <group>`` summary analog)."""
        out: Dict[str, int] = {}
        for ln in self._cmd("XPENDING", stream, group, "DETAIL"):
            consumer, n = ln.rsplit(" ", 1)
            out[consumer] = int(n)
        return out

    def hset(self, key: str, field: str, value_b64: str):
        return self._cmd("HSET", key, field, value_b64)

    def hget(self, key: str, field: str) -> Optional[str]:
        return self._cmd("HGET", key, field)

    def hkeys(self, key: str) -> List[str]:
        return self._cmd("HKEYS", key)

    def hdel(self, key: str, field: str) -> int:
        return self._cmd("HDEL", key, field)

    def delete(self, key: str):
        return self._cmd("DEL", key)

    def shutdown_broker(self):
        try:
            self._cmd("SHUTDOWN")
        except (ConnectionError, OSError):
            pass

    def close(self):
        try:
            self.sock.close()
        except OSError:
            pass


# ---------------------------------------------------------------- python impl
class _PyState:
    def __init__(self, hash_ttl_ms: int = 600_000):
        self.lock = threading.Lock()
        self.cv = threading.Condition(self.lock)
        self.streams: Dict[str, dict] = {}
        # stream -> set of lane names whose XADDs are being rejected
        # (admission control; set by the engine via XSHED)
        self.shed: Dict[str, set] = {}
        self.hashes: Dict[str, Dict[str, str]] = {}
        # last-write ms per hash field — uncollected results expire so the
        # broker's memory stays bounded (native zbroker.cpp does the same;
        # the reference relied on Redis EXPIRE for this)
        self.hash_times: Dict[str, Dict[str, float]] = {}
        self.hash_ttl_ms = int(hash_ttl_ms)

    def evict_expired(self, key: str):
        """Drop expired fields of one hash key. Caller holds the lock.
        Monotonic clock: TTL math must not jump with NTP steps."""
        if self.hash_ttl_ms <= 0:
            return
        now_ms = time.monotonic() * 1000
        times = self.hash_times.get(key)
        if not times:
            return
        h = self.hashes.get(key, {})
        for field in [f for f, t in times.items()
                      if now_ms - t >= self.hash_ttl_ms]:
            times.pop(field, None)
            h.pop(field, None)
        if not times:
            self.hash_times.pop(key, None)
        if not h:
            self.hashes.pop(key, None)

    def evict_some(self, key: str, limit: int = 8):
        """Amortized eviction for the HSET hot path: check only the
        oldest `limit` fields (dict order = write order, so the head of
        hash_times is the oldest). A full-key scan here would make every
        write O(live fields) exactly when the consumer is slow — the
        scenario TTL exists for; the periodic sweeper keeps the overall
        memory bound. Caller holds the lock."""
        if self.hash_ttl_ms <= 0:
            return
        times = self.hash_times.get(key)
        if not times:
            return
        now_ms = time.monotonic() * 1000
        h = self.hashes.get(key, {})
        expired = []
        for field, t in times.items():
            if len(expired) >= limit or now_ms - t < self.hash_ttl_ms:
                break  # ordered by write time: first live field ends it
            expired.append(field)
        for field in expired:
            times.pop(field, None)
            h.pop(field, None)
        if not times:
            self.hash_times.pop(key, None)
        if not h:
            self.hashes.pop(key, None)

    def field_expired(self, key: str, field: str) -> bool:
        """O(1) single-field expiry check (the HGET hot path must not scan
        the whole key). Deletes the field when expired. Caller holds the
        lock."""
        if self.hash_ttl_ms <= 0:
            return False
        t = self.hash_times.get(key, {}).get(field)
        if t is None or time.monotonic() * 1000 - t < self.hash_ttl_ms:
            return False
        self.hash_times.get(key, {}).pop(field, None)
        self.hashes.get(key, {}).pop(field, None)
        return True

    def sweep(self):
        """Evict every key's expired fields (periodic memory bound even
        when no client touches a key again)."""
        with self.lock:
            for key in list(self.hash_times):
                self.evict_expired(key)

    def stream(self, name):
        # entries: (id, payload, lane) — one id space across lanes so
        # lease/ack/GC semantics stay unified while delivery partitions
        return self.streams.setdefault(
            name, {"entries": [], "next_id": 1, "groups": {}})

    def group(self, st, name):
        # pending: entry id -> [owner consumer, last delivery ms, delivery
        # count, lane]. The owner+timestamp pair is the delivery lease
        # XCLAIM arbitrates on; the count makes redelivery observable; the
        # lane lets XCLAIM hand back high-priority entries first.
        # cursor: lane -> last-delivered id (per-lane so draining one lane
        # never marks another lane's entries as seen).
        return st["groups"].setdefault(name, {"cursor": {}, "pending": {}})


class _PyHandler(socketserver.StreamRequestHandler):
    def handle(self):
        state: _PyState = self.server.state  # type: ignore[attr-defined]
        while True:
            raw = self.rfile.readline()
            if not raw:
                return
            line = raw.decode().rstrip("\r\n")
            if not line:
                continue
            p = line.split(" ")
            cmd = p[0]
            w = self.wfile
            if cmd == "PING":
                w.write(b"+PONG\n")
            elif cmd == "SHUTDOWN":
                w.write(b"+BYE\n")
                threading.Thread(target=self.server.shutdown,
                                 daemon=True).start()
                return
            elif cmd == "XADD" and len(p) >= 3:
                lane = p[3] if len(p) >= 4 else DEFAULT_LANE
                shed = False
                with state.cv:
                    if lane in state.shed.get(p[1], ()):
                        shed = True
                    else:
                        st = state.stream(p[1])
                        eid = st["next_id"]
                        st["next_id"] += 1
                        st["entries"].append((eid, p[2], lane))
                        state.cv.notify_all()
                if shed:
                    w.write(f"-SHED lane {lane} is shedding\n".encode())
                else:
                    w.write(f"+{eid}\n".encode())
            elif cmd == "XLEN" and len(p) >= 2:
                with state.lock:
                    entries = state.stream(p[1])["entries"]
                    if len(p) >= 3:
                        n = sum(1 for e in entries if e[2] == p[2])
                    else:
                        n = len(entries)
                w.write(f":{n}\n".encode())
            elif cmd == "XREADGROUP" and len(p) >= 6:
                group, consumer, stream = p[1], p[2], p[3]
                count, block_ms = int(p[4]), int(p[5])
                # optional lanes arg: comma-separated delivery order —
                # all undelivered entries of lanes[0] go first, then
                # lanes[1], ... The laneless form delivers every lane in
                # id order (legacy parity).
                lanes = p[6].split(",") if len(p) >= 7 and p[6] else None

                def deliver():
                    st = state.stream(stream)
                    gr = state.group(st, group)
                    cur = gr["cursor"]
                    got = []
                    now_ms = int(time.monotonic() * 1000)
                    for want in (lanes if lanes is not None else [None]):
                        for eid, payload, elane in st["entries"]:
                            if want is not None and elane != want:
                                continue
                            if eid <= cur.get(elane, 0):
                                continue
                            got.append((eid, elane, payload))
                            cur[elane] = eid
                            gr["pending"][eid] = [consumer, now_ms, 1,
                                                  elane]
                            if len(got) >= count:
                                return got
                    return got
                with state.cv:
                    got = deliver()
                    if not got and block_ms > 0:
                        deadline = time.monotonic() + block_ms / 1000.0
                        while not got:
                            left = deadline - time.monotonic()
                            if left <= 0:
                                break
                            state.cv.wait(left)
                            got = deliver()
                out = [f"*{len(got)}\n"]
                if lanes is not None:
                    out += [f"{eid} {elane} {payload}\n"
                            for eid, elane, payload in got]
                else:
                    out += [f"{eid} {payload}\n"
                            for eid, _, payload in got]
                w.write("".join(out).encode())
            elif cmd == "XACK" and len(p) >= 4:
                with state.lock:
                    st = state.stream(p[1])
                    gr = state.group(st, p[2])
                    n = 1 if gr["pending"].pop(int(p[3]), None) is not None \
                        else 0
                    # GC entries delivered+acked by every group (see
                    # zbroker.cpp XACK). Cursors are per-lane, so an
                    # entry is collectible only when every group has
                    # passed it ON ITS LANE and nobody holds it pending;
                    # prefix-drop stops at the first keeper.
                    if st["groups"]:
                        drop = 0
                        entries = st["entries"]
                        while drop < len(entries):
                            eid, _, lane = entries[drop]
                            if any(g["cursor"].get(lane, 0) < eid
                                   or eid in g["pending"]
                                   for g in st["groups"].values()):
                                break
                            drop += 1
                        if drop:
                            st["entries"] = entries[drop:]
                w.write(f":{n}\n".encode())
            elif cmd == "XCLAIM" and len(p) >= 6:
                # XCLAIM <stream> <group> <consumer> <min_idle_ms> <count>:
                # re-deliver pending entries whose lease expired — idle
                # >= min_idle_ms AND owned by a DIFFERENT consumer (the
                # recovery path for entries a dead consumer never acked —
                # Redis XAUTOCLAIM analog). Claiming transfers ownership,
                # refreshes the lease clock and bumps the delivery count.
                # Optional trailing lanes arg: claim in that lane order
                # (a dead replica's interactive leases are recovered
                # before its batch backlog), replying with the lane field.
                claimer = p[3]
                min_idle, cnt = int(p[4]), int(p[5])
                lanes = p[6].split(",") if len(p) >= 7 and p[6] else None
                with state.lock:
                    st = state.stream(p[1])
                    gr = state.group(st, p[2])
                    now_ms = int(time.monotonic() * 1000)
                    eligible = sorted(
                        eid for eid, rec in gr["pending"].items()
                        if rec[0] != claimer and now_ms - rec[1] >= min_idle)
                    payloads = {eid: payload
                                for eid, payload, _ in st["entries"]}
                    got = []
                    for want in (lanes if lanes is not None else [None]):
                        for eid in eligible:
                            if len(got) >= cnt:
                                break
                            rec = gr["pending"][eid]
                            if rec[0] == claimer:
                                continue  # claimed earlier this sweep
                            elane = rec[3]
                            if want is not None and elane != want:
                                continue
                            if eid in payloads:
                                gr["pending"][eid] = [claimer, now_ms,
                                                      rec[2] + 1, elane]
                                got.append((eid, elane, payloads[eid]))
                        if len(got) >= cnt:
                            break
                out = [f"*{len(got)}\n"]
                if lanes is not None:
                    out += [f"{eid} {elane} {payload}\n"
                            for eid, elane, payload in got]
                else:
                    out += [f"{eid} {payload}\n" for eid, _, payload in got]
                w.write("".join(out).encode())
            elif cmd == "XPENDING" and len(p) >= 4:
                # XPENDING <stream> <group> DETAIL: per-consumer breakdown
                # (consumer id -> owned pending count), the fleet
                # supervisor's view of who is holding which leases
                with state.lock:
                    gr = state.group(state.stream(p[1]), p[2])
                    per: Dict[str, int] = {}
                    for rec in gr["pending"].values():
                        per[rec[0]] = per.get(rec[0], 0) + 1
                out = [f"*{len(per)}\n"]
                out += [f"{c} {n}\n" for c, n in sorted(per.items())]
                w.write("".join(out).encode())
            elif cmd == "XPENDING" and len(p) >= 3:
                with state.lock:
                    gr = state.group(state.stream(p[1]), p[2])
                    n = len(gr["pending"])
                w.write(f":{n}\n".encode())
            elif cmd == "XSHED" and len(p) >= 4:
                # XSHED <stream> <lane> <0|1>: set/clear a lane's shed
                # flag (admission control valve, written by the engine)
                with state.lock:
                    lanes_shed = state.shed.setdefault(p[1], set())
                    if p[3] == "0":
                        lanes_shed.discard(p[2])
                    else:
                        lanes_shed.add(p[2])
                w.write(b"+OK\n")
            elif cmd == "XSHED" and len(p) >= 2:
                # XSHED <stream>: query — multi-line list of shedding lanes
                with state.lock:
                    names = sorted(state.shed.get(p[1], ()))
                w.write(("".join([f"*{len(names)}\n"] +
                                 [ln + "\n" for ln in names])).encode())
            elif cmd == "HSET" and len(p) >= 4:
                with state.cv:
                    # bounded amortized cleanup (full scan would be O(live
                    # fields) per write under a slow consumer)
                    state.evict_some(p[1])
                    state.hashes.setdefault(p[1], {})[p[2]] = p[3]
                    if state.hash_ttl_ms > 0:
                        ht = state.hash_times.setdefault(p[1], {})
                        # move-to-end on rewrite: evict_some's head scan
                        # relies on dict order == write order, but a plain
                        # assignment keeps a rewritten key at its ORIGINAL
                        # position, where its fresh timestamp would block
                        # eviction of everything behind it forever
                        ht.pop(p[2], None)
                        ht[p[2]] = time.monotonic() * 1000
                    state.cv.notify_all()
                w.write(b"+OK\n")
            elif cmd == "HGET" and len(p) >= 3:
                with state.lock:
                    if state.field_expired(p[1], p[2]):
                        val = None
                    else:
                        val = state.hashes.get(p[1], {}).get(p[2])
                w.write(f"${val}\n".encode() if val is not None else b"$-1\n")
            elif cmd == "HKEYS" and len(p) >= 2:
                with state.lock:
                    state.evict_expired(p[1])
                    keys = list(state.hashes.get(p[1], {}).keys())
                w.write(("".join([f"*{len(keys)}\n"] +
                                 [k + "\n" for k in keys])).encode())
            elif cmd == "HDEL" and len(p) >= 3:
                with state.lock:
                    n = 1 if state.hashes.get(p[1], {}).pop(p[2], None) \
                        is not None else 0
                    state.hash_times.get(p[1], {}).pop(p[2], None)
                w.write(f":{n}\n".encode())
            elif cmd == "DEL" and len(p) >= 2:
                with state.lock:
                    state.streams.pop(p[1], None)
                    state.shed.pop(p[1], None)
                    state.hashes.pop(p[1], None)
                    state.hash_times.pop(p[1], None)
                w.write(b"+OK\n")
            else:
                w.write(b"-ERR unknown command\n")
            w.flush()


class _PyBrokerServer(socketserver.ThreadingTCPServer):
    allow_reuse_address = True
    daemon_threads = True

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self._conns = set()
        self._conns_lock = threading.Lock()

    def process_request(self, request, client_address):
        with self._conns_lock:
            self._conns.add(request)
        super().process_request(request, client_address)

    def shutdown_request(self, request):
        with self._conns_lock:
            self._conns.discard(request)
        super().shutdown_request(request)

    def close_all_connections(self):
        """Sever live client sockets so clients observe the broker's death
        (the native broker gets this for free when its process exits)."""
        with self._conns_lock:
            for s in self._conns:
                try:
                    s.shutdown(socket.SHUT_RDWR)
                except OSError:
                    pass
                try:
                    s.close()
                except OSError:
                    pass
            self._conns.clear()


class Broker:
    """Owns a broker process (native) or thread (Python).

    ``Broker.launch()`` prefers the native binary; ``backend="python"``
    forces the in-process broker, ``backend="native"`` the binary (it
    raises when the build fails). ``backend`` says which one runs."""

    def __init__(self, port: int, proc=None, server=None,
                 sweep_stop: Optional[threading.Event] = None):
        self.port = port
        self._proc = proc
        self._server = server
        self._sweep_stop = sweep_stop

    @property
    def backend(self) -> str:
        return "native" if self._proc is not None else "python"

    @classmethod
    def launch(cls, port: int = 0, backend: str = "auto",
               hash_ttl_ms: int = 600_000) -> "Broker":
        """Start a broker on ``127.0.0.1:port`` (0 picks a free port).
        ``hash_ttl_ms``: result-hash fields a client never collects expire
        after this long, bounding the broker's memory (0 disables)."""
        if backend not in ("auto", "native", "python"):
            raise ValueError(f"backend must be auto|native|python, got "
                             f"{backend!r}")
        if port == 0:
            s = socket.socket()
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
            s.close()
        if backend in ("auto", "native"):
            try:
                return cls._launch_native(port, hash_ttl_ms)
            except RuntimeError as e:
                if backend == "native":
                    raise
                logger.warning("%s; falling back to the Python broker", e)
        server = _PyBrokerServer(("127.0.0.1", port), _PyHandler)
        state = _PyState(hash_ttl_ms)
        server.state = state  # type: ignore[attr-defined]
        # serve_forever's default 0.5s poll would make every stop() wait
        threading.Thread(target=server.serve_forever,
                         kwargs={"poll_interval": 0.02},
                         daemon=True).start()
        stop = threading.Event()
        if hash_ttl_ms > 0:
            # the native broker's sweeper analog: abandoned keys expire
            # even if never touched again
            def sweeper():
                while not stop.wait(max(hash_ttl_ms / 4000.0, 0.05)):
                    state.sweep()

            threading.Thread(target=sweeper, daemon=True).start()
        return cls(port, server=server, sweep_stop=stop)

    @classmethod
    def _launch_native(cls, port: int, hash_ttl_ms: int) -> "Broker":
        binary = build_native_broker()
        proc = subprocess.Popen(
            [str(binary), str(port), str(int(hash_ttl_ms))],
            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
        line = proc.stdout.readline()
        if line.startswith("READY"):
            return cls(port, proc=proc)
        proc.kill()
        proc.wait(timeout=5)
        raise RuntimeError(f"native broker did not start on port {port} "
                           f"(said {line.strip()!r})")

    def client(self, timeout: float = 30.0) -> BrokerClient:
        return BrokerClient(port=self.port, timeout=timeout)

    def stop(self):
        if self._proc is not None:
            try:
                self.client(timeout=5.0).shutdown_broker()
                self._proc.wait(timeout=5)
            except Exception:
                self._proc.kill()
                self._proc.wait(timeout=5)
            if self._proc.stdout is not None:
                self._proc.stdout.close()
            self._proc = None
        if self._server is not None:
            if self._sweep_stop is not None:
                self._sweep_stop.set()
            self._server.shutdown()
            self._server.close_all_connections()
            self._server.server_close()
            self._server = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.stop()
