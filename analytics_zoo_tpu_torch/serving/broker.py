"""Broker — the serving data plane: a stream in, a hash out.

The port's own copy of ``analytics_zoo_tpu/serving/broker.py``, trimmed to
this slice: :class:`BrokerClient` and the pure-Python broker
(``Broker.launch(backend="python")``), an in-process threaded TCP server
speaking the same newline-delimited protocol as the JAX package's brokers
(a Redis-streams analog; payloads are opaque base64). The native C++
broker, priority lanes, lease reclaim (XCLAIM) and lane shedding (XSHED)
wait for later slices.

Commands: PING, XADD, XLEN, XREADGROUP (consumer groups with a
per-group cursor and a pending set), XACK, XPENDING, HSET, HGET, HKEYS,
HDEL. Result-hash fields nobody collects expire after
``hash_ttl_ms``, so the broker's memory stays bounded.
"""

from __future__ import annotations

import errno
import socket
import socketserver
import threading
import time
from typing import Dict, List, Optional


class BrokerClient:
    """One TCP connection to the broker. Not shared across threads: make
    one per thread (connects are cheap)."""

    # commands safe to resend after a transient socket error: pure reads
    # plus XACK (a double ack is a no-op). XADD/HSET/HDEL are not:
    # resending them after an ambiguous failure could duplicate a record
    # or clobber a newer write.
    _IDEMPOTENT = frozenset({"PING", "XLEN", "XREADGROUP", "XPENDING",
                             "XACK", "HGET", "HKEYS"})
    RECONNECT_TRIES = 3
    RECONNECT_BACKOFF_S = 0.05
    # writes are chunked so the broker can drain its send buffer between
    # chunks — one giant sendall can deadlock both peers once the replies
    # fill the kernel buffers while the client is still writing
    PIPELINE_CHUNK = 512

    def __init__(self, host: str = "127.0.0.1", port: int = 6399,
                 timeout: float = 30.0):
        self.addr = (host, port)
        self._timeout = timeout
        self.sock = self._connect()
        self._buf = b""

    def _connect(self) -> socket.socket:
        sock = socket.create_connection(self.addr, timeout=self._timeout)
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        return sock

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
            err = RuntimeError(f"broker error: {rest}")
            if raise_on_error:
                raise err
            return err
        raise RuntimeError(f"bad reply line: {line!r}")

    @staticmethod
    def _transient(e: BaseException) -> bool:
        """Reset/broken-pipe errors, or a clean peer close, are worth one
        transparent retry; timeouts are not (the command may still run)."""
        if isinstance(e, (socket.timeout, TimeoutError)):
            return False
        if isinstance(e, ConnectionError):
            return True
        return getattr(e, "errno", None) in (errno.ECONNRESET, errno.EPIPE)

    def _reconnect(self):
        """Redial with bounded exponential backoff."""
        try:
            self.sock.close()
        except OSError:
            pass
        self._buf = b""
        delay = self.RECONNECT_BACKOFF_S
        last: Optional[BaseException] = None
        for _ in range(self.RECONNECT_TRIES):
            try:
                self.sock = self._connect()
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
        except OSError as e:
            if parts[0] not in self._IDEMPOTENT or not self._transient(e):
                raise
            # reconnect once, resend once
            self._reconnect()
            self._send(*parts)
            return self._reply()

    def pipeline(self, cmds) -> list:
        """Send commands in chunked batches, reading each chunk's replies
        before the next write. ``cmds`` is an iterable of argument tuples.
        All replies are read before an error is raised, so the connection
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

    def xadd(self, stream: str, payload_b64: str) -> int:
        return int(self._cmd("XADD", stream, payload_b64))

    def xlen(self, stream: str) -> int:
        return self._cmd("XLEN", stream)

    def xreadgroup(self, group: str, consumer: str, stream: str,
                   count: int, block_ms: int = 0) -> List[tuple]:
        """Up to ``count`` new entries for the group as ``(id, payload)``,
        waiting up to ``block_ms`` when none is there."""
        old = self.sock.gettimeout()
        if block_ms:
            self.sock.settimeout(max(old or 0, block_ms / 1000.0 + 10))
        try:
            lines = self._cmd("XREADGROUP", group, consumer, stream,
                              str(count), str(block_ms))
        finally:
            self.sock.settimeout(old)
        out: List[tuple] = []
        for ln in lines:
            i, payload = ln.split(" ", 1)
            out.append((int(i), payload))
        return out

    def xack(self, stream: str, group: str, entry_id: int) -> int:
        return self._cmd("XACK", stream, group, str(entry_id))

    def xpending(self, stream: str, group: str) -> int:
        return self._cmd("XPENDING", stream, group)

    def hset(self, key: str, field: str, value_b64: str):
        return self._cmd("HSET", key, field, value_b64)

    def hget(self, key: str, field: str) -> Optional[str]:
        return self._cmd("HGET", key, field)

    def hkeys(self, key: str) -> List[str]:
        return self._cmd("HKEYS", key)

    def hdel(self, key: str, field: str) -> int:
        return self._cmd("HDEL", key, field)

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
        # stream -> {"entries": [(id, payload)], "next_id", "groups"}
        self.streams: Dict[str, dict] = {}
        self.hashes: Dict[str, Dict[str, str]] = {}
        # last-write monotonic ms per hash field, for the TTL
        self.hash_times: Dict[str, Dict[str, float]] = {}
        self.hash_ttl_ms = int(hash_ttl_ms)

    def stream(self, name):
        return self.streams.setdefault(
            name, {"entries": [], "next_id": 1, "groups": {}})

    @staticmethod
    def group(st, name):
        # cursor: last-delivered id; pending: delivered, unacked ids
        return st["groups"].setdefault(name, {"cursor": 0, "pending": set()})

    def expired(self, key: str, field: str, now_ms: float) -> bool:
        t = self.hash_times.get(key, {}).get(field)
        return (self.hash_ttl_ms > 0 and t is not None
                and now_ms - t >= self.hash_ttl_ms)

    def drop_field(self, key: str, field: str) -> bool:
        """Delete one hash field. Caller holds the lock."""
        self.hash_times.get(key, {}).pop(field, None)
        found = self.hashes.get(key, {}).pop(field, None) is not None
        if not self.hashes.get(key):
            self.hashes.pop(key, None)
            self.hash_times.pop(key, None)
        return found

    def sweep(self):
        """Drop every expired hash field."""
        now_ms = time.monotonic() * 1000
        with self.lock:
            for key in list(self.hash_times):
                for field in [f for f in self.hash_times[key]
                              if self.expired(key, f, now_ms)]:
                    self.drop_field(key, field)


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
            reply = self._execute(state, line.split(" "))
            self.wfile.write(reply.encode())
            self.wfile.flush()

    @staticmethod
    def _execute(state: _PyState, p: List[str]) -> str:
        """The reply to one command line."""
        cmd = p[0]
        if cmd == "PING":
            return "+PONG\n"
        if cmd == "XADD" and len(p) >= 3:
            # a trailing lane argument (the JAX client's) is accepted and
            # ignored: this broker has one lane
            with state.cv:
                st = state.stream(p[1])
                eid = st["next_id"]
                st["next_id"] += 1
                st["entries"].append((eid, p[2]))
                state.cv.notify_all()
            return f"+{eid}\n"
        if cmd == "XLEN" and len(p) >= 2:
            with state.lock:
                return f":{len(state.stream(p[1])['entries'])}\n"
        if cmd == "XREADGROUP" and len(p) >= 6:
            group, consumer, stream = p[1], p[2], p[3]
            count, block_ms = int(p[4]), int(p[5])

            def deliver():
                st = state.stream(stream)
                gr = state.group(st, group)
                got = [(eid, payload) for eid, payload in st["entries"]
                       if eid > gr["cursor"]][:count]
                if got:
                    gr["cursor"] = got[-1][0]
                    gr["pending"].update(eid for eid, _ in got)
                return got

            with state.cv:
                got = deliver()
                deadline = time.monotonic() + block_ms / 1000.0
                while not got and block_ms > 0:
                    left = deadline - time.monotonic()
                    if left <= 0:
                        break
                    state.cv.wait(left)
                    got = deliver()
            return "".join([f"*{len(got)}\n"]
                           + [f"{eid} {payload}\n" for eid, payload in got])
        if cmd == "XACK" and len(p) >= 4:
            with state.lock:
                st = state.stream(p[1])
                gr = state.group(st, p[2])
                eid = int(p[3])
                n = 1 if eid in gr["pending"] else 0
                gr["pending"].discard(eid)
                # drop the prefix of entries every group has read and acked
                groups = st["groups"].values()
                entries = st["entries"]
                drop = 0
                while drop < len(entries) and all(
                        g["cursor"] >= entries[drop][0]
                        and entries[drop][0] not in g["pending"]
                        for g in groups):
                    drop += 1
                if drop:
                    st["entries"] = entries[drop:]
            return f":{n}\n"
        if cmd == "XPENDING" and len(p) >= 3:
            with state.lock:
                gr = state.group(state.stream(p[1]), p[2])
                return f":{len(gr['pending'])}\n"
        if cmd == "HSET" and len(p) >= 4:
            with state.lock:
                state.hashes.setdefault(p[1], {})[p[2]] = p[3]
                state.hash_times.setdefault(p[1], {})[p[2]] = \
                    time.monotonic() * 1000
            return "+OK\n"
        if cmd == "HGET" and len(p) >= 3:
            with state.lock:
                if state.expired(p[1], p[2], time.monotonic() * 1000):
                    state.drop_field(p[1], p[2])
                val = state.hashes.get(p[1], {}).get(p[2])
            return f"${val}\n" if val is not None else "$-1\n"
        if cmd == "HKEYS" and len(p) >= 2:
            with state.lock:
                keys = list(state.hashes.get(p[1], {}))
            return "".join([f"*{len(keys)}\n"] + [k + "\n" for k in keys])
        if cmd == "HDEL" and len(p) >= 3:
            with state.lock:
                return f":{int(state.drop_field(p[1], p[2]))}\n"
        return "-ERR unknown command\n"


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
        """Sever live client sockets so clients observe the broker's
        death."""
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
    """Owns an in-process Python broker (server thread + TTL sweeper)."""

    def __init__(self, port: int, server: _PyBrokerServer,
                 sweep_stop: threading.Event):
        self.port = port
        self._server: Optional[_PyBrokerServer] = server
        self._sweep_stop = sweep_stop

    @classmethod
    def launch(cls, port: int = 0, backend: str = "python",
               hash_ttl_ms: int = 600_000) -> "Broker":
        """Start a broker on ``127.0.0.1:port`` (0 picks a free port).
        ``hash_ttl_ms``: result-hash fields a client never collects expire
        after this long (0 disables)."""
        if backend != "python":
            raise ValueError(f"broker backend {backend!r} is not ported; "
                             "use backend='python'")
        server = _PyBrokerServer(("127.0.0.1", int(port)), _PyHandler)
        state = _PyState(hash_ttl_ms)
        server.state = state  # type: ignore[attr-defined]
        # serve_forever's default 0.5s poll would make every stop() wait
        threading.Thread(target=server.serve_forever,
                         kwargs={"poll_interval": 0.02},
                         daemon=True).start()
        stop = threading.Event()
        if hash_ttl_ms > 0:
            def sweeper():
                while not stop.wait(max(hash_ttl_ms / 4000.0, 0.05)):
                    state.sweep()

            threading.Thread(target=sweeper, daemon=True).start()
        return cls(server.server_address[1], server, stop)

    def client(self, timeout: float = 30.0) -> BrokerClient:
        return BrokerClient(port=self.port, timeout=timeout)

    def stop(self):
        if self._server is not None:
            self._sweep_stop.set()
            self._server.shutdown()
            self._server.close_all_connections()
            self._server.server_close()
            self._server = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.stop()
