"""HTTP frontend — a synchronous predict endpoint over the serving plane.

The port's own copy of ``analytics_zoo_tpu/serving/frontend.py`` (ref
zoo/.../serving/http/FrontEndApp.scala:41,362: POST a payload, the handler
enqueues it and awaits the result). Endpoints:

- ``POST /predict``  body = JSON ``{"inputs": {name: {dtype, shape, data}}}``
  (schema.py tensor encoding) → ``{"uri", "result": tensor}``. Optional
  ``"priority"`` routes the record onto a broker lane and ``"deadline_ms"``
  bounds its staleness: a shed lane answers 429 at once (``code:
  "shed"``), an expired deadline 504 with ``code: "expired"``, empty or
  malformed inputs 400. Optional ``"generate"`` (``{"max_new_tokens",
  "mode", "temperature", "seed"}``) makes it a generate request (the
  inputs then carry the encoder tensor and a ``start`` tensor).
- ``GET  /metrics``  → the engine's ``metrics()`` JSON by default; the
  Prometheus 0.0.4 text of the process-wide registry when the request
  asks for it (``Accept:`` holding ``text/plain`` or ``openmetrics``, or
  ``?format=prometheus``); ``?format=snapshot`` the mergeable registry
  snapshot. ``?scope=fleet`` federates: the live replicas of the fleet
  registry (common/fleet.py) are scraped and merged
  (``MetricsRegistry.merge_snapshot``) with this process's snapshot, in
  either format; a peer that cannot be scraped counts
  ``zoo_fleet_scrape_errors_total{replica}`` and the answer degrades to
  ``partial``.
- ``GET  /healthz``  → readiness JSON: broker reachability, queue depth
  (in all and per lane), the group's backlog, the shed lanes, the
  engine's admission state, the fleet (live and stale replicas, pending
  entries per replica, orphans), SLO burn rates, the decode occupancy and
  the device backend (``profiling.backend_state``). 503 when the broker
  is unreachable, when the depth passes ``max_backlog``, or when the SLO
  monitor sheds (every window burning past ``ZOO_SLO_SHED_BURN``);
  ``degraded`` when the backend probe reads wedged.
- ``GET  /slo``      → the SLO monitor's report with the lane state.
- ``GET  /metrics/history`` → the retained time-series rings
  (common/timeseries.py); ``?name=`` filters, ``?window=`` bounds the
  age, ``?format=windows`` renders snapshot-shaped windowed deltas
  (``?windows=60,300``); ``?scope=fleet`` merges every live replica's
  windowed deltas the same way.
- ``GET  /query``    → one windowed aggregate, e.g.
  ``?name=zoo_serving_latency_seconds&window=60&agg=p99`` (other
  parameters filter labels, e.g. ``&priority=batch``).
- ``GET  /trace``    → the span store as Chrome Trace Event JSON
  (``profiling.chrome_trace``); ``?uri=`` (or ``?trace_id=``) one record.
- ``GET  /``         → liveness.

With an engine, requests ride the engine's stream and result hash (the
JAX frontend always takes the default stream), and the frontend tells
the engine its port (``set_advertise``) so peers can scrape it. stdlib
``ThreadingHTTPServer``; each request thread owns its broker clients.
"""

from __future__ import annotations

import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from analytics_zoo_tpu_torch.common import fleet, profiling, slo, \
    telemetry, timeseries
from analytics_zoo_tpu_torch.serving import schema
from analytics_zoo_tpu_torch.serving.broker import BrokerClient, ShedError
from analytics_zoo_tpu_torch.serving.client import (INPUT_STREAM,
                                                    RESULT_HASH, InputQueue,
                                                    OutputQueue)

PROMETHEUS_CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"

#: the result poll's period: a request waits on average half of it past
#: its result's flush (the JAX frontend polls every 10 ms)
RESULT_POLL_S = 0.002

#: per-peer timeout of a ``?scope=fleet`` scrape: one dead replica
#: delays the federated answer, never wedges it
FLEET_SCRAPE_TIMEOUT_S = 2.0


def _federate(broker_host: str, broker_port: int, own_replica_id, local,
              peer_path: str, merge, timeout_s: float):
    """Fold every live peer's ``peer_path`` answer into ``local`` with
    ``merge``; a peer with no advertised port, an HTTP error or an
    unmergeable answer lands in ``failed`` and counts a scrape error."""
    import urllib.request
    live, stale = fleet.ReplicaRegistry(broker_host,
                                        broker_port).partition()
    errs = telemetry.get_registry().counter(
        "zoo_fleet_scrape_errors_total",
        "Replica snapshot scrapes that failed during fleet federation",
        ("replica",))
    merged, scraped, failed = local, [], []
    for r in live:
        if own_replica_id is not None and r.replica_id == own_replica_id:
            scraped.append(r.replica_id)   # self = the local view
            continue
        try:
            if r.port <= 0:
                raise ValueError("replica advertises no scrape port")
            with urllib.request.urlopen(
                    f"http://{r.host}:{r.port}{peer_path}",
                    timeout=timeout_s) as resp:
                peer = json.loads(resp.read())
            merged = merge(merged, peer)
            scraped.append(r.replica_id)
        except Exception:
            errs.labels(r.replica_id).inc()
            failed.append(r.replica_id)
    return merged, {"scraped": scraped, "failed": failed,
                    "stale": [r.replica_id for r in stale]}


def scrape_fleet(broker_host: str, broker_port: int,
                 own_replica_id: Optional[str] = None,
                 timeout_s: float = FLEET_SCRAPE_TIMEOUT_S):
    """Merge the local registry snapshot with every live replica's
    ``/metrics?format=snapshot``. Returns ``(merged, meta)``, meta listing
    the scraped, failed and stale replica ids. Raises the broker's
    ``ConnectionError`` / ``OSError`` only when the registry itself is
    unreachable."""
    return _federate(broker_host, broker_port, own_replica_id,
                     telemetry.snapshot(), "/metrics?format=snapshot",
                     telemetry.MetricsRegistry.merge_snapshot, timeout_s)


def scrape_fleet_history(broker_host: str, broker_port: int,
                         own_replica_id: Optional[str] = None,
                         windows=timeseries.DEFAULT_WINDOWS_S,
                         timeout_s: float = FLEET_SCRAPE_TIMEOUT_S):
    """Merge the local store's windowed deltas with every live replica's
    ``/metrics/history?format=windows``, window by window through the
    snapshot merge. A peer merges whole or not at all (a failed scrape);
    the local windows are never mutated (the merge copies)."""
    store = timeseries.get_store()
    store.tick_if_stale()
    wparam = ",".join(str(int(w)) for w in windows)

    def merge(merged, answer):
        peer = answer["windows"]
        return {wname: telemetry.MetricsRegistry.merge_snapshot(
                    snap_w, peer.get(wname, {}))
                for wname, snap_w in merged.items()}

    return _federate(broker_host, broker_port, own_replica_id,
                     store.windows_delta(windows),
                     f"/metrics/history?format=windows&windows={wparam}",
                     merge, timeout_s)


class _Handler(BaseHTTPRequestHandler):
    def log_message(self, fmt, *args):  # quiet
        pass

    def _count(self, path: str, code: int):
        self.server.http_counter.labels(  # type: ignore[attr-defined]
            path, str(code)).inc()

    def _json(self, code: int, obj, path: str = ""):
        body = json.dumps(obj).encode()
        self._count(path or self.path, code)
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _text(self, code: int, text: str, content_type: str):
        body = text.encode("utf-8")
        self._count(self.path.split("?", 1)[0], code)
        self.send_response(code)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _qs(self) -> dict:
        from urllib.parse import parse_qs
        if "?" not in self.path:
            return {}
        return parse_qs(self.path.split("?", 1)[1])

    # ----------------------------------------------------------------- GET
    def _wants_prometheus(self) -> bool:
        if "format=prometheus" in self.path:
            return True
        if "format=snapshot" in self.path:
            return False
        accept = (self.headers.get("Accept") or "").lower()
        return "text/plain" in accept or "openmetrics" in accept

    def _metrics(self):
        if (self._qs().get("scope") or [""])[0] == "fleet":
            self._metrics_fleet()
            return
        if "format=snapshot" in self.path:
            self._json(200, telemetry.snapshot(), path="/metrics")
            return
        if self._wants_prometheus():
            self._text(200, telemetry.prometheus_text(),
                       PROMETHEUS_CONTENT_TYPE)
            return
        engine = self.server.engine  # type: ignore[attr-defined]
        self._json(200, engine.metrics() if engine else {},
                   path="/metrics")

    def _own_replica(self):
        engine = self.server.engine  # type: ignore[attr-defined]
        return engine.replica_id if engine is not None else None

    def _metrics_fleet(self):
        srv = self.server  # type: ignore[assignment]
        try:
            merged, meta = scrape_fleet(srv.broker_host, srv.broker_port,
                                        own_replica_id=self._own_replica())
        except (ConnectionError, OSError) as e:
            self._json(503, {"error": f"fleet registry unreachable: {e}"},
                       path="/metrics")
            return
        if self._wants_prometheus():
            # the fleet view speaks the same exposition as scope=self
            self._text(200, telemetry.MetricsRegistry.from_snapshot(
                merged).prometheus_text(), PROMETHEUS_CONTENT_TYPE)
            return
        self._json(200, {"scope": "fleet", "partial": bool(meta["failed"]),
                         "replicas": meta, "metrics": merged},
                   path="/metrics")

    def _history_fleet(self, windows):
        srv = self.server  # type: ignore[assignment]
        try:
            merged, meta = scrape_fleet_history(
                srv.broker_host, srv.broker_port,
                own_replica_id=self._own_replica(), windows=windows)
        except (ConnectionError, OSError) as e:
            self._json(503, {"error": f"fleet registry unreachable: {e}"},
                       path="/metrics/history")
            return
        self._json(200, {"scope": "fleet",
                         "partial": bool(meta["failed"]),
                         "replicas": meta, "windows": merged},
                   path="/metrics/history")

    def _history(self):
        q = self._qs()
        windows = timeseries.DEFAULT_WINDOWS_S
        if "windows" in q:
            try:
                windows = tuple(max(1.0, float(p))
                                for p in q["windows"][0].split(",") if p)
            except ValueError:
                self._json(400, {"error": "bad windows= parameter"},
                           path="/metrics/history")
                return
        if (q.get("scope") or [""])[0] == "fleet":
            self._history_fleet(windows)
            return
        store = timeseries.get_store()
        store.tick_if_stale()
        if (q.get("format") or [""])[0] == "windows":
            self._json(200, {"windows": store.windows_delta(windows)},
                       path="/metrics/history")
            return
        window = None
        if "window" in q:
            try:
                window = float(q["window"][0])
            except ValueError:
                self._json(400, {"error": "bad window= parameter"},
                           path="/metrics/history")
                return
        self._json(200, store.history(names=q.get("name") or None,
                                      window=window),
                   path="/metrics/history")

    #: /query params with reserved meaning — everything else filters labels
    QUERY_RESERVED = frozenset({"name", "window", "agg", "scope", "format",
                                "windows"})

    def _query(self):
        q = self._qs()
        name = (q.get("name") or [None])[0]
        if not name:
            self._json(400, {"error": "query needs name="}, path="/query")
            return
        store = timeseries.get_store()
        # the window's right edge must include traffic up to this request
        store.tick()
        try:
            out = store.query(
                name,
                labels={k: v[0] for k, v in q.items()
                        if k not in self.QUERY_RESERVED},
                window=float((q.get("window") or ["60"])[0]),
                agg=(q.get("agg") or [None])[0])
        except ValueError as e:
            self._json(400, {"error": str(e)}, path="/query")
            return
        self._json(200, out, path="/query")

    @staticmethod
    def _lane_state(client: BrokerClient, stream: str, engine) -> dict:
        """Per-lane scheduling state shared by /healthz and /slo: depth
        per lane, the broker's shed flags and the engine's admission
        mirrors."""
        out = {"lanes": {lane: client.xlen(stream, lane)
                         for lane in schema.PRIORITIES},
               "shed_lanes": client.xshed(stream)}
        if engine is not None:
            out["admission"] = {
                "shedding": bool(getattr(engine, "admission_shedding",
                                         False)),
                "records_expired": int(getattr(engine, "records_expired",
                                               0))}
        return out

    def _healthz(self):
        srv = self.server  # type: ignore[assignment]
        engine = srv.engine
        stream = engine.stream if engine else INPUT_STREAM
        group = engine.group if engine else "serving"
        out = {"status": "ok", "broker": "up",
               "queue_depth": 0, "backlog": 0,
               "engine": bool(engine and engine._thread is not None)}
        code = 200
        client = None
        try:
            client = BrokerClient(host=srv.broker_host,
                                  port=srv.broker_port, timeout=5.0)
            out["queue_depth"] = client.xlen(stream)
            out.update(self._lane_state(client, stream, engine))
            out["backlog"] = client.xpending(stream, group)
            out["pending_per_consumer"] = client.xpending_detail(stream,
                                                                 group)
        except (ConnectionError, OSError) as e:
            out.update(status="unavailable", broker=f"down: {e}")
            code = 503
        finally:
            if client is not None:
                client.close()
        if code == 200 and out["queue_depth"] > srv.max_backlog:
            out["status"] = "overloaded"
            out["reason"] = "backlog"
            code = 503
        if engine is not None:
            out["lease_reclaims"] = engine.lease_reclaims
            out["records_redelivered"] = engine.records_redelivered
        if out["broker"] == "up":
            out["fleet"] = self._fleet_state(srv, engine, stream, group)
        # burn-rate shedding: the measured overload signal trips 503 while
        # the raw backlog may still look fine
        mon = slo.get_monitor()
        mon.tick_if_stale()
        shedding = mon.overloaded()
        out["slo"] = {"burn_rates": mon.burn_rates(), "shedding": shedding}
        if code == 200 and shedding:
            out["status"] = "overloaded"
            out["reason"] = "slo-burn"
            code = 503
        # the device backend, from a probe joined with a timeout: a
        # wedged CUDA runtime can never hang /healthz
        out["backend"] = profiling.backend_state(timeout_s=2.0)
        if engine is not None and hasattr(engine, "decode_state"):
            try:
                out["decode"] = engine.decode_state()
            except Exception:
                pass
        if code == 200 and out["backend"].get("status") == "wedged":
            out["status"] = "degraded"
        self._json(code, out, path="/healthz")

    @staticmethod
    def _fleet_state(srv, engine, stream: str, group: str) -> dict:
        """Who is serving, by heartbeat age, read fresh from the registry
        (the supervisor's cached sweep can predate a replica that just
        joined), with the delivery state of the supervisor's last sweep
        (pending entries per replica, orphans) or, without one, the
        broker's pending entries per consumer."""
        try:
            live, stale = fleet.ReplicaRegistry(
                srv.broker_host, srv.broker_port).partition()
        except Exception:
            return {"replicas": 0, "stale": 0}
        out = {"replicas": len(live), "stale": len(stale)}
        rsup = getattr(engine, "_replica_supervisor", None)
        snap = rsup.snapshot() if rsup is not None else {}
        if snap:
            out.update(pending_per_replica=snap["pending_per_replica"],
                       orphan_entries=snap["orphan_entries"],
                       reclaim_sweeps=snap["sweeps"])
        else:
            try:
                client = BrokerClient(host=srv.broker_host,
                                      port=srv.broker_port, timeout=5.0)
                try:
                    out["pending_per_replica"] = client.xpending_detail(
                        stream, group)
                finally:
                    client.close()
            except Exception:
                pass
        if engine is not None:
            out["lease_reclaims"] = engine.lease_reclaims
            out["records_redelivered"] = engine.records_redelivered
        return out

    def _trace(self):
        """The span store as Chrome Trace Event JSON (Perfetto,
        chrome://tracing); ``?uri=`` / ``?trace_id=`` one record."""
        q = self._qs()
        trace_id = (q.get("uri") or q.get("trace_id") or [None])[0]
        self._json(200, profiling.chrome_trace(trace_id), path="/trace")

    def _slo(self):
        mon = slo.get_monitor()
        mon.tick_if_stale()
        rep = mon.report()
        srv = self.server  # type: ignore[assignment]
        stream = srv.engine.stream if srv.engine else INPUT_STREAM
        try:
            client = BrokerClient(host=srv.broker_host,
                                  port=srv.broker_port, timeout=5.0)
            try:
                rep.update(self._lane_state(client, stream, srv.engine))
            finally:
                client.close()
        except (ConnectionError, OSError):
            pass        # the burn report stands on its own
        self._json(200, rep, path="/slo")

    def do_GET(self):
        path = self.path.split("?", 1)[0]
        if path == "/metrics":
            self._metrics()
        elif path == "/healthz":
            self._healthz()
        elif path == "/trace":
            self._trace()
        elif path == "/metrics/history":
            self._history()
        elif path == "/query":
            self._query()
        elif path == "/slo":
            self._slo()
        else:
            self._json(200, {"status": "ok"}, path=path)

    # ---------------------------------------------------------------- POST
    def do_POST(self):
        srv = self.server  # type: ignore[assignment]
        if self.path != "/predict":
            self._json(404, {"error": "unknown path"})
            return
        tracer = telemetry.get_tracer()
        sampled = tracer.should_sample()
        t_req0 = time.perf_counter()
        in_q = out_q = None
        try:
            n = int(self.headers.get("Content-Length", 0))
            payload = json.loads(self.rfile.read(n))
            inputs = {k: schema.decode_tensor(v)
                      for k, v in payload["inputs"].items()}
            in_q = InputQueue(host=srv.broker_host,
                              port=srv.broker_port, cipher=srv.cipher,
                              stream=(srv.engine.stream if srv.engine
                                      else INPUT_STREAM))
            t_enq0 = time.perf_counter()
            uri = in_q.enqueue(payload.get("uri"),
                               priority=payload.get("priority"),
                               deadline_ms=payload.get("deadline_ms"),
                               generate=payload.get("generate"),
                               **inputs)
            t_enq1 = time.perf_counter()
        except ShedError as e:
            # admission control refused the lane at the broker: back off
            # now instead of polling into a timeout
            self._json(429, {"error": f"lane shedding: {e}",
                             "code": "shed"})
            return
        except (ValueError, KeyError, TypeError, AttributeError,
                json.JSONDecodeError) as e:
            self._json(400, {"error": f"bad request: {e}"})
            return
        finally:
            if in_q is not None:
                in_q.close()
        try:
            out_q = OutputQueue(host=srv.broker_host,
                                port=srv.broker_port, cipher=srv.cipher,
                                result_key=(srv.engine.result_key
                                            if srv.engine else RESULT_HASH))
            t_wait0 = time.perf_counter()
            result = out_q.query(uri, timeout=srv.timeout_s,
                                 poll_interval=RESULT_POLL_S, delete=True)
            t_wait1 = time.perf_counter()
        except schema.DeadlineExpiredError as e:
            # the engine declared the deadline lapsed (a typed result),
            # unlike the poll timeout below
            self._json(504, {"uri": uri, "error": str(e),
                             "code": "expired"})
            return
        except schema.ServingError as e:
            self._json(422, {"uri": uri, "error": str(e)})
            return
        finally:
            if out_q is not None:
                out_q.close()
        if sampled:
            tracer.record(uri, "enqueue", t_enq0, t_enq1,
                          parent="http_predict")
            tracer.record(uri, "wait", t_wait0, t_wait1,
                          parent="http_predict")
            tracer.record(uri, "http_predict", t_req0, time.perf_counter())
        if result is None:
            self._json(504, {"uri": uri, "error": "timed out"})
        else:
            self._json(200, {"uri": uri,
                             "result": schema.encode_tensor(result)})


class FrontEnd:
    """``FrontEnd(broker_port, engine).start()`` serves HTTP on ``port``
    (0 picks a free one)."""

    def __init__(self, broker_port: int, engine=None, port: int = 0,
                 timeout: float = 30.0, cipher: schema.Cipher = None,
                 host: str = "127.0.0.1",
                 broker_host: str = "127.0.0.1",
                 max_backlog: int = 10000):
        self._httpd = ThreadingHTTPServer((host, port), _Handler)
        # request threads are daemons: a client holding a keep-alive
        # socket open must not keep the process alive
        self._httpd.daemon_threads = True
        self._httpd.broker_host = broker_host       # type: ignore[attr-defined]
        self._httpd.broker_port = broker_port       # type: ignore[attr-defined]
        self._httpd.engine = engine                 # type: ignore[attr-defined]
        self._httpd.timeout_s = timeout             # type: ignore[attr-defined]
        self._httpd.cipher = cipher                 # type: ignore[attr-defined]
        # /healthz answers 503 "overloaded" past this input-queue depth
        self._httpd.max_backlog = int(max_backlog)  # type: ignore[attr-defined]
        self._httpd.http_counter = (                # type: ignore[attr-defined]
            telemetry.get_registry().counter(
                "zoo_http_requests_total", "Frontend HTTP requests",
                ("path", "code")))
        # BaseHTTPRequestHandler reads .timeout off the server for socket
        # timeouts; keep our own name distinct
        self._httpd.timeout = None                  # type: ignore[attr-defined]
        self.port = self._httpd.server_address[1]
        if engine is not None and hasattr(engine, "set_advertise"):
            # where the engine's heartbeat tells peers to scrape; a
            # wildcard bind advertises loopback (peers cannot dial 0.0.0.0)
            adv = "127.0.0.1" if host in ("", "0.0.0.0", "::") else host
            engine.set_advertise(adv, self.port)
        self._thread: Optional[threading.Thread] = None

    def start(self) -> "FrontEnd":
        # idempotent: a second serve_forever loop on the same socket would
        # race the first into an accept() that shutdown() cannot reach,
        # leaking the thread past stop()
        if self._thread is not None:
            return self
        # an engine-less frontend still needs the history sampler ticking
        timeseries.get_store().start()
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        kwargs={"poll_interval": 0.05},
                                        daemon=True, name="zoo-frontend")
        self._thread.start()
        return self

    def stop(self):
        """Stop serving and join the serve thread; idempotent."""
        t, self._thread = self._thread, None
        if t is not None:
            self._httpd.shutdown()
            t.join(timeout=5)
        self._httpd.server_close()

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()
