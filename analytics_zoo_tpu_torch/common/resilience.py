"""Deterministic fault injection: ``fit(auto_resume=True)`` and the
replica-kill drill.

Counterpart of the parts of ``analytics_zoo_tpu/common/resilience.py``
that the estimator's retry-from-snapshot and the serving fleet's chaos
drill use. A fault plan
(``ZOO_FAULT_PLAN``, or :func:`install_plan`) is a comma-separated list of
``kind@site[:start[+more]]`` specs:

- ``wedge@step:12``  — the 12th training step raises
- ``wedge@step:5+2`` — steps 5 to 7 raise (start plus 2 more)
- ``wedge@step``     — every step raises
- ``kill@replica:1`` — the first :func:`maybe_kill_replica` SIGKILLs its
  replica

Sites count their arrivals per process, so a plan strikes the same call
every run. :func:`is_backend_loss` tells a lost device from a model or
data bug, and ``ZOO_FIT_MAX_RESUMES`` bounds the resumes.
:class:`ServingReplicaProc` runs one serving replica (engine and
frontend over a shared broker, the :class:`Duck` model) in its own
process, the unit the replica-kill seam strikes.

:class:`BackendSupervisor` is JAX's health state machine (ok -> suspect
-> wedged -> recovering -> ok) over ``common/profiling.backend_state``'s
``torch.cuda`` probe, with the ``zoo_backend_state`` gauge, the
``zoo_backend_failovers_total`` counter and one flight-recorder dump an
episode (trigger ``backend-wedged-<episode>``). It only reports: the port
has no CPU failover, so nothing reroutes when it reads wedged
(``ZOO_CPU_FALLBACK=1`` still makes ``ClusterServing`` raise).
"""

from __future__ import annotations

import logging
import os
import re
import signal
import subprocess
import sys
import threading
import time
from contextlib import contextmanager
from typing import Any, Callable, Dict, List, Optional

import numpy as np

__all__ = ["InjectedFault", "FaultInjector", "get_injector", "install_plan",
           "maybe_fault", "fault_scope", "fault_drill", "Duck",
           "ServingReplicaProc", "maybe_kill_replica", "is_backend_loss",
           "fit_max_resumes", "note_backend_loss", "reset_for_tests",
           "fault_plan_active",
           "BackendSupervisor", "get_supervisor", "supervisor_snapshot"]

logger = logging.getLogger(__name__)

#: ``kind@site[:start[+more]]``
_SPEC_RE = re.compile(
    r"^(?P<kind>[a-z][a-z0-9_-]*)@(?P<site>[a-z][a-z0-9_-]*)"
    r"(?::(?P<start>\d+)(?:\+(?P<more>\d+))?)?$")

#: exception class names that read as "the device is gone" (torch raises
#: these for CUDA errors), and message markers
_BACKEND_LOSS_TYPES = frozenset({"AcceleratorError", "OutOfMemoryError"})
_BACKEND_LOSS_MARKERS = ("device lost", "backend wedged", "cuda error",
                         "out of memory")


class InjectedFault(RuntimeError):
    """A fault raised by the injector; says which planned fault struck."""

    def __init__(self, kind: str, site: str, index: int):
        super().__init__(
            f"injected {kind} at {site} call #{index} (ZOO_FAULT_PLAN)")
        self.kind = kind
        self.site = site
        self.index = index


class _FaultSpec:
    __slots__ = ("kind", "site", "start", "stop")

    def __init__(self, kind: str, site: str, start: Optional[int],
                 more: int):
        self.kind = kind
        self.site = site
        self.start = start                    # None = every call
        self.stop = None if start is None else start + more

    def hits(self, index: int) -> bool:
        return self.start is None or self.start <= index <= self.stop


class FaultInjector:
    """A fault plan with one arrival counter per site; a spec fires on
    exact arrival indices (1-based)."""

    def __init__(self, plan: str):
        self.plan = plan
        self._specs: List[_FaultSpec] = []
        self._counts: Dict[str, int] = {}
        self._lock = threading.Lock()
        for raw in plan.split(","):
            raw = raw.strip()
            if not raw:
                continue
            m = _SPEC_RE.match(raw)
            if m is None:
                raise ValueError(
                    f"bad ZOO_FAULT_PLAN spec {raw!r}: expected "
                    "kind@site[:start[+more]], e.g. wedge@step:3+2")
            start = m.group("start")
            self._specs.append(_FaultSpec(
                m.group("kind"), m.group("site"),
                None if start is None else int(start),
                int(m.group("more") or 0)))

    def check(self, site: str) -> Optional[InjectedFault]:
        """Count one arrival at ``site``; its planned fault, or None."""
        with self._lock:
            n = self._counts.get(site, 0) + 1
            self._counts[site] = n
        for spec in self._specs:
            if spec.site == site and spec.hits(n):
                return InjectedFault(spec.kind, site, n)
        return None

    def counts(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._counts)


_INJ_LOCK = threading.Lock()
_INJECTOR: Optional[FaultInjector] = None
_INJ_LOADED = False
# nested-seam suppression: only the outermost arrival at a site counts
_TLS = threading.local()


def get_injector() -> Optional[FaultInjector]:
    """The process's injector, built from ``ZOO_FAULT_PLAN`` on first
    use (a malformed plan is logged and ignored)."""
    global _INJECTOR, _INJ_LOADED
    if _INJ_LOADED:
        return _INJECTOR
    with _INJ_LOCK:
        if not _INJ_LOADED:
            plan = os.environ.get("ZOO_FAULT_PLAN", "").strip()
            if plan:
                try:
                    _INJECTOR = FaultInjector(plan)
                    logger.warning("fault plan armed: %s", plan)
                except ValueError:
                    logger.exception("ignoring malformed ZOO_FAULT_PLAN")
            _INJ_LOADED = True
    return _INJECTOR


def install_plan(plan: Optional[str]) -> Optional[FaultInjector]:
    """Install a fault plan with fresh counters; None or "" clears it."""
    global _INJECTOR, _INJ_LOADED
    with _INJ_LOCK:
        _INJECTOR = FaultInjector(plan) if plan else None
        _INJ_LOADED = True
    return _INJECTOR


def fault_plan_active() -> bool:
    return get_injector() is not None


def _suppressed(site: str) -> bool:
    return site in getattr(_TLS, "suppress", ())


def maybe_fault(site: str) -> None:
    """The injection seam: count one arrival at ``site`` and raise its
    planned fault, if any. Without a plan: one attribute read."""
    inj = get_injector()
    if inj is None or _suppressed(site):
        return
    fault = inj.check(site)
    if fault is not None:
        raise fault


@contextmanager
def fault_scope(site: str):
    """``maybe_fault(site)`` that also suppresses nested arrivals at the
    same site while the block runs."""
    inj = get_injector()
    if inj is None or _suppressed(site):
        yield
        return
    fault = inj.check(site)
    if fault is not None:
        raise fault
    sup = getattr(_TLS, "suppress", None)
    if sup is None:
        sup = _TLS.suppress = set()
    sup.add(site)
    try:
        yield
    finally:
        sup.discard(site)


@contextmanager
def fault_drill(plan: str):
    """Install ``plan`` with fresh counters for the block, and clear it
    after."""
    install_plan(plan)
    try:
        yield
    finally:
        install_plan(None)


# ------------------------------------------------------- replica drill

class Duck:
    """A duck-typed doubler whose per-batch ``predict`` sleep models the
    device round trip, so replica drills measure the delivery layer
    without a device."""

    def __init__(self, sleep_s: float = 0.0):
        self.sleep_s = float(sleep_s)

    def predict(self, x):
        if self.sleep_s:
            time.sleep(self.sleep_s)
        return np.asarray(x) * 2.0


_REPLICA_SCRIPT = """\
import sys
from analytics_zoo_tpu_torch.common.resilience import Duck
from analytics_zoo_tpu_torch.serving.engine import ClusterServing
from analytics_zoo_tpu_torch.serving.frontend import FrontEnd

sleep_ms, port, batch = float(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3])
eng = ClusterServing(Duck(sleep_ms / 1000.0), port, batch_size=batch,
                     max_batch_size=batch, warmup=False).start()
fe = FrontEnd(port, engine=eng).start()
print("READY", fe.port, eng.replica_id, flush=True)
sys.stdin.readline()
eng.stop()
fe.stop()
"""

#: the directory holding the package, for the replica's import path
_PKG_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


class ServingReplicaProc:
    """One serving replica in its own OS process (engine and frontend
    over a shared broker, the :class:`Duck` model on the host): the unit
    :func:`maybe_kill_replica` SIGKILLs. Lease and heartbeat knobs ride
    ``env_extra``."""

    def __init__(self, broker_port: int, batch_size: int = 4,
                 predict_sleep_ms: float = 0.0,
                 env_extra: Optional[Dict[str, str]] = None,
                 ready_timeout_s: float = 60.0):
        env = dict(os.environ)
        env["PYTHONPATH"] = os.pathsep.join(
            p for p in (_PKG_ROOT, env.get("PYTHONPATH")) if p)
        env.update(env_extra or {})
        self.proc = subprocess.Popen(
            [sys.executable, "-c", _REPLICA_SCRIPT,
             str(predict_sleep_ms), str(broker_port), str(batch_size)],
            stdin=subprocess.PIPE, stdout=subprocess.PIPE,
            stderr=subprocess.DEVNULL, text=True, env=env)
        self._ready_line = ""
        t = threading.Thread(target=self._read_ready, daemon=True)
        t.start()
        t.join(ready_timeout_s)
        parts = self._ready_line.split()
        if len(parts) != 3 or parts[0] != "READY":
            self.kill()
            raise RuntimeError("serving replica failed to come up (got "
                               f"{self._ready_line!r})")
        self.http_port = int(parts[1])
        self.replica_id = parts[2]

    def _read_ready(self):
        self._ready_line = self.proc.stdout.readline()

    @property
    def alive(self) -> bool:
        return self.proc.poll() is None

    def kill(self):
        """SIGKILL — the crash path: no drain, no deregister; the
        replica's pending entries become orphaned leases."""
        if self.proc.poll() is None:
            os.kill(self.proc.pid, signal.SIGKILL)
        self.proc.wait()

    def stop(self, timeout_s: float = 30.0):
        """The graceful path: closing stdin lets the replica drain (stop
        reading, flush, ack, deregister)."""
        if self.proc.poll() is None:
            try:
                self.proc.stdin.close()
            except OSError:
                pass
            try:
                self.proc.wait(timeout=timeout_s)
            except subprocess.TimeoutExpired:
                self.kill()
        else:
            self.proc.wait()


def maybe_kill_replica(replica: ServingReplicaProc) -> bool:
    """The replica-kill fault seam: count one arrival at site
    ``replica``; when the plan schedules a ``kill`` for it
    (``kill@replica:N``), SIGKILL the subprocess and return True."""
    inj = get_injector()
    if inj is None or _suppressed("replica"):
        return False
    fault = inj.check("replica")
    if fault is None or fault.kind != "kill":
        return False
    logger.warning("injected replica kill: SIGKILL pid %d (%s)",
                   replica.proc.pid, getattr(replica, "replica_id", "?"))
    replica.kill()
    return True


def is_backend_loss(err: Optional[BaseException]) -> bool:
    """Does ``err`` read as a lost device (not a model or data bug)?
    Injected faults always do."""
    if err is None:
        return False
    if isinstance(err, InjectedFault):
        return True
    if type(err).__name__ in _BACKEND_LOSS_TYPES:
        return True
    msg = str(err).lower()
    return any(mark in msg for mark in _BACKEND_LOSS_MARKERS)


def fit_max_resumes(default: int) -> int:
    """``ZOO_FIT_MAX_RESUMES`` bounds ``fit(auto_resume=True)``'s resumes
    (default: the estimator's ``failure_retry_times``)."""
    raw = os.environ.get("ZOO_FIT_MAX_RESUMES", "").strip()
    try:
        return int(raw) if raw else int(default)
    except ValueError:
        return int(default)


# ------------------------------------------------------------ supervisor

class BackendSupervisor:
    """Health state machine over the backend probe (JAX's, letter for
    letter but for the probe).

    ``ok -> suspect`` on the first failed probe (or external failure
    evidence via :meth:`report_failure`); ``suspect -> wedged`` on the
    confirming failure; ``wedged -> recovering`` on the first healthy
    probe; ``recovering -> ok`` after ``recover_probes`` consecutive
    healthy probes (``recovering -> wedged`` again on a relapse, same
    episode, no second dump). While unhealthy the re-probe interval backs
    off exponentially from ``interval_s`` to ``backoff_max_s``.

    Every transition into ``wedged`` bumps ``zoo_backend_failovers_total``
    (JAX's name; here no failover follows) and writes one flight-recorder
    postmortem through the ``dump_once`` latch (trigger
    ``backend-wedged-<episode>``); the current state rides the
    ``zoo_backend_state`` gauge as a numeric code. The default probe is
    ``profiling.backend_state`` (``torch.cuda``, joined with a timeout).
    """

    OK, SUSPECT, WEDGED, RECOVERING = "ok", "suspect", "wedged", "recovering"
    #: gauge encoding: dashboards alert on ``zoo_backend_state >= 2``
    STATE_CODES = {OK: 0, SUSPECT: 1, WEDGED: 2, RECOVERING: 3}

    def __init__(self, probe: Optional[Callable[[], dict]] = None,
                 interval_s: float = 0.2, backoff_max_s: float = 2.0,
                 probe_timeout_s: float = 2.0, recover_probes: int = 2,
                 registry=None):
        from analytics_zoo_tpu_torch.common import telemetry
        self._probe = probe or (lambda: _default_probe(probe_timeout_s))
        self.interval_s = float(interval_s)
        self.backoff_max_s = float(backoff_max_s)
        self.recover_probes = max(1, int(recover_probes))
        self._lock = threading.Lock()
        self.state = self.OK
        self.episodes = 0            # transitions into wedged
        self.last_probe: dict = {}
        self._ok_streak = 0
        self._stop = threading.Event()
        self._wake = threading.Event()
        self._thread: Optional[threading.Thread] = None
        reg = registry if registry is not None else telemetry.get_registry()
        self._g_state = reg.gauge(
            "zoo_backend_state",
            "Backend supervisor state: 0 ok, 1 suspect, 2 wedged, "
            "3 recovering")
        self._c_failovers = reg.counter(
            "zoo_backend_failovers_total",
            "Supervisor transitions into the wedged state")
        self._g_state.set(0)

    def probe_once(self) -> dict:
        """One supervised probe: run it, feed the state machine, return
        the raw probe dict."""
        try:
            st = self._probe()
        except Exception as e:   # a probe that raises is failure evidence
            st = {"status": "error", "error": repr(e)[:200]}
        self._observe(st)
        return st

    def report_failure(self, err: Any = None) -> None:
        """External failure evidence (a dispatch died with backend loss):
        advances the machine one failure step and wakes the re-probe loop
        so confirmation does not wait out a full healthy interval."""
        self._observe({"status": "error",
                       "error": repr(err)[:200] if err else "reported"})
        self._wake.set()

    def force_wedged(self, reason: str = "") -> None:
        """Drive straight to wedged (evidence already conclusive)."""
        self._observe({"status": "error", "error": reason or "forced"})
        self._observe({"status": "wedged", "error": reason or "forced"})

    def _observe(self, st: dict) -> None:
        healthy = st.get("status") == "ok"
        newly_wedged = None
        with self._lock:
            self.last_probe = dict(st)
            prev = self.state
            if healthy:
                if prev == self.WEDGED:
                    self.state, self._ok_streak = self.RECOVERING, 1
                elif prev == self.RECOVERING:
                    self._ok_streak += 1
                    if self._ok_streak >= self.recover_probes:
                        self.state = self.OK
                elif prev == self.SUSPECT:
                    self.state = self.OK
            else:
                self._ok_streak = 0
                if prev == self.OK:
                    self.state = self.SUSPECT
                elif prev == self.SUSPECT:
                    self.state = self.WEDGED
                    self.episodes += 1
                    newly_wedged = self.episodes
                elif prev == self.RECOVERING:
                    # relapse: same episode, the dump_once latch holds
                    self.state = self.WEDGED
            state = self.state
            episode = self.episodes
        self._g_state.set(self.STATE_CODES[state])
        if state != prev:
            logger.warning("backend supervisor: %s -> %s (%s)",
                           prev, state, st.get("status"))
        if newly_wedged is not None:
            self._c_failovers.inc()
            self._dump_wedge(episode, st)
        elif state == self.WEDGED and prev == self.RECOVERING:
            self._dump_wedge(episode, st)   # latched: no second artifact

    def _dump_wedge(self, episode: int, st: dict) -> None:
        """One postmortem per wedge episode, through the dump_once latch
        so a SIGTERM arriving later cannot double-write this trigger."""
        from analytics_zoo_tpu_torch.common import profiling
        fr = profiling.get_flight_recorder()
        fr.note(f"backend wedged (episode {episode}): "
                f"{st.get('status')} {st.get('error', '')}".strip())
        path = fr.dump_once(trigger=f"backend-wedged-{episode}",
                            reason="backend-wedged")
        if path:
            logger.warning("wedge postmortem: %s", path)

    def ensure_started(self) -> "BackendSupervisor":
        """Idempotently start (or restart after ``stop``) the re-probe
        daemon."""
        with self._lock:
            if self._thread is not None and self._thread.is_alive():
                return self
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._loop, daemon=True, name="zoo-backend-supervisor")
            self._thread.start()
        return self

    def _loop(self) -> None:
        delay = self.interval_s
        while not self._stop.is_set():
            woken = self._wake.wait(delay)
            if self._stop.is_set():
                return
            self._wake.clear()
            self.probe_once()
            with self._lock:
                unhealthy = self.state != self.OK
            # exponential-backoff re-probe while unhealthy; a wake (new
            # failure evidence) resets to the fast cadence
            delay = self.interval_s if (not unhealthy or woken) else \
                min(delay * 2.0, self.backoff_max_s)

    def stop(self) -> None:
        self._stop.set()
        self._wake.set()
        t = self._thread
        if t is not None:
            t.join(timeout=5)
        with self._lock:
            self._thread = None

    def snapshot(self) -> dict:
        with self._lock:
            return {"state": self.state, "episodes": self.episodes,
                    "last_probe": dict(self.last_probe)}


def _default_probe(timeout_s: float) -> dict:
    from analytics_zoo_tpu_torch.common import profiling
    return profiling.backend_state(timeout_s=timeout_s)


_SUP_LOCK = threading.Lock()
_SUPERVISOR: Optional[BackendSupervisor] = None


def get_supervisor(**kwargs) -> BackendSupervisor:
    """Process-wide supervisor (created on first call; ``kwargs`` only
    apply to that creation)."""
    global _SUPERVISOR
    with _SUP_LOCK:
        if _SUPERVISOR is None:
            _SUPERVISOR = BackendSupervisor(**kwargs)
        return _SUPERVISOR


def supervisor_snapshot() -> Optional[dict]:
    """The singleton's state for health endpoints; None when no
    supervisor was ever started."""
    with _SUP_LOCK:
        sup = _SUPERVISOR
    return None if sup is None else sup.snapshot()


def note_backend_loss(err: BaseException) -> None:
    """Feed failure evidence to the supervisor if one is running (fit's
    auto-resume boundary and the serving engine report here without
    creating one); a lost device is logged either way."""
    if not is_backend_loss(err):
        return
    logger.warning("backend loss: %s", err)
    with _SUP_LOCK:
        sup = _SUPERVISOR
    if sup is not None:
        sup.report_failure(err)


def _drop_supervisor() -> None:
    global _SUPERVISOR
    with _SUP_LOCK:
        sup, _SUPERVISOR = _SUPERVISOR, None
    if sup is not None:
        sup.stop()


def reset_for_tests() -> None:
    """Drop the injector so ``ZOO_FAULT_PLAN`` is read again on next use,
    and stop the supervisor."""
    global _INJECTOR, _INJ_LOADED
    with _INJ_LOCK:
        _INJECTOR = None
        _INJ_LOADED = False
    _drop_supervisor()
