"""Deterministic fault injection for ``fit(auto_resume=True)``.

Counterpart of the part of ``analytics_zoo_tpu/common/resilience.py``
that the estimator's retry-from-snapshot uses. A fault plan
(``ZOO_FAULT_PLAN``, or :func:`install_plan`) is a comma-separated list of
``kind@site[:start[+more]]`` specs:

- ``wedge@step:12``  — the 12th training step raises
- ``wedge@step:5+2`` — steps 5 to 7 raise (start plus 2 more)
- ``wedge@step``     — every step raises

Sites count their arrivals per process, so a plan strikes the same call
every run. :func:`is_backend_loss` tells a lost device from a model or
data bug, and ``ZOO_FIT_MAX_RESUMES`` bounds the resumes. The JAX
package's backend supervisor, serving replicas and CPU fallback are not
here: the port has no CPU failover (ROADMAP A10 ports the supervisor).
"""

from __future__ import annotations

import logging
import os
import re
import threading
from contextlib import contextmanager
from typing import Dict, List, Optional

__all__ = ["InjectedFault", "FaultInjector", "get_injector", "install_plan",
           "maybe_fault", "fault_scope", "is_backend_loss",
           "fit_max_resumes", "note_backend_loss", "reset_for_tests"]

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


def note_backend_loss(err: BaseException) -> None:
    """Record failure evidence from fit's auto-resume boundary: a lost
    device is logged (the port has no supervisor to tell)."""
    if is_backend_loss(err):
        logger.warning("backend loss during fit: %s", err)


def reset_for_tests() -> None:
    """Drop the injector so ``ZOO_FAULT_PLAN`` is read again on next use."""
    global _INJECTOR, _INJ_LOADED
    with _INJ_LOCK:
        _INJECTOR = None
        _INJ_LOADED = False
