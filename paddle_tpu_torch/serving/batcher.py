"""Admission control shared by the serving batchers: the fail-fast
rejections, the circuit breaker and the stop-time drain of waiters.

Counterpart of the parts of ``paddle_tpu/serving/batcher.py`` the
generation tier needs (``_STOP``, ``Overloaded``, ``Unavailable``,
``CircuitBreaker``, ``_fail_waiters``).  The breaker's threshold and
cooldown are constructor arguments with the reference's flag defaults
(``FLAGS_serving_breaker_threshold``, ``FLAGS_serving_breaker_cooldown_s``).
The reference's gauges, flight events and SLO hooks wait for the monitor
port (ROADMAP A10).
"""

from __future__ import annotations

import math
import queue
import threading
import time
from typing import Optional

_STOP = object()


class _ServingRejection(RuntimeError):
    """Base of the fail-fast rejections: a machine-readable ``reason`` and
    the Retry-After contract (``retry_after_s`` and its integer HTTP
    header form)."""

    def __init__(self, message: str,
                 retry_after_s: Optional[float] = None,
                 reason: str = "rejected"):
        super().__init__(message)
        self.retry_after_s = retry_after_s
        self.reason = reason

    @property
    def retry_after_header(self) -> Optional[str]:
        """HTTP Retry-After in integer delta-seconds, None without a
        hint."""
        if not self.retry_after_s:
            return None
        return str(max(1, int(math.ceil(self.retry_after_s))))


class Overloaded(_ServingRejection):
    """Admission control shed the request (HTTP 429), with a Retry-After
    from the batcher's observed queue wait; ``reason`` names the saturated
    resource."""

    def __init__(self, message: str, retry_after_s: float = 1.0,
                 reason: str = "overloaded"):
        super().__init__(message, retry_after_s=float(retry_after_s),
                         reason=reason)


class Unavailable(_ServingRejection):
    """Named fail-fast rejection (HTTP 503): draining, stopped, or the
    circuit breaker is open."""

    def __init__(self, message: str, retry_after_s: Optional[float] = None,
                 reason: str = "unavailable"):
        super().__init__(message, retry_after_s=retry_after_s,
                         reason=reason)


def _fail_waiters(q: "queue.Queue", pending, message: str) -> None:
    """Fail every request still in ``pending`` (a deque) or ``q`` with the
    named 503 and wake its waiter: no waiter rides out its full timeout
    against a stopped scheduler."""
    leftovers = list(pending)
    pending.clear()
    while True:
        try:
            r = q.get_nowait()
        except queue.Empty:
            break
        if r is not _STOP:
            leftovers.append(r)
    for r in leftovers:
        r.error = Unavailable(message, reason="stopped")
        r.event.set()


class CircuitBreaker:
    """Executor-failure breaker: CLOSED until ``threshold`` consecutive
    failures, then OPEN (``allow()`` is False) for ``cooldown_s``, then
    HALF-OPEN: one probe at a time is admitted; its success closes the
    breaker, its failure re-opens it.  A probe slot that was never
    resolved is reclaimed after a cooldown.  Threshold 0 disables the
    breaker."""

    CLOSED, OPEN, HALF_OPEN = 0, 1, 2

    def __init__(self, name: str, threshold: int = 5,
                 cooldown_s: float = 5.0):
        self.name = name
        self.threshold = int(threshold)
        self.cooldown_s = float(cooldown_s)
        self._lock = threading.Lock()
        self._state = self.CLOSED
        self._failures = 0
        self._opened_at = 0.0
        self._probing = False
        self._probe_started = 0.0

    @property
    def state(self) -> int:
        return self._state

    def allow(self) -> bool:
        if self.threshold <= 0:
            return True
        with self._lock:
            if self._state == self.CLOSED:
                return True
            now = time.monotonic()
            if self._state == self.OPEN:
                if now - self._opened_at < self.cooldown_s:
                    return False
                self._state = self.HALF_OPEN
                self._probing = False
            if self._probing and now - self._probe_started < self.cooldown_s:
                return False
            self._probing = True
            self._probe_started = now
            return True

    def record_success(self) -> None:
        if self.threshold <= 0:
            return
        with self._lock:
            self._failures = 0
            self._probing = False
            self._state = self.CLOSED

    def record_failure(self) -> None:
        if self.threshold <= 0:
            return
        with self._lock:
            self._failures += 1
            probe_failed = self._probing and self._state == self.HALF_OPEN
            self._probing = False
            if probe_failed or self._failures >= self.threshold:
                self._opened_at = time.monotonic()
                self._state = self.OPEN
