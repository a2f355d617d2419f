"""Fleet health plane: per-server health records + circuit breakers.

The gserver manager owns one :class:`FleetHealth`.  Every generation server
has a record with the classic three-state breaker:

- **closed** — healthy: eligible for routing and weight-update fan-out.
  ``fail_threshold`` consecutive failures (passive observations from routing
  / weight updates, or failed heartbeats) open the breaker.
- **open** — evicted: excluded from routing and fan-out; sticky
  ``qid → server`` assignments are remapped by the manager.  After
  ``probe_cooldown_s`` the server becomes a probe candidate.
- **half_open** — one probe in flight (``/health`` + catch-up weight load);
  success closes the breaker (re-admission), failure re-opens it and
  restarts the cooldown.

The manager drives the breaker; this module is pure bookkeeping (no I/O),
so the breaker policy lives in one place. A copy of
``areal_tpu/system/fleet.py`` without its process-global metric counters
(the reference's telemetry plane is not ported).
"""

import dataclasses
import logging
import time
from typing import Dict, List, Optional

logger = logging.getLogger("areal_tpu_torch.fleet")

CLOSED = "closed"
OPEN = "open"
HALF_OPEN = "half_open"


@dataclasses.dataclass
class ServerHealth:
    url: str
    state: str = CLOSED
    consecutive_failures: int = 0
    total_failures: int = 0
    total_successes: int = 0
    opened_at: float = 0.0
    last_failure_reason: str = ""
    # last weight version this server confirmed loading (-1 = none yet);
    # the checkpoint pruner only deletes dirs every healthy server moved past
    acked_version: int = -1


class FleetHealth:
    def __init__(
        self,
        urls: Optional[List[str]] = None,
        fail_threshold: int = 3,
        probe_cooldown_s: float = 5.0,
        clock=time.monotonic,
    ):
        self.fail_threshold = fail_threshold
        self.probe_cooldown_s = probe_cooldown_s
        self._clock = clock
        self._servers: Dict[str, ServerHealth] = {}
        for u in urls or []:
            self.add_server(u)

    # ------------------------------------------------------------------ #
    # membership / views
    # ------------------------------------------------------------------ #

    def add_server(self, url: str) -> ServerHealth:
        if url not in self._servers:
            self._servers[url] = ServerHealth(url=url)
        return self._servers[url]

    def remove_server(self, url: str) -> None:
        self._servers.pop(url, None)

    def get(self, url: str) -> Optional[ServerHealth]:
        return self._servers.get(url)

    def healthy_urls(self) -> List[str]:
        return [u for u, s in self._servers.items() if s.state == CLOSED]

    def unhealthy_urls(self) -> List[str]:
        return [u for u, s in self._servers.items() if s.state != CLOSED]

    def is_healthy(self, url: str) -> bool:
        s = self._servers.get(url)
        return s is not None and s.state == CLOSED

    # ------------------------------------------------------------------ #
    # passive observations (routing + weight-update outcomes)
    # ------------------------------------------------------------------ #

    def observe_success(self, url: str) -> None:
        s = self.add_server(url)
        s.total_successes += 1
        s.consecutive_failures = 0

    def observe_failure(self, url: str, reason: str = "") -> bool:
        """Record one failure; returns True if this observation evicted the
        server (breaker transitioned closed → open)."""
        s = self.add_server(url)
        s.total_failures += 1
        s.consecutive_failures += 1
        s.last_failure_reason = reason
        if s.state == CLOSED and s.consecutive_failures >= self.fail_threshold:
            self.evict(url, reason or "consecutive failures")
            return True
        if s.state == HALF_OPEN:
            # a routed request failed while a probe was deciding: re-open
            self._reopen(s, reason or "failure while half-open")
        return False

    def evict(self, url: str, reason: str) -> None:
        s = self.add_server(url)
        if s.state == OPEN:
            return
        s.state = OPEN
        s.opened_at = self._clock()
        s.last_failure_reason = reason
        logger.warning(
            "evicted gen server %s (%s; %d consecutive failures)",
            url, reason, s.consecutive_failures,
        )

    def _reopen(self, s: ServerHealth, reason: str) -> None:
        s.state = OPEN
        s.opened_at = self._clock()
        s.last_failure_reason = reason

    # ------------------------------------------------------------------ #
    # probing / re-admission
    # ------------------------------------------------------------------ #

    def probe_candidates(self) -> List[str]:
        """Open servers whose cooldown has elapsed (ready for half-open)."""
        now = self._clock()
        return [
            u
            for u, s in self._servers.items()
            if s.state == OPEN and now - s.opened_at >= self.probe_cooldown_s
        ]

    def begin_probe(self, url: str) -> None:
        s = self.add_server(url)
        if s.state == OPEN:
            s.state = HALF_OPEN

    def probe_failed(self, url: str, reason: str = "") -> None:
        s = self.add_server(url)
        s.total_failures += 1
        self._reopen(s, reason or "probe failed")
        logger.info("probe of %s failed (%s); breaker re-opened", url, reason)

    def readmit(self, url: str, acked_version: Optional[int] = None) -> None:
        """Probe + catch-up weight load succeeded: back to closed."""
        s = self.add_server(url)
        was_out = s.state != CLOSED
        s.state = CLOSED
        s.consecutive_failures = 0
        s.total_successes += 1
        if acked_version is not None:
            s.acked_version = max(s.acked_version, acked_version)
        if was_out:
            logger.info(
                "re-admitted gen server %s at v%s", url, s.acked_version
            )

    # ------------------------------------------------------------------ #
    # weight-version acks (checkpoint-prune gating)
    # ------------------------------------------------------------------ #

    def ack_version(self, url: str, version: int) -> None:
        s = self.add_server(url)
        s.acked_version = max(s.acked_version, version)

    def min_acked_version(self) -> int:
        """Smallest acked version across *healthy* servers (evicted servers
        catch up from the newest checkpoint on re-admission, so they do not
        hold old dirs alive).  -1 when any healthy server has acked nothing,
        or when there are no healthy servers (nothing is safe to prune:
        whoever comes back will need a dir to load from)."""
        healthy = [s for s in self._servers.values() if s.state == CLOSED]
        if not healthy:
            return -1
        return min(s.acked_version for s in healthy)

    # ------------------------------------------------------------------ #

    def snapshot(self) -> Dict[str, dict]:
        return {
            u: {
                "state": s.state,
                "consecutive_failures": s.consecutive_failures,
                "total_failures": s.total_failures,
                "total_successes": s.total_successes,
                "acked_version": s.acked_version,
                "last_failure_reason": s.last_failure_reason,
            }
            for u, s in self._servers.items()
        }
