"""Telemetry-driven autoscaler for the serving gateway (a copy of
``areal_tpu/gateway/autoscaler.py``).

Closes the loop the observability plane opened: the per-worker telemetry
exporters publish queue/latency/HBM gauges, ``system/telemetry.py``
merges them into the ``fleet/`` aggregate, and this module turns that
aggregate into scale decisions:

- **signals** (:class:`ScaleSignals`): gateway queue depth per routed
  server, queue-wait p95 from the ``gw/queue_wait_s`` merged histogram,
  mean KV-pool occupancy across gen servers, and open-breaker counts
  from the manager's per-server states.
- **decision table** (:func:`decide`): a PURE function — synthetic
  aggregates drive it directly in tests. Grow when any pressure signal
  trips (or to replace breaker-open servers / reach the floor); shrink
  only when EVERY relax signal agrees; hold otherwise.
- **actuation** (:class:`Autoscaler`): a loop that fetches signals,
  applies cooldown, and grows/shrinks the ROUTED server set through
  callbacks — the gateway scheduler's ``set_servers`` plus the gserver
  manager's ``/add_server`` / ``/remove_server`` control endpoints, so
  sticky RL routing rebalances live alongside user traffic.
"""

import asyncio
import dataclasses
import time
from typing import Callable, Dict, List, Optional

from areal_tpu_torch.base import logging
from areal_tpu_torch.base import metrics as metrics_mod

logger = logging.getLogger("areal_tpu_torch.gateway.autoscaler")


@dataclasses.dataclass
class AutoscalerConfig:
    min_servers: int = 1
    max_servers: int = 8
    interval_s: float = 10.0
    cooldown_s: float = 30.0
    # grow when ANY of these trips
    up_queue_per_server: float = 4.0
    up_kv_occupancy: float = 0.85
    up_queue_wait_p95_s: float = 10.0
    # shrink only when ALL of these hold (hysteresis below the up-gates)
    down_queue_per_server: float = 0.25
    down_kv_occupancy: float = 0.30


@dataclasses.dataclass
class ScaleSignals:
    """The decision table's input, extracted from a ``fleet/`` aggregate."""

    routed: int                    # servers currently routed by the gateway
    healthy: int                   # routed minus breaker-open
    queue_depth: float = 0.0       # gateway fair-queue depth
    kv_occupancy: float = 0.0      # mean pool occupancy across gen servers
    queue_wait_p95_s: float = 0.0  # merged gw/queue_wait_s p95
    breaker_open: int = 0          # manager breaker states: open/half-open

    @classmethod
    def from_fleet_scalars(
        cls,
        scalars: Dict[str, float],
        routed: int,
        n_gen_servers: Optional[int] = None,
    ) -> "ScaleSignals":
        """Pull the autoscaler's inputs out of a flattened ``fleet/``
        scalar dict (``telemetry.FleetAggregate.scalars()``). Gauges are
        fleet SUMS, so per-server means divide by the exporter count."""
        n_gen = n_gen_servers if n_gen_servers is not None else max(
            int(scalars.get("servers_total", routed) or routed), 1
        )
        open_cnt = int(
            scalars.get("servers_open", 0.0)
            + scalars.get("servers_half_open", 0.0)
        )
        occ = scalars.get(
            "kv_pool_demand_occupancy", scalars.get("kv_pool_occupancy", 0.0)
        )
        return cls(
            routed=routed,
            healthy=max(routed - open_cnt, 0),
            queue_depth=float(scalars.get("gw_queue_depth", 0.0)),
            kv_occupancy=float(occ) / max(n_gen, 1),
            queue_wait_p95_s=float(scalars.get("gw/queue_wait_s/p95", 0.0)),
            breaker_open=open_cnt,
        )


@dataclasses.dataclass
class ScaleDecision:
    action: str                 # "grow" | "shrink" | "hold"
    delta: int = 0              # servers to add (grow) or remove (shrink)
    reasons: List[str] = dataclasses.field(default_factory=list)


def decide(cfg: AutoscalerConfig, sig: ScaleSignals) -> ScaleDecision:
    """Pure decision table (tested against synthetic aggregates)."""
    reasons: List[str] = []
    headroom = cfg.max_servers - sig.routed
    # floor / breaker replacement first: these are correctness, not load
    if sig.healthy < cfg.min_servers and headroom > 0:
        want = min(cfg.min_servers - sig.healthy, headroom)
        reasons.append(
            f"healthy {sig.healthy} below floor {cfg.min_servers}"
        )
        return ScaleDecision("grow", want, reasons)
    if sig.breaker_open > 0 and headroom > 0:
        want = min(sig.breaker_open, headroom)
        reasons.append(f"replacing {sig.breaker_open} breaker-open servers")
        return ScaleDecision("grow", want, reasons)
    per_server = sig.queue_depth / max(sig.healthy, 1)
    if headroom > 0:
        if per_server > cfg.up_queue_per_server:
            reasons.append(
                f"queue {per_server:.1f}/server > {cfg.up_queue_per_server}"
            )
        if sig.kv_occupancy > cfg.up_kv_occupancy:
            reasons.append(
                f"kv occupancy {sig.kv_occupancy:.2f} > "
                f"{cfg.up_kv_occupancy}"
            )
        if sig.queue_wait_p95_s > cfg.up_queue_wait_p95_s:
            reasons.append(
                f"queue wait p95 {sig.queue_wait_p95_s:.1f}s > "
                f"{cfg.up_queue_wait_p95_s}s"
            )
        if reasons:
            # deep backlog grows faster than one-at-a-time
            extra = int(per_server // (2 * cfg.up_queue_per_server))
            return ScaleDecision(
                "grow", min(1 + extra, headroom), reasons
            )
    if (
        sig.routed > cfg.min_servers
        and sig.breaker_open == 0
        and per_server < cfg.down_queue_per_server
        and sig.kv_occupancy < cfg.down_kv_occupancy
        and sig.queue_wait_p95_s < cfg.up_queue_wait_p95_s / 2
    ):
        return ScaleDecision(
            "shrink", 1,
            [
                f"idle: queue {per_server:.2f}/server, kv occupancy "
                f"{sig.kv_occupancy:.2f}"
            ],
        )
    return ScaleDecision("hold", 0, reasons)


class Autoscaler:
    """Actuation loop around :func:`decide`.

    ``fetch_signals`` returns the current :class:`ScaleSignals` (built
    from the fleet aggregate); ``grow_cb(n)`` / ``shrink_cb(n)`` apply a
    decision and return how many servers actually changed (the routed
    set is bounded by what the launcher spawned, so a grow can be
    partially satisfied)."""

    def __init__(
        self,
        cfg: AutoscalerConfig,
        fetch_signals: Callable[[], ScaleSignals],
        grow_cb: Callable[[int], int],
        shrink_cb: Callable[[int], int],
        clock=time.monotonic,
    ):
        self.cfg = cfg
        self.fetch_signals = fetch_signals
        self.grow_cb = grow_cb
        self.shrink_cb = shrink_cb
        self._clock = clock
        self._last_action_t = -float("inf")
        self.last_decision: Optional[ScaleDecision] = None

    def step_once(self) -> ScaleDecision:
        """One fetch->decide->apply pass (the loop body; tests call it
        directly with fake clocks/signals)."""
        sig = self.fetch_signals()
        decision = decide(self.cfg, sig)
        self.last_decision = decision
        if decision.action == "hold":
            return decision
        now = self._clock()
        if now - self._last_action_t < self.cfg.cooldown_s:
            return ScaleDecision(
                "hold", 0,
                [f"cooldown ({decision.action} {decision.delta} deferred)"],
            )
        applied = 0
        if decision.action == "grow":
            applied = self.grow_cb(decision.delta)
            if applied:
                metrics_mod.counters.add(metrics_mod.GW_SCALE_UPS, applied)
        elif decision.action == "shrink":
            applied = self.shrink_cb(decision.delta)
            if applied:
                metrics_mod.counters.add(
                    metrics_mod.GW_SCALE_DOWNS, applied
                )
        if applied:
            self._last_action_t = now
            logger.info(
                "autoscaler %s %d server(s): %s",
                decision.action, applied, "; ".join(decision.reasons),
            )
        return decision

    async def run(self):
        while True:
            try:
                self.step_once()
            except asyncio.CancelledError:
                raise
            except Exception:
                logger.exception("autoscaler pass failed")
            await asyncio.sleep(self.cfg.interval_s)
