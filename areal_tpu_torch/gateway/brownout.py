"""Brownout ladder for the serving gateway (a copy of
``areal_tpu/gateway/brownout.py``; docs/serving.md "Survivability").

When the fleet is saturated — KV demand occupancy pinned, queue-wait p95
climbing, breakers opening — uniform queueing turns every request into a
timeout. Graceful degradation sheds LOAD before it sheds CORRECTNESS,
through an ordered ladder of reversible levels:

1. **clamp** — cap ``max_tokens`` fleet-wide (shorter answers for
   everyone beats failures for some).
2. **no speculation** — disable speculative decoding via each backend's
   ``/spec_decode`` toggle: draft work competes with target-model decode
   for the same chips, so under saturation speculation costs throughput.
3. **shed best-effort** — 429 tenants whose weight is below the
   configured floor, with an honest ``Retry-After`` (the ladder's
   soonest possible de-escalation), keeping capacity for paying lanes.
4. **admit nothing** — every new request answers 429; in-flight streams
   run to completion. The last rung before falling over.

The split mirrors ``gateway/autoscaler.py``: :func:`decide` is a PURE
function over :class:`~areal_tpu_torch.gateway.autoscaler.ScaleSignals` (tests
drive it with synthetic inputs), :class:`BrownoutController` is the
actuation loop. Escalation is immediate — saturation compounds — while
de-escalation steps down ONE level at a time, only after every signal
drops below the current level's entry thresholds times the hysteresis
factor AND the level has been held ``min_hold_s`` (no flapping between
adjacent rungs on a noisy signal). Transitions are counted
(``gw/brownout_transitions``) and the current level is a live gauge
(``gw/brownout_level``).
"""

import asyncio
import dataclasses
import time
from typing import Awaitable, Callable, Dict, List, Optional

from areal_tpu_torch.base import logging
from areal_tpu_torch.base import metrics as metrics_mod
from areal_tpu_torch.gateway.autoscaler import ScaleSignals

logger = logging.getLogger("areal_tpu_torch.gateway.brownout")


@dataclasses.dataclass
class LevelThresholds:
    """Entry thresholds for ONE ladder rung: the rung trips when ANY of
    the three signals reaches its bound (pressure has many shapes)."""

    kv_occupancy: float
    queue_wait_p95_s: float
    breaker_open_frac: float  # open breakers / routed servers


@dataclasses.dataclass
class BrownoutConfig:
    # rung i of the ladder = levels[i-1]; level 0 is healthy
    levels: List[LevelThresholds] = dataclasses.field(
        default_factory=lambda: [
            LevelThresholds(0.90, 5.0, 0.25),   # 1: clamp max_tokens
            LevelThresholds(0.95, 15.0, 0.50),  # 2: disable spec decode
            LevelThresholds(0.97, 30.0, 0.75),  # 3: shed light tenants
            LevelThresholds(0.99, 60.0, 1.00),  # 4: admit nothing new
        ]
    )
    # de-escalate only when every signal < entry threshold * hysteresis
    hysteresis: float = 0.8
    min_hold_s: float = 30.0   # dwell before any step DOWN
    interval_s: float = 5.0    # controller loop cadence
    clamp_max_tokens: int = 256   # the level-1 cap
    weight_floor: float = 1.0     # level-3: shed tenants below this weight


def decide(cfg: BrownoutConfig, sig: ScaleSignals, current: int) -> int:
    """Pure ladder step: the target level given the signals and the
    current rung. Escalates straight to the worst tripped rung;
    de-escalates one rung only when every signal is below the CURRENT
    rung's entry thresholds times the hysteresis factor. (The dwell-time
    gate lives in the controller — time is side effect, not policy.)"""
    frac = sig.breaker_open / max(sig.routed, 1)

    def trips(lvl: LevelThresholds) -> bool:
        return (
            sig.kv_occupancy >= lvl.kv_occupancy
            or sig.queue_wait_p95_s >= lvl.queue_wait_p95_s
            or frac >= lvl.breaker_open_frac
        )

    worst = 0
    for i, lvl in enumerate(cfg.levels, start=1):
        if trips(lvl):
            worst = i
    if worst > current:
        return worst
    if worst < current:
        entry = cfg.levels[current - 1]
        h = cfg.hysteresis
        if (
            sig.kv_occupancy < entry.kv_occupancy * h
            and sig.queue_wait_p95_s < entry.queue_wait_p95_s * h
            and frac < entry.breaker_open_frac * h
        ):
            return current - 1
    return current


class BrownoutController:
    """Actuation loop around :func:`decide`.

    The levers are injected callbacks so the controller stays free of
    gateway internals (and tests drive it against plain recorders):

    - ``clamp_cb(max_tokens | None)`` — apply/remove the fleet-wide
      ``max_tokens`` cap (level >= 1).
    - ``spec_cb(enabled)`` — async; toggle speculative decoding across
      the fleet (disabled at level >= 2, restored below).
    - ``shed_cb(weight_floor, retry_after_s)`` — shed tenants below the
      floor (level >= 3; floor 0 disables shedding).
    - ``pause_cb(paused, retry_after_s)`` — stop admitting new requests
      (level >= 4).
    """

    def __init__(
        self,
        cfg: BrownoutConfig,
        fetch_signals: Callable[[], ScaleSignals],
        clamp_cb: Callable[[Optional[int]], None],
        spec_cb: Callable[[bool], Awaitable[None]],
        shed_cb: Callable[[float, float], None],
        pause_cb: Callable[[bool, float], None],
        clock=time.monotonic,
    ):
        self.cfg = cfg
        self.fetch_signals = fetch_signals
        self.clamp_cb = clamp_cb
        self.spec_cb = spec_cb
        self.shed_cb = shed_cb
        self.pause_cb = pause_cb
        self._clock = clock
        self.level = 0
        self._last_transition_t = -float("inf")
        metrics_mod.counters.gauge(metrics_mod.GW_BROWNOUT_LEVEL, 0.0)

    def retry_after_s(self) -> float:
        """The honest recovery estimate a shed request is handed: the
        soonest the ladder can step down (remaining dwell), floored at
        one loop interval — never a constant pulled from thin air."""
        held = self._clock() - self._last_transition_t
        return max(self.cfg.min_hold_s - held, self.cfg.interval_s)

    async def step_once(self) -> int:
        """One fetch->decide->apply pass (tests call it directly with
        fake clocks/signals). Returns the level after the pass."""
        sig = self.fetch_signals()
        target = decide(self.cfg, sig, self.level)
        if target < self.level and (
            self._clock() - self._last_transition_t < self.cfg.min_hold_s
        ):
            return self.level  # dwell; escalation is never delayed
        if target != self.level:
            await self._apply(target, sig)
        return self.level

    async def _apply(self, target: int, sig: ScaleSignals) -> None:
        prev, self.level = self.level, target
        self._last_transition_t = self._clock()
        retry_after = self.retry_after_s()
        self.clamp_cb(self.cfg.clamp_max_tokens if target >= 1 else None)
        if (target >= 2) != (prev >= 2):
            await self.spec_cb(target < 2)
        self.shed_cb(
            self.cfg.weight_floor if target >= 3 else 0.0, retry_after
        )
        self.pause_cb(target >= 4, retry_after)
        metrics_mod.counters.gauge(
            metrics_mod.GW_BROWNOUT_LEVEL, float(target)
        )
        metrics_mod.counters.add(metrics_mod.GW_BROWNOUT_TRANSITIONS)
        logger.warning(
            "brownout level %d -> %d (kv %.2f, wait p95 %.1fs, "
            "breakers %d/%d)",
            prev, target, sig.kv_occupancy, sig.queue_wait_p95_s,
            sig.breaker_open, sig.routed,
        )

    async def run(self):
        while True:
            try:
                await self.step_once()
            except asyncio.CancelledError:
                raise
            except Exception:
                logger.exception("brownout pass failed")
            await asyncio.sleep(self.cfg.interval_s)


def wire_brownout(
    cfg: BrownoutConfig,
    scheduler,
    gateway_config,
    client,
    clock=time.monotonic,
) -> BrownoutController:
    """Build a controller actuating a :class:`ContinuousBatchScheduler` +
    :class:`GatewayConfig` pair over a :class:`GenAPIClient`.

    Signals come from the scheduler's live capacity view (mean KV demand
    occupancy + unhealthy count) and the ``gw/queue_wait_s`` histogram.
    The spec-decode lever remembers which backends actually HAD
    speculation on, so restoring the ladder does not switch it on where
    an operator had it disabled."""
    spec_prev: Dict[str, bool] = {}

    def fetch_signals() -> ScaleSignals:
        states = list(scheduler._servers.values())
        routed = len(states)
        unhealthy = sum(1 for s in states if not s.healthy)
        occ = (
            sum(s.kv_occupancy for s in states) / routed if routed else 0.0
        )
        h = metrics_mod.counters.histogram(metrics_mod.GW_QUEUE_WAIT_S)
        p95 = (
            float(h.percentile(95.0))
            if h is not None and h.count else 0.0
        )
        return ScaleSignals(
            routed=routed,
            healthy=routed - unhealthy,
            queue_depth=float(scheduler.queue_depth()),
            kv_occupancy=occ,
            queue_wait_p95_s=p95,
            breaker_open=unhealthy,
        )

    def clamp_cb(max_tokens: Optional[int]) -> None:
        gateway_config.brownout_max_tokens = max_tokens

    async def spec_cb(enabled: bool) -> None:
        if not enabled:
            for url in scheduler.server_urls():
                try:
                    m = await client.metrics(url)
                    spec_prev[url] = bool(m.get("spec_decode", False))
                    if spec_prev[url]:
                        await client.set_spec_decode(url, False)
                except Exception:
                    logger.warning(
                        "brownout: disabling spec decode on %s failed", url
                    )
            return
        for url, was_on in spec_prev.items():
            if not was_on:
                continue
            try:
                await client.set_spec_decode(url, True)
            except Exception:
                logger.warning(
                    "brownout: restoring spec decode on %s failed", url
                )
        spec_prev.clear()

    def shed_cb(weight_floor: float, retry_after_s: float) -> None:
        scheduler.shed_weight_floor = weight_floor
        scheduler.brownout_retry_after_s = retry_after_s

    def pause_cb(paused: bool, retry_after_s: float) -> None:
        scheduler.admit_paused = paused
        scheduler.brownout_retry_after_s = retry_after_s

    return BrownoutController(
        cfg, fetch_signals, clamp_cb, spec_cb, shed_cb, pause_cb,
        clock=clock,
    )
