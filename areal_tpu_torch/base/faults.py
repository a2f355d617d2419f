"""Deterministic fault injection for fault-tolerance tests (the
counterpart of ``areal_tpu/base/faults.py``).

Production code is sprinkled with *named injection points*::

    faults.maybe_fail("gen.http", url=url, op="generate", qid=qid)

which are a no-op (one module-level bool check, zero allocation) unless a
test has scripted a fault against that point.  Tests arm faults with
:func:`inject` and clean up with :func:`reset`::

    rule = faults.inject("gen.http", url=dead_url, times=3)   # fail 3 calls
    ...
    assert rule.fired == 3

Determinism: rules match on the point name plus exact keyword filters and
fire on a call-count window (``after`` skipped calls, then ``times`` hits),
so a scripted scenario plays out identically on every run — no randomness,
no wall-clock dependence.

Actions
-------
- ``fail``  — raise :class:`FaultInjected` (a ``ConnectionError``: retry
  machinery treats it exactly like a dead peer).
- ``drop``  — same as ``fail`` but models a request that was *sent* and got
  no response (semantically: the server may have seen it).
- ``delay`` — sleep ``delay_s`` then proceed (async points use
  :func:`maybe_fail_async` so the event loop is not blocked).
- ``trip`` — do not raise; the *dedicated* check :func:`maybe_trip` returns
  True so the production code takes its own fault path (poison a train
  step, simulate a delivered SIGTERM). ``maybe_fail`` ignores trip rules.

Injection-point catalog (the reference's, point for point; the points
marked * have no call site in the port yet: the elastic trainer world
comes in a later slice):

====================  ========================================  ==========
point                 where                                      kwargs
====================  ========================================  ==========
``gen.http``          every GenAPIClient request attempt         url, op
``gen.weight_update`` GenAPIClient.update_weights_from_disk      url
``rollout.push``      RolloutWorker trajectory push              qid
``ckpt.save``         engine checkpoint commit (post-stage,      path
                      pre-manifest: simulates dying mid-save)
``train.step``        TrainEngine.train_prepared (trip: poison   step
                      the step's loss weights -> non-finite)
``signal.term``       GracefulShutdown.should_stop (trip:        (none)
                      simulate a delivered SIGTERM)
``rank.kill`` *       elastic rank step loop (trip: the rank     step, epoch
                      SIGKILLs itself -- hard death mid-step)
``rank.hang`` *       elastic rank step loop (trip: the rank     step, epoch
                      wedges forever without exiting)
``collective.timeout`` * elastic CollectiveGuard (trip: treat the  label
                      in-flight collective as timed out now)
``gw.backend_die_midstream`` gen server /generate_stream frame    rid
                      write (fail: the backend drops the stream
                      mid-generation -- server death as the
                      gateway sees it)
``gw.backend_wedge``  gen server /generate_stream frame write    rid
                      (delay: the backend stalls before its
                      first chunk -- the straggler the hedge
                      path exists for)
``gw.deadline_storm`` gateway scheduler _pick_server (trip:        (none)
                      report zero dispatch capacity so queued
                      requests age out against their deadlines)
====================  ========================================  ==========
"""

import asyncio
import dataclasses
import threading
import time
from typing import Dict, List, Optional

from areal_tpu_torch.base import logging
from areal_tpu_torch.base import metrics

logger = logging.getLogger("faults")


# The injection-point registry: one entry per named point in the table
# above, equal to the reference's. A ``maybe_fail`` / ``maybe_trip`` /
# ``inject`` call naming an unlisted point would never fire in a scripted
# scenario, so ``inject`` refuses one.
FAULT_POINTS = (
    "gen.http",
    "gen.weight_update",
    "rollout.push",
    "ckpt.save",
    "train.step",
    "signal.term",
    "rank.kill",
    "rank.hang",
    "collective.timeout",
    "gw.backend_die_midstream",
    "gw.backend_wedge",
    "gw.deadline_storm",
)


class FaultInjected(ConnectionError):
    """Raised by an armed injection point (subclass of ``ConnectionError``
    so retry/breaker machinery handles it like a real dead peer)."""


@dataclasses.dataclass
class FaultRule:
    point: str
    action: str = "fail"               # fail | drop | delay
    match: Dict[str, object] = dataclasses.field(default_factory=dict)
    times: Optional[int] = None        # fire at most N times (None = forever)
    after: int = 0                     # skip the first `after` matching calls
    delay_s: float = 0.0
    seen: int = 0                      # matching calls observed
    fired: int = 0                     # faults actually injected

    def _matches(self, kw: Dict[str, object]) -> bool:
        return all(kw.get(k) == v for k, v in self.match.items())

    def _should_fire(self) -> bool:
        """Call-count window check; the caller increments ``seen`` first."""
        if self.seen <= self.after:
            return False
        return self.times is None or self.fired < self.times


_lock = threading.Lock()
_rules: List[FaultRule] = []
_enabled = False  # fast path: maybe_fail is one bool check when off


def inject(
    point: str,
    action: str = "fail",
    times: Optional[int] = None,
    after: int = 0,
    delay_s: float = 0.0,
    **match,
) -> FaultRule:
    """Arm a fault at ``point``. Returns the rule (inspect ``.fired``)."""
    assert action in ("fail", "drop", "delay", "trip"), action
    if point not in FAULT_POINTS:
        raise ValueError(f"unknown fault point {point!r}; see FAULT_POINTS")
    global _enabled
    rule = FaultRule(
        point=point, action=action, match=match, times=times,
        after=after, delay_s=delay_s,
    )
    with _lock:
        _rules.append(rule)
        _enabled = True
    logger.info("armed fault %s", rule)
    return rule


def reset() -> None:
    """Disarm every rule (tests call this in teardown)."""
    global _enabled
    with _lock:
        _rules.clear()
        _enabled = False


def active() -> bool:
    return _enabled


def _pick(
    point: str, kw: Dict[str, object], actions: tuple
) -> Optional[FaultRule]:
    # actions filters which rule kinds this check site can fire: a raise
    # site must never consume a trip rule's call-count window (and vice
    # versa) — the window semantics stay per-site deterministic.
    with _lock:
        for rule in _rules:
            if (
                rule.point == point
                and rule.action in actions
                and rule._matches(kw)
            ):
                rule.seen += 1
                if rule._should_fire():
                    rule.fired += 1
                    return rule
    return None


def _fire(rule: FaultRule, point: str, kw: Dict[str, object]) -> float:
    """Common bookkeeping; returns a delay to sleep (0 = none)."""
    metrics.counters.add(f"faults/{point}")
    if rule.action in ("fail", "drop"):
        raise FaultInjected(
            f"injected {rule.action} at {point} ({kw}, hit #{rule.fired})"
        )
    return rule.delay_s


def maybe_fail(point: str, **kw) -> None:
    """Sync injection point: no-op unless a matching rule is armed."""
    if not _enabled:
        return
    rule = _pick(point, kw, ("fail", "drop", "delay"))
    if rule is None:
        return
    delay = _fire(rule, point, kw)
    if delay > 0:
        time.sleep(delay)


def maybe_trip(point: str, **kw) -> bool:
    """Non-raising injection point: True when an armed ``trip`` rule fires.
    The caller takes its own fault path (poison a value, request a stop) —
    used where an exception would not model the failure (a NaN loss, a
    delivered signal)."""
    if not _enabled:
        return False
    rule = _pick(point, kw, ("trip",))
    if rule is None:
        return False
    metrics.counters.add(f"faults/{point}")
    logger.warning("tripped fault at %s (%s, hit #%d)", point, kw, rule.fired)
    return True


async def maybe_fail_async(point: str, **kw) -> None:
    """Async injection point — delays yield to the event loop."""
    if not _enabled:
        return
    rule = _pick(point, kw, ("fail", "drop", "delay"))
    if rule is None:
        return
    delay = _fire(rule, point, kw)
    if delay > 0:
        await asyncio.sleep(delay)
