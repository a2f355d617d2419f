"""Per-tenant QoS primitives for the serving gateway (a copy of
``areal_tpu/gateway/qos.py``).

Pure bookkeeping — no I/O, no asyncio — so the policy layer is trivially
testable and lives in one place (the same split as ``system/fleet.py`` vs
the manager):

- :class:`TenantSpec` — a tenant's weight and rate-limit envelope.
- :class:`TokenBucket` — classic token-bucket rate limiter. Requests are
  charged their *budgeted* cost (prompt tokens + ``max_tokens``) at
  admission and refunded the unused budget at completion, so the bucket
  tracks real token consumption instead of request counts.
- :class:`WeightedFairQueue` — start-time fair queueing across tenants:
  each enqueued item is stamped a virtual finish time
  ``vft = max(vtime, tenant_last_vft) + cost / weight`` and ``pop``
  returns the globally smallest stamp. A heavy tenant's backlog inflates
  only its OWN virtual clock, so a light tenant's next request jumps the
  line (starvation freedom).
"""

import collections
import dataclasses
import math
import time
from typing import Deque, Dict, List, Optional, Tuple


@dataclasses.dataclass
class TenantSpec:
    """One tenant's QoS envelope. ``rate_tokens_per_s <= 0`` means
    unlimited; ``burst_tokens <= 0`` defaults to 4x the rate (or
    unlimited when the rate is unlimited)."""

    name: str
    weight: float = 1.0
    rate_tokens_per_s: float = 0.0
    burst_tokens: float = 0.0
    # default per-request deadline in seconds (<= 0 = none): applied when
    # the client names no deadline of its own; the scheduler sheds queued
    # requests whose remaining budget cannot cover estimated service
    default_deadline_s: float = 0.0

    def resolved_burst(self) -> float:
        if self.rate_tokens_per_s <= 0:
            return math.inf
        if self.burst_tokens > 0:
            return self.burst_tokens
        return 4.0 * self.rate_tokens_per_s


class TokenBucket:
    """Token bucket with an injectable clock (tests drive virtual time)."""

    def __init__(
        self,
        rate_tokens_per_s: float,
        burst_tokens: float,
        clock=time.monotonic,
    ):
        self.rate = max(rate_tokens_per_s, 0.0)
        self.burst = burst_tokens if burst_tokens > 0 else math.inf
        self.unlimited = self.rate <= 0
        self._clock = clock
        self._tokens = self.burst
        self._t = clock()

    def _refill(self) -> None:
        now = self._clock()
        if not self.unlimited and now > self._t:
            self._tokens = min(
                self.burst, self._tokens + (now - self._t) * self.rate
            )
        self._t = now

    def try_acquire(self, cost: float) -> bool:
        if self.unlimited:
            return True
        self._refill()
        if self._tokens >= cost:
            self._tokens -= cost
            return True
        return False

    def refund(self, amount: float) -> None:
        """Return unused budget (actual consumption < the charge)."""
        if not self.unlimited and amount > 0:
            self._tokens = min(self.burst, self._tokens + amount)

    def retry_after_s(self, cost: float) -> float:
        """Seconds until ``cost`` tokens will be available (the 429
        Retry-After hint); 0 when it would succeed now."""
        if self.unlimited:
            return 0.0
        self._refill()
        missing = min(cost, self.burst) - self._tokens
        if missing <= 0:
            return 0.0
        return missing / self.rate

    @property
    def available(self) -> float:
        self._refill()
        return self._tokens


def _service_share(cost: float, weight: float) -> float:
    """One queue entry's virtual-time share. The SINGLE definition:
    ``push`` stamps it, ``rollback`` reverses it — deriving it twice
    would let the rollback amount drift from what the stamp advanced."""
    return max(cost, 1.0) / max(weight, 1e-9)


class WeightedFairQueue:
    """Start-time fair queue: O(tenants) pop, FIFO within a tenant.

    Entries are ``(vft, share, item)`` — ``share`` (= cost/weight) is kept
    so ``drop_where`` can roll the tenant's virtual clock back for work
    that never ran (a cancelled queued request must not deprioritize the
    tenant's future traffic)."""

    def __init__(self):
        self._queues: Dict[str, Deque[Tuple[float, float, object]]] = {}
        self._last_vft: Dict[str, float] = {}
        self._vtime = 0.0
        self._len = 0

    def __len__(self) -> int:
        return self._len

    def depth(self, tenant: str) -> int:
        return len(self._queues.get(tenant, ()))

    def push(self, tenant: str, cost: float, weight: float, item) -> None:
        start = max(self._vtime, self._last_vft.get(tenant, 0.0))
        share = _service_share(cost, weight)
        vft = start + share
        self._last_vft[tenant] = vft
        self._queues.setdefault(tenant, collections.deque()).append(
            (vft, share, item)
        )
        self._len += 1

    def pop(self):
        """Item with the smallest virtual finish time; None when empty."""
        best_tenant: Optional[str] = None
        best_vft = math.inf
        for tenant, q in self._queues.items():
            if q and q[0][0] < best_vft:
                best_vft, best_tenant = q[0][0], tenant
        if best_tenant is None:
            return None
        vft, _, item = self._queues[best_tenant].popleft()
        if not self._queues[best_tenant]:
            del self._queues[best_tenant]
        self._vtime = max(self._vtime, vft)
        self._len -= 1
        return item

    def rollback(self, tenant: str, cost: float, weight: float) -> None:
        """Roll the tenant's virtual clock back for ONE already-popped
        entry that never ran — the popped-entry twin of ``drop_where``'s
        rollback, for the dispatch-side cancel race (the scheduler pops a
        request, then discovers it was cancelled). Later queued entries
        of the tenant (and its ``_last_vft``) shift earlier by the same
        service share, so the cancelled work does not count against the
        tenant's fair share."""
        share = _service_share(cost, weight)
        if tenant in self._last_vft:
            self._last_vft[tenant] -= share
        q = self._queues.get(tenant)
        if q:
            self._queues[tenant] = collections.deque(
                (vft - share, s, it) for vft, s, it in q
            )

    def drop_where(self, pred) -> int:
        """Remove queued items matching ``pred`` (client disconnects while
        still queued); returns how many were dropped. Later entries of the
        same tenant (and its ``_last_vft``) shift earlier by the dropped
        items' service shares — the cancelled work never ran, so it must
        not count against the tenant's fair share."""
        dropped = 0
        for tenant in list(self._queues):
            kept: Deque[Tuple[float, float, object]] = collections.deque()
            shift = 0.0
            for vft, share, it in self._queues[tenant]:
                if pred(it):
                    dropped += 1
                    shift += share
                else:
                    kept.append((vft - shift, share, it))
            if shift and tenant in self._last_vft:
                self._last_vft[tenant] -= shift
            if kept:
                self._queues[tenant] = kept
            else:
                del self._queues[tenant]
        self._len -= dropped
        return dropped


def build_buckets(
    tenants: Dict[str, TenantSpec], clock=time.monotonic
) -> Dict[str, TokenBucket]:
    return {
        name: TokenBucket(
            spec.rate_tokens_per_s, spec.resolved_burst(), clock=clock
        )
        for name, spec in tenants.items()
    }


def request_cost(prompt_len: int, max_new_tokens: int) -> float:
    """The budgeted cost a request is charged at admission (refunded down
    to actual consumption at completion)."""
    return float(prompt_len + max_new_tokens)
