"""Continuous-batching scheduler: the gateway's dispatch plane (the
counterpart of ``areal_tpu/gateway/scheduler.py``).

Bridges the OpenAI-compatible API surface (``gateway/api.py``) to the gen
fleet's chunked engines. Requests are NOT batched at request boundaries:
each one is dispatched into an engine slot the moment one frees up (the
engine's chunked admission protocol, ``gen/engine.py``), subject to three
gates applied in order:

1. **rate limit** — per-tenant token bucket, charged the budgeted cost
   (prompt + ``max_tokens``) at arrival, refunded the unused budget at
   completion. Over-budget requests answer 429 immediately.
2. **queue** — admitted requests wait in a weighted fair queue
   (``gateway/qos.py``): one heavy tenant's backlog cannot starve the
   rest. A full queue answers 429.
3. **admission** — the dispatch loop releases the queue head to a backend
   only when one has a free slot AND its KV-pool occupancy is below the
   admit threshold (the signal ``gen/pages.py`` exposes through
   ``/metrics_json``); otherwise the request waits, keeping deep queues
   in the gateway (visible, fair, cancellable) instead of inside engines.

Generation streams back chunk-by-chunk over ``GenAPIClient.
generate_stream``; a weight-update interruption is resumed transparently
(resubmit with accumulated tokens — the partial-rollout protocol reused
for user traffic). The routed server set is LIVE: the autoscaler
(``gateway/autoscaler.py``) grows/shrinks it between requests.

All of the scheduler's state lives on the one event loop that ``start``
runs on: the HTTP frontend (``gateway/api.py``) answers on threads of its
own and hands every call to that loop. A backend that drops or refuses a
stream raises ``base/http.py``'s ``ClientError`` family (the reference
catches aiohttp's, which these mirror).
"""

import asyncio
import dataclasses
import math
import time
import uuid
from typing import AsyncIterator, Dict, List, Optional

from areal_tpu_torch.base import constants, faults, http, logging, tracing
from areal_tpu_torch.base import metrics as metrics_mod
from areal_tpu_torch.gateway.qos import (
    TenantSpec,
    TokenBucket,
    WeightedFairQueue,
    build_buckets,
    request_cost,
)
from areal_tpu_torch.gen.client import DeadlineExceeded, GenAPIClient

logger = logging.getLogger("areal_tpu_torch.gateway.scheduler")


@dataclasses.dataclass
class GatewayRequest:
    """One in-flight API request as the scheduler sees it."""

    rid: str
    tenant: str
    input_ids: List[int]
    sampling_params: Dict
    cost: float = 0.0
    enqueue_t: float = 0.0
    events: asyncio.Queue = dataclasses.field(default_factory=asyncio.Queue)
    cancelled: bool = False
    n_generated: int = 0
    finish_reason: Optional[str] = None
    # deadline propagation: the RELATIVE budget the client/tenant named
    # (0 = none) and the ABSOLUTE expiry ``submit`` stamps on the
    # scheduler clock — queue shedding, dispatch and the per-chunk stream
    # all compare against ``deadline_t``
    deadline_s: float = 0.0
    deadline_t: float = math.inf
    # trace propagation: the wire context captured in the API handler's
    # task (``tracing.wire_context()``). The dispatch loop runs requests
    # in tasks it spawns itself, so the handler's contextvars never reach
    # ``_run_request`` — the context must ride the request object.
    trace: Optional[Dict] = None

    @classmethod
    def build(
        cls,
        tenant: str,
        input_ids: List[int],
        sampling_params: Dict,
        deadline_s: float = 0.0,
    ):
        return cls(
            rid=f"gw-{uuid.uuid4().hex[:16]}",
            tenant=tenant,
            input_ids=list(input_ids),
            sampling_params=dict(sampling_params),
            cost=request_cost(
                len(input_ids), int(sampling_params.get("max_new_tokens", 256))
            ),
            enqueue_t=time.monotonic(),
            deadline_s=max(float(deadline_s), 0.0),
            trace=tracing.wire_context(),
        )


class RateLimited(Exception):
    """``permanent`` marks a request that can NEVER be admitted (cost
    above the tenant's burst capacity) — the API answers 400, not a 429
    that would send the client into an infinite retry loop."""

    def __init__(
        self, reason: str, retry_after_s: float = 1.0,
        permanent: bool = False,
    ):
        super().__init__(reason)
        self.retry_after_s = max(retry_after_s, 0.0)
        self.permanent = permanent


class ServiceUnavailable(Exception):
    """Every routed backend is unreachable/breaker-open: the API answers
    503 + Retry-After (the capacity-poll interval — the gateway's
    re-admission probe cadence) instead of queueing the request behind a
    fleet that may be gone for minutes."""

    def __init__(self, reason: str, retry_after_s: float = 1.0):
        super().__init__(reason)
        self.retry_after_s = max(retry_after_s, 0.0)


@dataclasses.dataclass
class ServerState:
    """The scheduler's capacity view of one backend."""

    url: str
    max_slots: int = 1
    inflight: int = 0
    kv_occupancy: float = 0.0
    healthy: bool = True
    slot_capacity: int = 0  # per-slot token capacity (0 = not polled yet)
    # weight-update pause (polled from /metrics_json): a paused backend
    # is never picked as a HEDGE target — the pause stalls the whole
    # fleet the same way, so a hedge doubles load for zero latency win
    paused: bool = False

    def free_slots(self, admit_occupancy: float) -> int:
        if not self.healthy or self.kv_occupancy >= admit_occupancy:
            return 0
        return max(self.max_slots - self.inflight, 0)


class ContinuousBatchScheduler:
    def __init__(
        self,
        server_urls: List[str],
        tenants: Optional[Dict[str, TenantSpec]] = None,
        *,
        default_tenant: Optional[TenantSpec] = None,
        max_queue: Optional[int] = None,
        admit_occupancy: Optional[float] = None,
        metrics_poll_interval: float = 2.0,
        client: Optional[GenAPIClient] = None,
        clock=time.monotonic,
        hedge_enabled: Optional[bool] = None,
        hedge_min_delay_s: float = 0.25,
        hedge_max_fraction: float = 0.1,
        max_stream_resumes: int = 3,
        deadline_sweep_interval_s: float = 0.25,
    ):
        self.tenants = dict(tenants or {})
        self.default_tenant = default_tenant or TenantSpec(
            name="anonymous",
            rate_tokens_per_s=constants.gateway_rate_tps(),
            burst_tokens=constants.gateway_burst(),
        )
        self.max_queue = (
            max_queue if max_queue is not None else constants.gateway_max_queue()
        )
        self.admit_occupancy = (
            admit_occupancy
            if admit_occupancy is not None
            else constants.gateway_admit_occupancy()
        )
        self.metrics_poll_interval = metrics_poll_interval
        # hedged dispatch (docs/serving.md "Survivability"): re-submit a
        # still-unstarted request to a second healthy backend once the
        # primary stalls past the live ttft p95 (floored at min_delay);
        # per-tenant hedge volume is capped at max_fraction of requests
        self.hedge_enabled = (
            constants.gateway_hedge() if hedge_enabled is None
            else hedge_enabled
        )
        self.hedge_min_delay_s = hedge_min_delay_s
        self.hedge_max_fraction = hedge_max_fraction
        # transparent resume cap when a BACKEND dies mid-stream (the
        # weight-update resubmit protocol generalized to server loss)
        self.max_stream_resumes = max_stream_resumes
        self.deadline_sweep_interval_s = deadline_sweep_interval_s
        # brownout actuation (gateway/brownout.py): submit-side levers the
        # controller flips; plain attributes so tests drive them directly
        self.admit_paused = False
        self.shed_weight_floor = 0.0
        self.brownout_retry_after_s = 30.0
        self._tenant_reqs: Dict[str, int] = {}
        self._tenant_hedges: Dict[str, int] = {}
        self._clock = clock
        self._wfq = WeightedFairQueue()
        self._buckets: Dict[str, TokenBucket] = build_buckets(
            self.tenants, clock=clock
        )
        self._servers: Dict[str, ServerState] = {
            u: ServerState(url=u) for u in server_urls
        }
        # servers removed from routing with requests still draining: their
        # state object (the live inflight count) is restored on re-add so
        # a grow right after a shrink cannot over-commit the engine
        self._retired: Dict[str, ServerState] = {}
        self._client = client
        self._owns_client = client is None
        self._wake = asyncio.Event()
        self._tasks: set = set()
        self._loops: List[asyncio.Task] = []
        self._stopped = False
        # completions since start, by finish reason (metrics_json view)
        self.completed: Dict[str, int] = {}

    # ------------------------------------------------------------------ #
    # lifecycle / live server set
    # ------------------------------------------------------------------ #

    async def start(self):
        if self._client is None:
            self._client = GenAPIClient(timeout=3600.0)
            await self._client.__aenter__()
        loop = asyncio.get_running_loop()
        self._loops = [
            loop.create_task(self._dispatch_loop()),
            loop.create_task(self._poll_loop()),
            loop.create_task(self._deadline_loop()),
        ]
        # one eager capacity poll so the first dispatch sees real slot
        # counts instead of the max_slots=1 placeholder
        await self.poll_capacity()
        return self

    async def stop(self):
        self._stopped = True
        for t in [*self._loops, *self._tasks]:
            t.cancel()
        if self._loops or self._tasks:
            await asyncio.gather(
                *self._loops, *self._tasks, return_exceptions=True
            )
        self._loops = []
        if self._owns_client and self._client is not None:
            await self._client.__aexit__(None, None, None)
            self._client = None

    def set_servers(self, urls: List[str]) -> None:
        """Replace the routed server set (autoscaler hook). In-flight
        requests on removed servers drain naturally — only NEW dispatches
        see the new set; a re-added server resumes its draining state's
        inflight count instead of starting a fresh (over-committing) one."""
        for u in urls:
            if u not in self._servers:
                self._servers[u] = self._retired.pop(u, None) or ServerState(
                    url=u
                )
        for u in list(self._servers):
            if u not in urls:
                s = self._servers.pop(u)
                if s.inflight > 0:
                    self._retired[u] = s
        self._wake.set()

    def server_urls(self) -> List[str]:
        return list(self._servers)

    # ------------------------------------------------------------------ #
    # intake
    # ------------------------------------------------------------------ #

    def _tenant_spec(self, tenant: str) -> TenantSpec:
        spec = self.tenants.get(tenant)
        if spec is None:
            spec = dataclasses.replace(self.default_tenant, name=tenant)
            self.tenants[tenant] = spec
        return spec

    def _bucket(self, tenant: str) -> TokenBucket:
        b = self._buckets.get(tenant)
        if b is None:
            spec = self._tenant_spec(tenant)
            b = TokenBucket(
                spec.rate_tokens_per_s, spec.resolved_burst(), clock=self._clock
            )
            self._buckets[tenant] = b
        return b

    def submit(self, req: GatewayRequest) -> GatewayRequest:
        """Admit a request into the fair queue (raises RateLimited /
        ServiceUnavailable — the API layer counts the rejection once, in
        its error response path)."""
        if self._servers and not any(
            s.healthy for s in self._servers.values()
        ):
            raise ServiceUnavailable(
                "no healthy generation backend (all breakers open)",
                retry_after_s=self.metrics_poll_interval,
            )
        if self.admit_paused:
            raise RateLimited(
                "gateway brownout: not admitting new requests",
                retry_after_s=self.brownout_retry_after_s,
            )
        spec = self._tenant_spec(req.tenant)
        if (
            self.shed_weight_floor > 0
            and spec.weight < self.shed_weight_floor
        ):
            raise RateLimited(
                f"gateway brownout: tenant {req.tenant!r} weight "
                f"{spec.weight:g} below the shed floor "
                f"{self.shed_weight_floor:g}",
                retry_after_s=self.brownout_retry_after_s,
            )
        if len(self._wfq) >= self.max_queue:
            raise RateLimited(
                f"gateway queue full ({self.max_queue} waiting)",
                retry_after_s=self._queue_retry_after_s(),
            )
        bucket = self._bucket(req.tenant)
        if not bucket.unlimited and req.cost > bucket.burst:
            raise RateLimited(
                f"request cost {req.cost:.0f} tokens exceeds tenant "
                f"{req.tenant!r} burst capacity {bucket.burst:.0f} — it "
                "can never be admitted; lower max_tokens",
                permanent=True,
            )
        # arealint: owns(gateway.token-bucket, settled out of line — _run_request's finally refunds cost-minus-consumption, cancel() refunds queued drops, _dispatch_loop refunds the cancel-race pops)
        if not bucket.try_acquire(req.cost):
            raise RateLimited(
                f"tenant {req.tenant!r} over its token rate limit",
                retry_after_s=bucket.retry_after_s(req.cost),
            )
        # deadline: client-named budget, else the tenant default, else the
        # fleet-wide env default; stamped absolute on the scheduler clock
        dl = req.deadline_s
        if dl <= 0:
            dl = spec.default_deadline_s
        if dl <= 0:
            dl = constants.gateway_deadline_s()
        if dl > 0:
            req.deadline_s = dl
            req.deadline_t = self._clock() + dl
        self._tenant_reqs[req.tenant] = (
            self._tenant_reqs.get(req.tenant, 0) + 1
        )
        req.enqueue_t = self._clock()
        # arealint: owns(gateway.wfq, drained by _dispatch_loop's pop; cancel() drops queued entries with the clock rollback)
        self._wfq.push(req.tenant, req.cost, spec.weight, req)
        metrics_mod.counters.add(metrics_mod.GW_REQUESTS)
        self._wake.set()
        return req

    def cancel(self, req: GatewayRequest) -> None:
        """Client went away: drop from the queue if still queued (the
        dispatch path checks ``cancelled`` before and during streaming).
        The full-cost refund applies only to still-queued requests — a
        running one settles its real consumption in ``_run_request``'s
        finally (refunding here too would double-credit the bucket)."""
        req.cancelled = True
        if self._wfq.drop_where(lambda it: it is req):
            self._bucket(req.tenant).refund(req.cost)

    def queue_depth(self) -> int:
        return len(self._wfq)

    def inflight(self) -> int:
        return sum(s.inflight for s in self._servers.values())

    # ------------------------------------------------------------------ #
    # capacity view
    # ------------------------------------------------------------------ #

    async def poll_capacity(self):
        """Refresh every backend's slot count + KV occupancy (the
        admission signals) from /metrics_json; unreachable servers are
        marked unhealthy until the next successful poll."""
        servers = list(self._servers.values())
        if not servers:
            return
        results = await asyncio.gather(
            *(self._client.metrics(s.url) for s in servers),
            return_exceptions=True,
        )
        for s, r in zip(servers, results):
            if isinstance(r, BaseException):
                s.healthy = False
                continue
            s.healthy = True
            s.max_slots = int(r.get("max_slots", s.max_slots) or 1)
            # DEMAND occupancy (excludes evictable prefix-cache pages):
            # gating on raw occupancy livelocks against a cache-warm but
            # otherwise idle server (falls back for older backends)
            s.kv_occupancy = float(
                r.get(
                    "kv_pool_demand_occupancy",
                    r.get("kv_pool_occupancy", 0.0),
                )
            )
            s.slot_capacity = int(r.get("slot_capacity", s.slot_capacity))
            s.paused = bool(r.get("paused", False))
        self._wake.set()

    def min_slot_capacity(self) -> int:
        """Smallest per-slot token capacity across polled backends (0 =
        none polled yet) — the gateway's prompt-size validation bound."""
        caps = [s.slot_capacity for s in self._servers.values()
                if s.slot_capacity > 0]
        return min(caps) if caps else 0

    async def _poll_loop(self):
        while not self._stopped:
            await asyncio.sleep(self.metrics_poll_interval)
            try:
                await self.poll_capacity()
            except asyncio.CancelledError:
                raise
            except Exception:
                logger.exception("gateway capacity poll failed")

    def _pick_server(self) -> Optional[ServerState]:
        if faults.maybe_trip("gw.deadline_storm"):
            # scripted storm (tools/chaos.py --serve): report zero
            # dispatch capacity so queued requests age out in the fair
            # queue against their deadlines
            return None
        best, best_free = None, 0
        for s in self._servers.values():
            free = s.free_slots(self.admit_occupancy)
            if free > best_free:
                best, best_free = s, free
        return best

    def _hedge_candidate(self, exclude: ServerState) -> Optional[ServerState]:
        """A second backend for a hedge stream: healthy, not the primary,
        not weight-update-paused, with a free slot."""
        best, best_free = None, 0
        for s in self._servers.values():
            if s is exclude or s.paused:
                continue
            free = s.free_slots(self.admit_occupancy)
            if free > best_free:
                best, best_free = s, free
        return best

    # ------------------------------------------------------------------ #
    # live latency estimates (deadline shedding + hedge delay)
    # ------------------------------------------------------------------ #

    def _ttft_p95_s(self) -> float:
        """Live enqueue->first-token p95 (0 when nothing observed yet)."""
        h = metrics_mod.counters.histogram(metrics_mod.GW_TTFT_S)
        if h is None or h.count == 0:
            return 0.0
        return float(h.percentile(95.0))

    def _hedge_delay_s(self) -> float:
        return max(self.hedge_min_delay_s, self._ttft_p95_s())

    def _queue_retry_after_s(self) -> float:
        """Queue-full 429 hint: the live queue-wait p95 (how long the
        queue actually takes to drain to dispatch), clamped to [1, 60] —
        an honest estimate instead of a fixed constant."""
        h = metrics_mod.counters.histogram(metrics_mod.GW_QUEUE_WAIT_S)
        if h is None or h.count == 0:
            return 1.0
        return min(max(float(h.percentile(95.0)), 1.0), 60.0)

    def _hedge_allowed(self, req: GatewayRequest) -> bool:
        if not self.hedge_enabled:
            return False
        hedges = self._tenant_hedges.get(req.tenant, 0)
        reqs = self._tenant_reqs.get(req.tenant, 0)
        return hedges < self.hedge_max_fraction * reqs + 1.0

    # ------------------------------------------------------------------ #
    # deadline shedding
    # ------------------------------------------------------------------ #

    def sweep_deadlines(self) -> int:
        """Shed queued requests whose remaining budget can no longer cover
        estimated service (the live ttft p95): the entry never dispatches,
        its charge is refunded, the fair-queue virtual clock rolls back
        (``drop_where``), and the waiting handler gets a final deadline
        event. Returns how many were shed."""
        now = self._clock()
        est = self._ttft_p95_s()
        victims: List[GatewayRequest] = []

        def expired(it) -> bool:
            if now + est >= it.deadline_t:
                victims.append(it)
                return True
            return False

        self._wfq.drop_where(expired)
        for req in victims:
            self._settle_queue_shed(req, rolled_back=True)
        return len(victims)

    def _settle_queue_shed(
        self, req: GatewayRequest, *, rolled_back: bool
    ) -> None:
        """Settle a deadline-shed QUEUED request: full refund (nothing
        ran), fair-clock rollback unless ``drop_where`` already did it,
        counter + final event for the waiting handler."""
        self._bucket(req.tenant).refund(req.cost)
        if not rolled_back:
            self._wfq.rollback(
                req.tenant, req.cost, self._tenant_spec(req.tenant).weight
            )
        req.finish_reason = "deadline"
        metrics_mod.counters.add(metrics_mod.GW_DEADLINE_SHED)
        self.completed["deadline"] = self.completed.get("deadline", 0) + 1
        req.events.put_nowait(
            {"error": "deadline expired before dispatch",
             "finish_reason": "deadline"}
        )

    async def _deadline_loop(self):
        while not self._stopped:
            await asyncio.sleep(self.deadline_sweep_interval_s)
            try:
                if len(self._wfq) and self.sweep_deadlines():
                    self._wake.set()
            except asyncio.CancelledError:
                raise
            except Exception:
                logger.exception("gateway deadline sweep failed")

    # ------------------------------------------------------------------ #
    # dispatch
    # ------------------------------------------------------------------ #

    async def _dispatch_loop(self):
        while not self._stopped:
            await self._wake.wait()
            self._wake.clear()
            while len(self._wfq):
                srv = self._pick_server()
                if srv is None:
                    break  # a completion or capacity poll re-wakes us
                req = self._wfq.pop()
                if req is None:
                    continue
                if req.cancelled:
                    # cancel() raced the pop: its drop_where missed the
                    # request (no longer queued) and no _run_request will
                    # ever settle the charge — refund the full budget
                    # here or the tenant's bucket leaks one request cost
                    # per cancel-while-dispatching race. The fair-queue
                    # virtual clock rolls back too: pop() advanced the
                    # tenant's stamp for work that never ran
                    self._bucket(req.tenant).refund(req.cost)
                    self._wfq.rollback(
                        req.tenant, req.cost,
                        self._tenant_spec(req.tenant).weight,
                    )
                    continue
                if req.deadline_t <= self._clock():
                    # expired between sweep ticks: same settle as the
                    # cancel race above — the pop advanced the fair clock
                    # for work that never dispatches
                    self._settle_queue_shed(req, rolled_back=False)
                    continue
                self._acquire_server(srv)
                t = asyncio.get_running_loop().create_task(
                    self._run_request(req, srv)
                )
                self._tasks.add(t)
                t.add_done_callback(self._tasks.discard)

    def _acquire_server(self, srv: ServerState) -> None:
        srv.inflight += 1

    def _release_server(self, srv: ServerState) -> None:
        srv.inflight = max(srv.inflight - 1, 0)
        if srv.inflight == 0 and self._retired.get(srv.url) is srv:
            del self._retired[srv.url]  # fully drained
        self._wake.set()

    async def _run_request(self, req: GatewayRequest, srv: ServerState):
        # re-activate the wire context the API handler captured onto the
        # request (this task belongs to the dispatch loop, not the
        # handler), so the GenAPIClient hops downstream re-propagate it
        with tracing.activate(req.trace), tracing.span(
            "gw/dispatch", rid=req.rid, tenant=req.tenant
        ) as span_attrs:
            try:
                await self._stream_request(req, srv)
            finally:
                span_attrs["finish"] = req.finish_reason
                span_attrs["tokens"] = req.n_generated

    async def _stream_request(self, req: GatewayRequest, srv: ServerState):
        wait_s = self._clock() - req.enqueue_t
        metrics_mod.counters.add(metrics_mod.GW_ADMITTED)
        metrics_mod.counters.observe(metrics_mod.GW_QUEUE_WAIT_S, wait_s)
        first_token = True
        # the bound server can change mid-request (a hedge win, a resume
        # after backend death): the box keeps the finally settling against
        # the CURRENT binding, never a stale one
        srv_box: List[ServerState] = [srv]
        resumes = 0
        dispatches = 0
        try:
            # transparent resume across weight-update interruptions AND
            # backend death: resubmit prompt+partial with the remaining
            # budget (partial-rollout protocol)
            ids = list(req.input_ids)
            sp = dict(req.sampling_params)
            budget = int(sp.get("max_new_tokens", 256))
            while True:
                finish = None
                died: Optional[BaseException] = None
                deadline_s = None
                if req.deadline_t != math.inf:
                    deadline_s = req.deadline_t - self._clock()
                    if deadline_s <= 0:
                        # expired before this (re)dispatch reached a backend
                        req.finish_reason = "deadline"
                        metrics_mod.counters.add(
                            metrics_mod.GW_DEADLINE_SHED
                        )
                        await req.events.put(
                            {"token_ids": [], "logprobs": [],
                             "finish_reason": "deadline"}
                        )
                        break
                agen = self._hedged_stream(
                    req, srv_box, ids, sp, deadline_s,
                    allow_hedge=dispatches == 0 and req.n_generated == 0,
                )
                dispatches += 1
                try:
                    async for ev in agen:
                        toks = ev.get("token_ids", [])
                        if toks and first_token:
                            first_token = False
                            metrics_mod.counters.observe(
                                metrics_mod.GW_TTFT_S,
                                self._clock() - req.enqueue_t,
                            )
                        req.n_generated += len(toks)
                        ids.extend(toks)
                        finish = ev.get("finish_reason")
                        if req.cancelled:
                            await agen.aclose()  # closes the HTTP stream;
                            # the gen server's disconnect path frees the slot
                            finish = "cancelled"
                            break
                        if not finish and req.deadline_t < self._clock():
                            # budget ran out mid-stream: forward the delta
                            # with a deadline finish; closing the stream
                            # cancels the engine slot (disconnect path)
                            await agen.aclose()
                            finish = "deadline"
                            await req.events.put(
                                {**ev, "finish_reason": "deadline"}
                            )
                            break
                        if finish == "interrupted":
                            # weight update paused the fleet mid-request:
                            # keep the delta, strip the finish — the client
                            # sees one seamless stream across the resubmit
                            if toks:
                                await req.events.put(
                                    {**ev, "finish_reason": None}
                                )
                        elif toks or finish:
                            await req.events.put(ev)
                except DeadlineExceeded:
                    # budget expired during connect backoff: the request
                    # never reached this backend's engine
                    finish = "deadline"
                    await req.events.put(
                        {"token_ids": [], "logprobs": [],
                         "finish_reason": "deadline"}
                    )
                except (
                    http.ClientError, ConnectionError,
                    asyncio.TimeoutError,
                ) as e:
                    died = e  # backend dropped the stream pre-completion
                if finish == "deadline":
                    metrics_mod.counters.add(metrics_mod.GW_DEADLINE_SHED)
                    req.finish_reason = "deadline"
                    break
                if finish is None and not req.cancelled:
                    # stream died without a final frame: backend loss. The
                    # weight-update resume generalized to server death —
                    # resubmit prompt+partial on a surviving server so the
                    # client sees one seamless (token-exact) stream.
                    cur = srv_box[0]
                    cur.healthy = False  # next successful poll restores it
                    remaining = budget - req.n_generated
                    if remaining <= 0:
                        req.finish_reason = "length"
                        await req.events.put(
                            {"token_ids": [], "logprobs": [],
                             "finish_reason": "length"}
                        )
                        break
                    alt = self._pick_server()
                    if alt is None or resumes >= self.max_stream_resumes:
                        req.finish_reason = "error"
                        await req.events.put(
                            {"error": "stream ended early"
                                      + (f" ({died!r})" if died else ""),
                             "finish_reason": "error"}
                        )
                        break
                    resumes += 1
                    metrics_mod.counters.add(metrics_mod.GW_STREAM_RESUMES)
                    logger.warning(
                        "request %s: backend %s died mid-stream; resuming "
                        "on %s (%d tokens in)",
                        req.rid, cur.url, alt.url, req.n_generated,
                    )
                    self._release_server(cur)
                    self._acquire_server(alt)
                    srv_box[0] = alt
                    sp["max_new_tokens"] = remaining
                    continue
                if finish != "interrupted":
                    req.finish_reason = finish or "error"
                    break
                remaining = budget - req.n_generated
                if remaining <= 0:
                    req.finish_reason = "length"
                    await req.events.put(
                        {"token_ids": [], "logprobs": [],
                         "finish_reason": "length"}
                    )
                    break
                metrics_mod.counters.add(metrics_mod.GW_RESUBMITS)
                sp["max_new_tokens"] = remaining
        except asyncio.CancelledError:
            # scheduler shutdown with traffic in flight: a handler blocked
            # in events() must still wake (best-effort, never blocks)
            req.finish_reason = "cancelled"
            req.events.put_nowait(
                {"error": "request cancelled", "finish_reason": "cancelled"}
            )
            raise
        except Exception as e:
            logger.exception("gateway request %s failed", req.rid)
            req.finish_reason = "error"
            await req.events.put(
                {"error": repr(e), "finish_reason": "error"}
            )
        finally:
            self._release_server(srv_box[0])
            # refund the unused token budget; charge what actually ran
            used = len(req.input_ids) + req.n_generated
            self._bucket(req.tenant).refund(max(req.cost - used, 0.0))
            metrics_mod.counters.add(metrics_mod.GW_COMPLETED)
            metrics_mod.counters.add(
                metrics_mod.GW_STREAMED_TOKENS, req.n_generated
            )
            metrics_mod.counters.add(
                metrics_mod.GW_TENANT_TOKENS_PREFIX + req.tenant, used
            )
            reason = req.finish_reason or "error"
            self.completed[reason] = self.completed.get(reason, 0) + 1
            self._wake.set()

    # ------------------------------------------------------------------ #
    # hedged dispatch
    # ------------------------------------------------------------------ #

    async def _hedged_stream(
        self,
        req: GatewayRequest,
        srv_box: List[ServerState],
        ids: List[int],
        sp: Dict,
        deadline_s: Optional[float],
        allow_hedge: bool,
    ):
        """One dispatch attempt's frame stream, with hedging: when the
        primary's first chunk stalls past the live ttft p95, a second
        healthy backend gets the same request and the first backend to
        produce a chunk wins — the loser's stream is closed (its rid
        cancels through the gen server's disconnect path) and its slot
        hold released. ``srv_box`` is rebound to the winning server so the
        caller's finally settles against the right backend. Hedging only
        applies pre-first-chunk on the first dispatch, and never against a
        weight-update pause (a pause stalls every backend identically)."""
        srv = srv_box[0]
        inner = self._client.generate_stream(
            srv.url, f"{req.rid}-c{req.n_generated}", ids, sp,
            deadline_s=deadline_s,
        )
        first_ev = None
        if allow_hedge and self.hedge_enabled and not srv.paused:
            inner, first_ev = await self._race_hedge(
                req, srv_box, ids, sp, deadline_s, inner
            )
        try:
            if first_ev is not None:
                yield first_ev
            async for ev in inner:
                yield ev
        finally:
            await inner.aclose()

    async def _race_hedge(
        self, req, srv_box, ids, sp, deadline_s, agen,
    ):
        """Race the primary stream's first frame against the hedge delay;
        returns ``(winning stream, its first frame or None)``. When a
        hedge was opened, the losing stream is cancelled and its server
        hold released; when every attempt died pre-first-frame, the
        primary's error propagates (the caller's resume path owns it)."""
        srv = srv_box[0]
        loop = asyncio.get_running_loop()
        first = loop.create_task(agen.__anext__())
        await asyncio.wait({first}, timeout=self._hedge_delay_s())
        hsrv = None
        if not first.done() and self._hedge_allowed(req):
            hsrv = self._hedge_candidate(exclude=srv)
        if hsrv is None:
            try:
                return agen, await first
            except StopAsyncIteration:
                return agen, None
        self._tenant_hedges[req.tenant] = (
            self._tenant_hedges.get(req.tenant, 0) + 1
        )
        metrics_mod.counters.add(metrics_mod.GW_HEDGES)
        self._acquire_server(hsrv)
        hgen = self._client.generate_stream(
            hsrv.url, f"{req.rid}-h{req.n_generated}", ids, sp,
            deadline_s=deadline_s,
        )
        hfirst = loop.create_task(hgen.__anext__())

        def ok(t):
            return t.done() and not t.cancelled() and t.exception() is None

        def dead(t):
            return (
                t.done() and not t.cancelled()
                and t.exception() is not None
            )

        try:
            while not (
                ok(first) or ok(hfirst) or (dead(first) and dead(hfirst))
            ):
                await asyncio.wait(
                    {t for t in (first, hfirst) if not t.done()},
                    return_when=asyncio.FIRST_COMPLETED,
                )
        except asyncio.CancelledError:
            for t in (first, hfirst):
                t.cancel()
            await asyncio.gather(first, hfirst, return_exceptions=True)
            await asyncio.gather(
                agen.aclose(), hgen.aclose(), return_exceptions=True
            )
            self._release_server(hsrv)
            raise
        if ok(first) or dead(hfirst):
            # prefer the primary on a tie; both-dead also lands here so
            # the hedge side settles below and the primary's error/EOF
            # propagates to the caller
            win_t, win_gen, win_srv = first, agen, srv
            lose_t, lose_gen, lose_srv = hfirst, hgen, hsrv
        else:
            win_t, win_gen, win_srv = hfirst, hgen, hsrv
            lose_t, lose_gen, lose_srv = first, agen, srv
            metrics_mod.counters.add(metrics_mod.GW_HEDGE_WINS)
        lose_t.cancel()
        await asyncio.gather(lose_t, return_exceptions=True)
        await lose_gen.aclose()
        self._release_server(lose_srv)
        srv_box[0] = win_srv
        try:
            return win_gen, win_t.result()
        except StopAsyncIteration:
            return win_gen, None

    # ------------------------------------------------------------------ #
    # consumption
    # ------------------------------------------------------------------ #

    async def events(self, req: GatewayRequest) -> AsyncIterator[Dict]:
        """Yield the request's event frames until the final one."""
        while True:
            ev = await req.events.get()
            yield ev
            if ev.get("finish_reason"):
                return

    def metrics_dict(self) -> Dict:
        return {
            "queue_depth": self.queue_depth(),
            "inflight": self.inflight(),
            "servers": {
                u: {
                    "max_slots": s.max_slots,
                    "inflight": s.inflight,
                    "kv_occupancy": round(s.kv_occupancy, 4),
                    "healthy": s.healthy,
                    "paused": s.paused,
                }
                for u, s in self._servers.items()
            },
            "completed": dict(self.completed),
            "tenants": sorted(self.tenants),
            "admit_paused": self.admit_paused,
            "shed_weight_floor": self.shed_weight_floor,
            "hedge_enabled": self.hedge_enabled,
        }
