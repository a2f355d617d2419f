"""The port's serving gateway (``areal_tpu_torch/gateway/``) against the
reference's (``areal_tpu/gateway/``) on the same inputs:

- ``qos``: the same sequences of bucket and fair-queue operations, under
  one injected clock, give the same results and the same order (exact);
- ``autoscaler.decide``, ``brownout.decide`` and
  ``ScaleSignals.from_fleet_scalars`` over a grid of signals (exact), and
  the two controllers' cooldown / dwell scripts;
- both schedulers driven through the same scripts with stub gen clients
  (cancel races, deadlines, the ``gw.deadline_storm`` fault point,
  hedges, breakers, queue-full hints, connect retries), compared
  observation by observation;
- end to end: the reference's stack (JAX engine, aiohttp gen server and
  gateway) and the port's (torch engine on the CPU, ``base/http.py`` gen
  server and gateway) answer the same requests with the same status
  codes, error bodies and greedy tokens, buffered, streamed and chat;
- ``gateway_main`` in a launcher world on the CPU: a completion through
  the address published under ``names.gateway``, the gateway's tenant
  traffic in the manager's fleet view, an autoscaler shrink reaching the
  manager's ``/remove_server``.

Each of the reference's tests in ``tests/test_gateway.py`` has a
counterpart here, by name or as a case.
"""

import asyncio
import dataclasses
import itertools
import json
import os
import pathlib
import random
import signal
import socket
import subprocess
import sys
import threading
import time
import types
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest
import torch

from areal_tpu.base import faults as ref_faults
from areal_tpu.base import metrics as ref_metrics
from areal_tpu.base import network
from areal_tpu.gateway import api as ref_api
from areal_tpu.gateway import autoscaler as ref_autoscaler
from areal_tpu.gateway import brownout as ref_brownout
from areal_tpu.gateway import qos as ref_qos
from areal_tpu.gateway import scheduler as ref_scheduler
from areal_tpu.gen import client as ref_client
from areal_tpu.gen import engine as ref_engine
from areal_tpu.gen import server as ref_server
from areal_tpu.models import transformer as ref_tfm
from areal_tpu.models.config import ModelConfig as RefConfig
from areal_tpu_torch.base import faults as pt_faults
from areal_tpu_torch.base import metrics as pt_metrics
from areal_tpu_torch.gateway import api as pt_api
from areal_tpu_torch.gateway import autoscaler as pt_autoscaler
from areal_tpu_torch.gateway import brownout as pt_brownout
from areal_tpu_torch.gateway import qos as pt_qos
from areal_tpu_torch.gateway import scheduler as pt_scheduler
from areal_tpu_torch.gen import client as pt_client
from areal_tpu_torch.gen import engine as pt_engine
from areal_tpu_torch.gen import server as pt_server
from areal_tpu_torch.models import transformer as pt_tfm
from areal_tpu_torch.models.config import ModelConfig as PtConfig

REPO = pathlib.Path(__file__).resolve().parents[1]

REF = types.SimpleNamespace(
    qos=ref_qos, scheduler=ref_scheduler, autoscaler=ref_autoscaler,
    brownout=ref_brownout, metrics=ref_metrics, client=ref_client,
    faults=ref_faults)
PORT = types.SimpleNamespace(
    qos=pt_qos, scheduler=pt_scheduler, autoscaler=pt_autoscaler,
    brownout=pt_brownout, metrics=pt_metrics, client=pt_client,
    faults=pt_faults)

CFG_KW = dict(n_layers=2, n_q_heads=4, n_kv_heads=2, head_dim=8,
              hidden_dim=32, intermediate_dim=64, vocab_size=128,
              dtype="float32")
PROMPT = [3, 17, 42, 99, 5]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _both(script, *args):
    """``script(pkg, *args)`` for the reference and the port: (ref, port)."""
    return script(REF, *args), script(PORT, *args)


def _both_async(script, *args):
    return (asyncio.run(script(REF, *args)), asyncio.run(script(PORT, *args)))


# --------------------------------------------------------------------- #
# qos
# --------------------------------------------------------------------- #


def _bucket_random(pkg, seed):
    rng = random.Random(seed)
    t = {"now": 0.0}
    b = pkg.qos.TokenBucket(rng.choice([0.0, 3.0, 10.0]),
                            rng.choice([0.0, 20.0, 50.0]),
                            clock=lambda: t["now"])
    out = []
    for _ in range(200):
        op = rng.choice(["acquire", "refund", "retry", "avail", "tick"])
        if op == "acquire":
            out.append(b.try_acquire(rng.uniform(0, 30)))
        elif op == "refund":
            b.refund(rng.uniform(-5, 20))
        elif op == "retry":
            out.append(b.retry_after_s(rng.uniform(0, 60)))
        elif op == "avail":
            out.append(b.available)
        else:
            t["now"] += rng.uniform(0, 2)
    return out


def _token_bucket_refill_and_refund(pkg, _):
    """The reference's ``test_token_bucket_refill_and_refund`` script."""
    t = {"now": 0.0}
    b = pkg.qos.TokenBucket(10.0, 20.0, clock=lambda: t["now"])
    out = [b.try_acquire(20.0), b.try_acquire(1.0), b.retry_after_s(1.0)]
    t["now"] = 1.0
    out.append(b.try_acquire(10.0))
    b.refund(5.0)
    out += [b.try_acquire(5.0), pkg.qos.TokenBucket(0.0, 0.0).try_acquire(
        1e12)]
    assert out[:2] == [True, False] and out[2] == pytest.approx(0.1)
    return out


def _wfq_state(q):
    return (len(q), dict(q._last_vft), q._vtime,
            {t: list(d) for t, d in q._queues.items()})


def _wfq_random(pkg, seed):
    rng = random.Random(seed)
    q = pkg.qos.WeightedFairQueue()
    weights = {"a": 1.0, "b": 3.0, "c": 0.5}
    out, n = [], 0
    for _ in range(300):
        op = rng.choices(["push", "pop", "rollback", "drop"], [5, 3, 1, 1])[0]
        if op == "push":
            tenant = rng.choice("abc")
            q.push(tenant, rng.choice([0.5, 10.0, 100.0, 250.0]),
                   weights[tenant], (tenant, n))
            n += 1
        elif op == "pop":
            out.append(q.pop())
        elif op == "rollback":
            q.rollback(rng.choice("abc"), rng.choice([10.0, 100.0]), 1.0)
        else:
            k = rng.randrange(3)
            out.append(q.drop_where(lambda it: it[1] % 3 == k))
        out.append(_wfq_state(q))
    return out


def _wfq_drop_rolls_back_virtual_clock(pkg, _):
    q = pkg.qos.WeightedFairQueue()
    for i in range(10):
        q.push("a", 100.0, 1.0, ("a", i))
    q.push("b", 150.0, 1.0, ("b", 0))
    q.drop_where(lambda it: it[0] == "a")
    q.push("a", 100.0, 1.0, ("a", "fresh"))
    got = q.pop()
    assert got == ("a", "fresh")
    return [got, _wfq_state(q)]


def _wfq_rollback_after_pop(pkg, _):
    q = pkg.qos.WeightedFairQueue()
    q.push("a", 100.0, 1.0, ("a", 0))
    q.push("a", 100.0, 1.0, ("a", 1))
    out = [q.pop()]
    q.rollback("a", 100.0, 1.0)
    out.append(_wfq_state(q))
    assert q._last_vft["a"] == pytest.approx(100.0)
    out.append(q.pop())
    return out


def _fair_queue_starvation_free(pkg, _):
    q = pkg.qos.WeightedFairQueue()
    for i in range(50):
        q.push("heavy", 100.0, 1.0, ("heavy", i))
    q.push("light", 100.0, 1.0, ("light", 0))
    first_two = [q.pop() for _ in range(2)]
    assert ("light", 0) in first_two
    q = pkg.qos.WeightedFairQueue()
    for i in range(30):
        q.push("w1", 10.0, 1.0, ("w1", i))
        q.push("w3", 10.0, 3.0, ("w3", i))
    head = [q.pop()[0] for _ in range(20)]
    assert head.count("w3") >= 2 * head.count("w1")
    return first_two + head


QOS_SCRIPTS = {
    "bucket_random": _bucket_random,
    "token_bucket_refill_and_refund": _token_bucket_refill_and_refund,
    "wfq_random": _wfq_random,
    "wfq_drop_rolls_back_virtual_clock": _wfq_drop_rolls_back_virtual_clock,
    "wfq_rollback_after_pop": _wfq_rollback_after_pop,
    "fair_queue_starvation_free": _fair_queue_starvation_free,
}


@pytest.mark.parametrize("name,seed", [
    ("bucket_random", s) for s in range(4)] + [
    ("wfq_random", s) for s in range(4)] + [
    (n, 0) for n in QOS_SCRIPTS if not n.endswith("_random")])
def test_qos_matches_the_reference(name, seed):
    ref, port = _both(QOS_SCRIPTS[name], seed)
    assert port == ref


def test_build_buckets_and_request_cost_match_the_reference():
    def script(pkg, _):
        spec = pkg.qos.TenantSpec
        tenants = {"a": spec("a", rate_tokens_per_s=5.0),
                   "b": spec("b", rate_tokens_per_s=2.0, burst_tokens=7.0),
                   "c": spec("c")}
        buckets = pkg.qos.build_buckets(tenants, clock=lambda: 0.0)
        return ({n: (b.rate, b.burst, b.unlimited) for n, b in buckets.items()},
                [s.resolved_burst() for s in tenants.values()],
                pkg.qos.request_cost(17, 64))

    ref, port = _both(script, 0)
    assert port == ref


# --------------------------------------------------------------------- #
# decision tables
# --------------------------------------------------------------------- #


def _signal_grid(pkg):
    for routed, opened, qd, kv, wait in itertools.product(
            (1, 2, 4, 8), (0, 1, 3), (0.0, 0.5, 8.0, 17.0, 40.0, 100.0),
            (0.1, 0.5, 0.8, 0.86, 0.9, 0.91, 0.96, 0.98, 0.995),
            (0.0, 3.0, 6.0, 16.0, 31.0, 61.0)):
        yield pkg.autoscaler.ScaleSignals(
            routed=routed, healthy=max(routed - opened, 0), queue_depth=qd,
            kv_occupancy=kv, queue_wait_p95_s=wait,
            breaker_open=min(opened, routed))


def _autoscaler_decisions(pkg, _):
    out = []
    for cfg in (pkg.autoscaler.AutoscalerConfig(min_servers=2, max_servers=8),
                pkg.autoscaler.AutoscalerConfig()):
        for sig in _signal_grid(pkg):
            d = pkg.autoscaler.decide(cfg, sig)
            out.append((d.action, d.delta, tuple(d.reasons)))
    return out


def _autoscaler_decision_table(pkg, _):
    """The reference's ``test_autoscaler_decision_table`` cases."""
    def sig(**kw):
        base = dict(routed=4, healthy=4, queue_depth=0.0, kv_occupancy=0.1,
                    queue_wait_p95_s=0.0, breaker_open=0)
        base.update(kw)
        return pkg.autoscaler.ScaleSignals(**base)

    cfg = pkg.autoscaler.AutoscalerConfig(min_servers=2, max_servers=8)
    cases = [(sig(routed=1, healthy=1), "grow", 1),
             (sig(healthy=3, breaker_open=1), "grow", 1),
             (sig(queue_depth=40.0), "grow", 2),
             (sig(queue_depth=17.0), "grow", 1),
             (sig(kv_occupancy=0.9), "grow", 1),
             (sig(queue_wait_p95_s=30.0), "grow", 1),
             (sig(), "shrink", 1), (sig(routed=2, healthy=2), "hold", 0),
             (sig(queue_depth=8.0), "hold", 0),
             (sig(routed=8, healthy=8, queue_depth=100.0), "hold", 0)]
    out = []
    for s, action, delta in cases:
        d = pkg.autoscaler.decide(cfg, s)
        assert d.action == action and (action == "hold" or d.delta == delta)
        out.append((d.action, d.delta, tuple(d.reasons)))
    return out


def _brownout_decisions(pkg, _):
    cfg = pkg.brownout.BrownoutConfig()
    return [pkg.brownout.decide(cfg, sig, cur)
            for sig in _signal_grid(pkg) for cur in range(5)]


def _brownout_decide_table(pkg, _):
    """The reference's ``test_brownout_decide_table`` cases."""
    cfg = pkg.brownout.BrownoutConfig()

    def sig(**kw):
        return pkg.autoscaler.ScaleSignals(routed=4, healthy=4, **kw)

    got = [pkg.brownout.decide(cfg, s, cur) for s, cur in (
        (sig(), 0), (sig(kv_occupancy=0.91), 0),
        (sig(queue_wait_p95_s=16.0), 0), (sig(breaker_open=3), 0),
        (sig(kv_occupancy=0.995), 0), (sig(kv_occupancy=0.995), 2),
        (sig(kv_occupancy=0.80), 1), (sig(kv_occupancy=0.50), 1),
        (sig(), 4))]
    assert got == [0, 1, 2, 3, 4, 4, 1, 0, 3]
    return got


def _signals_from_fleet_scalars(pkg, seed):
    rng = random.Random(seed)
    keys = ("gw_queue_depth", "kv_pool_occupancy", "kv_pool_demand_occupancy",
            "gw/queue_wait_s/p95", "servers_total", "servers_open",
            "servers_half_open")
    out = []
    for _ in range(200):
        scalars = {k: float(rng.choice([0, 1, 2, 3.5, 12])) for k in keys
                   if rng.random() < 0.7}
        routed = rng.randint(0, 6)
        n_gen = rng.choice([None, 1, 3])
        sig = pkg.autoscaler.ScaleSignals.from_fleet_scalars(
            scalars, routed=routed, n_gen_servers=n_gen)
        out.append(dataclasses.astuple(sig))
    # the reference's test_autoscaler_signals_from_fleet_scalars case
    sig = pkg.autoscaler.ScaleSignals.from_fleet_scalars({
        "gw_queue_depth": 12.0, "kv_pool_occupancy": 1.8,
        "gw/queue_wait_s/p95": 3.5, "servers_total": 2.0,
        "servers_open": 1.0, "servers_half_open": 0.0}, routed=2)
    assert sig.kv_occupancy == pytest.approx(0.9) and sig.healthy == 1
    out.append(dataclasses.astuple(sig))
    return out


DECIDE_SCRIPTS = {
    "autoscaler_grid": _autoscaler_decisions,
    "autoscaler_decision_table": _autoscaler_decision_table,
    "brownout_grid": _brownout_decisions,
    "brownout_decide_table": _brownout_decide_table,
    "autoscaler_signals_from_fleet_scalars": _signals_from_fleet_scalars,
}


@pytest.mark.parametrize("name", list(DECIDE_SCRIPTS))
def test_decisions_match_the_reference(name):
    ref, port = _both(DECIDE_SCRIPTS[name], 0)
    assert len(port) > 0 and port == ref


def _autoscaler_cooldown_and_callbacks(pkg, _):
    t = {"now": 0.0}
    sig = {"cur": pkg.autoscaler.ScaleSignals(
        routed=4, healthy=4, queue_depth=100.0, kv_occupancy=0.1)}
    grown, shrunk = [], []
    c = pkg.metrics.counters
    c0 = (c.get(pkg.metrics.GW_SCALE_UPS), c.get(pkg.metrics.GW_SCALE_DOWNS))
    asc = pkg.autoscaler.Autoscaler(
        pkg.autoscaler.AutoscalerConfig(min_servers=1, max_servers=8,
                                        cooldown_s=30.0),
        fetch_signals=lambda: sig["cur"],
        grow_cb=lambda n: grown.append(n) or n,
        shrink_cb=lambda n: shrunk.append(n) or n,
        clock=lambda: t["now"],
    )
    out = [asc.step_once()]
    t["now"] = 10.0
    out.append(asc.step_once())
    t["now"] = 40.0
    sig["cur"] = pkg.autoscaler.ScaleSignals(routed=4, healthy=4,
                                             kv_occupancy=0.1)
    out.append(asc.step_once())
    assert [d.action for d in out] == ["grow", "hold", "shrink"]
    return ([dataclasses.astuple(d) for d in out], grown, shrunk,
            c.get(pkg.metrics.GW_SCALE_UPS) - c0[0],
            c.get(pkg.metrics.GW_SCALE_DOWNS) - c0[1])


async def _brownout_controller_dwell_and_levers(pkg):
    calls = {"clamp": [], "spec": [], "shed": [], "pause": []}
    t = {"now": 0.0}
    S = pkg.autoscaler.ScaleSignals
    sig = {"s": S(routed=2, healthy=2)}

    async def spec_cb(enabled):
        calls["spec"].append(enabled)

    cfg = pkg.brownout.BrownoutConfig(min_hold_s=10.0, interval_s=1.0)
    ctrl = pkg.brownout.BrownoutController(
        cfg, lambda: sig["s"], lambda v: calls["clamp"].append(v), spec_cb,
        lambda floor, ra: calls["shed"].append((floor, ra)),
        lambda paused, ra: calls["pause"].append((paused, ra)),
        clock=lambda: t["now"],
    )
    levels = []
    for now, s in ((0.0, S(routed=2, healthy=2, kv_occupancy=0.96)),
                   (5.0, S(routed=2, healthy=2)), (20.0, S(routed=2,
                                                           healthy=2)),
                   (40.0, S(routed=2, healthy=2)),
                   (40.5, S(routed=2, healthy=2, kv_occupancy=0.995))):
        t["now"], sig["s"] = now, s
        levels.append(await ctrl.step_once())
    assert levels == [2, 2, 1, 0, 4]
    return levels, calls, ctrl.retry_after_s(), pkg.metrics.counters.get(
        pkg.metrics.GW_BROWNOUT_LEVEL)


def test_autoscaler_cooldown_and_callbacks():
    ref, port = _both(_autoscaler_cooldown_and_callbacks, 0)
    assert port == ref


def test_brownout_controller_dwell_and_levers():
    ref, port = _both_async(_brownout_controller_dwell_and_levers)
    assert port == ref


# --------------------------------------------------------------------- #
# the scheduler with stub gen clients
# --------------------------------------------------------------------- #


class _StubGenClient:
    """Capacity-poll-only stand-in (the reference test's): the dispatch
    path must never reach generate_stream in the cancel race."""

    def __init__(self, occupancy=0.0):
        self.streams = 0
        self.occupancy = occupancy

    async def metrics(self, url):
        return {"max_slots": 4, "kv_pool_demand_occupancy": self.occupancy,
                "slot_capacity": 4096}

    async def generate_stream(self, url, rid, ids, sp, deadline_s=None):
        self.streams += 1
        yield {"token_ids": [], "logprobs": [], "finish_reason": "stop"}


class _HedgeStubClient:
    """One backend wedges pre-first-chunk, the other streams."""

    def __init__(self, slow_url):
        self.slow_url = slow_url
        self.streams = []
        self.closed = []

    async def metrics(self, url):
        return {"max_slots": 4, "kv_pool_demand_occupancy": 0.0,
                "slot_capacity": 4096}

    async def generate_stream(self, url, rid, ids, sp, deadline_s=None):
        self.streams.append(url)
        try:
            if url == self.slow_url:
                await asyncio.sleep(3600)
            for _ in range(4):
                yield {"token_ids": [7], "logprobs": [0.0],
                       "finish_reason": None}
                await asyncio.sleep(0.02)
            yield {"token_ids": [], "logprobs": [], "finish_reason": "stop"}
        finally:
            self.closed.append(url)


def _clear_histograms(pkg):
    for name in (pkg.metrics.GW_TTFT_S, pkg.metrics.GW_QUEUE_WAIT_S):
        pkg.metrics.counters.clear(name)


async def _cancel_while_dispatching_refunds_charge(pkg):
    _clear_histograms(pkg)
    stub = _StubGenClient()
    t = {"now": 0.0}
    sched = pkg.scheduler.ContinuousBatchScheduler(
        ["http://stub:1"],
        tenants={"t": pkg.qos.TenantSpec(
            name="t", rate_tokens_per_s=100.0, burst_tokens=10_000.0)},
        client=stub, clock=lambda: t["now"])
    await sched.start()
    try:
        req = pkg.scheduler.GatewayRequest.build("t", [1, 2, 3],
                                                 {"max_new_tokens": 61})
        bucket = sched._bucket("t")
        before = bucket.available
        req.cancelled = True
        sched.submit(req)
        charged = before - bucket.available
        for _ in range(200):
            await asyncio.sleep(0.01)
            if sched.queue_depth() == 0 and sched.inflight() == 0:
                break
        return dict(charged=charged, depth=sched.queue_depth(),
                    inflight=sched.inflight(), streams=stub.streams,
                    refunded=bucket.available == before,
                    vft=sched._wfq._last_vft.get("t", 0.0))
    finally:
        await sched.stop()


async def _deadline_expire_in_queue_refunds_and_rolls_back(pkg):
    _clear_histograms(pkg)
    t = {"now": 0.0}
    stub = _StubGenClient(occupancy=1.0)
    sched = pkg.scheduler.ContinuousBatchScheduler(
        ["http://stub:1"],
        tenants={"t": pkg.qos.TenantSpec(
            name="t", rate_tokens_per_s=100.0, burst_tokens=10_000.0)},
        client=stub, clock=lambda: t["now"])
    await sched.start()
    try:
        c = pkg.metrics.counters
        shed0 = c.get(pkg.metrics.GW_DEADLINE_SHED)
        bucket = sched._bucket("t")
        before = bucket.available
        req = pkg.scheduler.GatewayRequest.build(
            "t", [1, 2, 3], {"max_new_tokens": 8}, deadline_s=5.0)
        sched.submit(req)
        out = dict(deadline_t=req.deadline_t,
                   charged=before - bucket.available)
        t["now"] = 10.0
        out["shed"] = sched.sweep_deadlines()
        out["events"] = [ev async for ev in sched.events(req)]
        out.update(streams=stub.streams, depth=sched.queue_depth(),
                   refunded=bucket.available == before,
                   vft=sched._wfq._last_vft.get("t", 0.0),
                   counted=c.get(pkg.metrics.GW_DEADLINE_SHED) - shed0,
                   completed=dict(sched.completed))
        return out
    finally:
        await sched.stop()


async def _cancel_during_hedge_settles_slots_and_bucket(pkg):
    _clear_histograms(pkg)
    t = {"now": 0.0}
    urls = ["http://a:1", "http://b:1"]
    stub = _HedgeStubClient(slow_url=urls[0])
    sched = pkg.scheduler.ContinuousBatchScheduler(
        list(urls),
        tenants={"t": pkg.qos.TenantSpec(
            name="t", rate_tokens_per_s=0.01, burst_tokens=10_000.0)},
        client=stub, hedge_enabled=True, hedge_min_delay_s=0.05,
        clock=lambda: t["now"])
    await sched.start()
    try:
        c = pkg.metrics.counters
        hedges0 = c.get(pkg.metrics.GW_HEDGES)
        wins0 = c.get(pkg.metrics.GW_HEDGE_WINS)
        bucket = sched._bucket("t")
        before = bucket.available
        req = pkg.scheduler.GatewayRequest.build("t", [1, 2, 3],
                                                 {"max_new_tokens": 64})
        sched.submit(req)
        got = []
        async for ev in sched.events(req):
            got.extend(ev.get("token_ids", []))
            if len(got) >= 2:
                sched.cancel(req)
                break
        for _ in range(300):
            await asyncio.sleep(0.01)
            if sched.inflight() == 0 and len(stub.closed) == 2:
                break
        return dict(
            inflight=sched.inflight(),
            hedges=c.get(pkg.metrics.GW_HEDGES) - hedges0,
            wins=c.get(pkg.metrics.GW_HEDGE_WINS) - wins0,
            opened=sorted(set(stub.streams)), closed=sorted(stub.closed),
            settled=bucket.available == before - (3 + req.n_generated),
            finish=req.finish_reason)
    finally:
        await sched.stop()


async def _all_breakers_open_answers_503(pkg):
    sched = pkg.scheduler.ContinuousBatchScheduler(
        ["http://stub:1", "http://stub:2"], client=_StubGenClient(),
        metrics_poll_interval=9999.0)
    await sched.start()
    try:
        for s in sched._servers.values():
            s.healthy = False
        with pytest.raises(pkg.scheduler.ServiceUnavailable) as ei:
            sched.submit(pkg.scheduler.GatewayRequest.build(
                "t", PROMPT, {"max_new_tokens": 2}))
        return str(ei.value), ei.value.retry_after_s, sched.queue_depth()
    finally:
        await sched.stop()


async def _queue_full_answers_429(pkg):
    sched = pkg.scheduler.ContinuousBatchScheduler(
        ["http://stub:1"], client=_StubGenClient(occupancy=0.99),
        max_queue=1, metrics_poll_interval=9999.0)
    await sched.start()
    try:
        sched.submit(pkg.scheduler.GatewayRequest.build(
            "t", PROMPT, {"max_new_tokens": 2}))
        with pytest.raises(pkg.scheduler.RateLimited) as ei:
            sched.submit(pkg.scheduler.GatewayRequest.build(
                "t", PROMPT, {"max_new_tokens": 2}))
        return (str(ei.value), ei.value.permanent, sched.queue_depth(),
                sched.inflight())
    finally:
        await sched.stop()


async def _queue_full_retry_after_is_drain_estimate(pkg):
    sched = pkg.scheduler.ContinuousBatchScheduler(
        ["http://stub:1"], client=_StubGenClient(occupancy=1.0))
    _clear_histograms(pkg)
    out = [sched._queue_retry_after_s()]
    for _ in range(20):
        pkg.metrics.counters.observe(pkg.metrics.GW_QUEUE_WAIT_S, 5.0)
    out.append(sched._queue_retry_after_s())
    for _ in range(200):
        pkg.metrics.counters.observe(pkg.metrics.GW_QUEUE_WAIT_S, 120.0)
    out.append(sched._queue_retry_after_s())
    _clear_histograms(pkg)
    assert out[0] == 1.0 and out[2] == 60.0
    return out


async def _generate_stream_connect_retries_honor_deadline(pkg):
    url = f"http://127.0.0.1:{network.find_free_port()}"   # nobody there
    async with pkg.client.GenAPIClient(
        timeout=5.0, retry=pkg.client.RetryPolicy(
            max_attempts=100, backoff_base_s=0.5, jitter=0.0),
    ) as cl:
        t0 = time.monotonic()
        with pytest.raises(pkg.client.DeadlineExceeded):
            async for _ in cl.generate_stream(
                    url, "r-dead", [1, 2], {"max_new_tokens": 2},
                    deadline_s=0.4):
                pass
        return time.monotonic() - t0 < 4.0


async def _deadline_storm_sheds_in_queue(pkg):
    """``gw.deadline_storm`` armed: ``_pick_server`` reports no capacity,
    so a request with a deadline ages out in the fair queue and is shed
    there (refunded, never dispatched); disarmed, the next one runs."""
    _clear_histograms(pkg)
    t = {"now": 0.0}
    stub = _StubGenClient()
    sched = pkg.scheduler.ContinuousBatchScheduler(
        ["http://stub:1"], client=stub, clock=lambda: t["now"],
        metrics_poll_interval=9999.0)
    await sched.start()
    rule = pkg.faults.inject("gw.deadline_storm", action="trip")
    try:
        c = pkg.metrics.counters
        shed0 = c.get(pkg.metrics.GW_DEADLINE_SHED)
        req = pkg.scheduler.GatewayRequest.build(
            "t", [1, 2, 3], {"max_new_tokens": 8}, deadline_s=5.0)
        sched.submit(req)
        await asyncio.sleep(0.05)
        held = (sched.queue_depth(), stub.streams, rule.fired > 0)
        t["now"] = 10.0
        shed = sched.sweep_deadlines()
        evs = [ev async for ev in sched.events(req)]
        pkg.faults.reset()
        nxt = pkg.scheduler.GatewayRequest.build("t", [1, 2, 3],
                                                 {"max_new_tokens": 8})
        sched.submit(nxt)
        after = [ev async for ev in sched.events(nxt)]
        return (held, shed, evs, c.get(pkg.metrics.GW_DEADLINE_SHED) - shed0,
                after, stub.streams)
    finally:
        pkg.faults.reset()
        await sched.stop()


SCHEDULER_SCRIPTS = {
    "deadline_storm_sheds_in_queue": _deadline_storm_sheds_in_queue,
    "cancel_while_dispatching_refunds_charge":
        _cancel_while_dispatching_refunds_charge,
    "deadline_expire_in_queue_refunds_and_rolls_back":
        _deadline_expire_in_queue_refunds_and_rolls_back,
    "cancel_during_hedge_settles_slots_and_bucket":
        _cancel_during_hedge_settles_slots_and_bucket,
    "all_breakers_open_answers_503_with_retry_after":
        _all_breakers_open_answers_503,
    "queue_full_answers_429": _queue_full_answers_429,
    "queue_full_retry_after_is_drain_estimate":
        _queue_full_retry_after_is_drain_estimate,
    "generate_stream_connect_retries_honor_deadline":
        _generate_stream_connect_retries_honor_deadline,
}


@pytest.mark.parametrize("name", list(SCHEDULER_SCRIPTS))
def test_scheduler_scripts_match_the_reference(name):
    ref, port = _both_async(SCHEDULER_SCRIPTS[name])
    assert port == ref


def test_scheduler_and_api_public_names_match_the_reference():
    import areal_tpu.gateway as ref_pkg
    import areal_tpu_torch.gateway as pt_pkg

    want = {n for n in dir(ref_pkg) if not n.startswith("_")}
    assert want <= {n for n in dir(pt_pkg) if not n.startswith("_")}
    for mod_ref, mod_pt in ((ref_scheduler, pt_scheduler), (ref_api, pt_api),
                            (ref_brownout, pt_brownout)):
        names = {n for n in vars(mod_ref) if not n.startswith("_")
                 and getattr(getattr(mod_ref, n), "__module__", "")
                 == mod_ref.__name__}
        assert names <= set(vars(mod_pt)), names - set(vars(mod_pt))


# --------------------------------------------------------------------- #
# end to end: the two stacks side by side
# --------------------------------------------------------------------- #


class _LoopThread:
    """One event loop on a thread of its own: both stacks' servers,
    schedulers and gateways live on it for the module."""

    def __init__(self):
        self.loop = asyncio.new_event_loop()
        self.thread = threading.Thread(target=self.loop.run_forever,
                                       daemon=True)
        self.thread.start()

    def run(self, coro, timeout=120):
        return asyncio.run_coroutine_threadsafe(coro, self.loop).result(
            timeout)

    def call(self, fn, *args):
        async def go():
            return fn(*args)

        return self.run(go())

    def close(self):
        self.loop.call_soon_threadsafe(self.loop.stop)
        self.thread.join(timeout=10)
        self.loop.close()


def _tenants(pkg):
    spec = pkg.qos.TenantSpec
    return {
        # "small" affords exactly one request of PROMPT + 4 tokens
        "small": spec("small", rate_tokens_per_s=0.001,
                      burst_tokens=len(PROMPT) + 4),
        "big": spec("big"),
        "tiny": spec("tiny", rate_tokens_per_s=1.0, burst_tokens=4.0),
    }


KEYED = dict(require_api_key=True, api_keys={"key-big": "big"})


async def _ref_stack(params):
    eng = ref_engine.GenerationEngine(RefConfig(**CFG_KW), params,
                                      max_slots=4, max_seqlen=128)
    gen_port = network.find_free_port()
    runners = [await ref_server.serve(eng, "127.0.0.1", gen_port,
                                      decode_steps=2)]
    sched = ref_scheduler.ContinuousBatchScheduler(
        [f"http://127.0.0.1:{gen_port}"], _tenants(REF), max_queue=64,
        metrics_poll_interval=9999.0)
    await sched.start()
    codec = ref_api.ByteFallbackCodec(CFG_KW["vocab_size"])
    urls = []
    gws = []
    for kw in ({}, KEYED):
        gw = ref_api.GatewayServer(
            sched, codec, ref_api.GatewayConfig(max_tokens_cap=256, **kw))
        port = network.find_free_port()
        runners.append(await ref_api.serve_gateway(gw, "127.0.0.1", port))
        urls.append(f"http://127.0.0.1:{port}")
        gws.append(gw)

    async def close():
        await sched.stop()
        for r in reversed(runners):
            await r.cleanup()

    return types.SimpleNamespace(
        eng=eng, gen_url=f"http://127.0.0.1:{gen_port}", sched=sched,
        url=urls[0], keyed_url=urls[1], config=gws[0].config, close=close,
        n_running=eng.n_running,
        pages_free=lambda: eng.pool.n_free == eng.n_pages)


async def _port_stack(tree):
    eng = pt_engine.GenerationEngine(
        PtConfig(**CFG_KW), pt_tfm.params_from_numpy(tree, device="cpu"),
        max_slots=4, max_seqlen=128, device="cpu")
    srv = pt_server.serve(eng, "127.0.0.1", 0, decode_steps=2)
    gen_url = f"http://127.0.0.1:{srv.port}"
    sched = pt_scheduler.ContinuousBatchScheduler(
        [gen_url], _tenants(PORT), max_queue=64,
        metrics_poll_interval=9999.0)
    await sched.start()
    codec = pt_api.ByteFallbackCodec(CFG_KW["vocab_size"])
    runners, urls, gws = [], [], []
    for kw in ({}, KEYED):
        gw = pt_api.GatewayServer(
            sched, codec, pt_api.GatewayConfig(max_tokens_cap=256, **kw))
        runners.append(await pt_api.serve_gateway(gw, "127.0.0.1", 0))
        urls.append(f"http://127.0.0.1:{runners[-1].port}")
        gws.append(gw)

    async def close():
        await sched.stop()
        for r in runners:
            await r.cleanup()
        await asyncio.get_running_loop().run_in_executor(None, srv.stop)

    return types.SimpleNamespace(
        eng=eng, gen_url=gen_url, sched=sched, url=urls[0],
        keyed_url=urls[1], config=gws[0].config, close=close,
        n_running=eng.n_running,
        pages_free=lambda: eng.pool.n_free == eng.n_pages)


@pytest.fixture(scope="module")
def stacks():
    params = ref_tfm.init_params(RefConfig(**CFG_KW), jax.random.key(5))
    tree = jax.tree.map(np.asarray, params)
    lt = _LoopThread()
    try:
        ref = lt.run(_ref_stack(params))
        port = lt.run(_port_stack(tree))
    except BaseException:
        lt.close()
        raise
    yield types.SimpleNamespace(loop=lt, ref=ref, port=port)
    for st in (ref, port):
        lt.run(st.close())
    lt.close()


def _post(url, body, headers=None, raw=None, timeout=60):
    """One POST; (status, headers, body bytes) whatever the status."""
    data = raw if raw is not None else json.dumps(body).encode()
    req = urllib.request.Request(url, data=data, method="POST", headers={
        "Content-Type": "application/json", **(headers or {})})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, dict(r.headers), r.read()
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), e.read()


def _get(url):
    with urllib.request.urlopen(url, timeout=60) as r:
        return json.loads(r.read())


def _sse(raw: bytes):
    """(frames, done): the JSON frames of an SSE body in order, and
    whether ``[DONE]`` came last."""
    payloads = [ln[5:].strip() for ln in raw.split(b"\n")
                if ln.startswith(b"data:")]
    done = bool(payloads) and payloads[-1] == b"[DONE]"
    return [json.loads(p) for p in payloads if p != b"[DONE]"], done


def _shape(status, body: bytes):
    """An answer without the per-request parts (``id``, ``created``): the
    status and the rest of the JSON body."""
    d = json.loads(body)
    for k in ("id", "created"):
        d.pop(k, None)
    return status, d


def _both_stacks(stacks, fn):
    return fn(stacks.ref), fn(stacks.port)


def test_completion_e2e_buffered_and_streaming(stacks):
    """Greedy ``/v1/completions``, buffered and streamed: the same tokens
    (as text) and usage on both stacks; the stream's deltas concatenate to
    the buffered text, ``finish_reason`` only on the last frame and
    ``[DONE]`` last."""
    def run(st):
        body = {"prompt": PROMPT, "max_tokens": 8, "temperature": 0}
        status, _, raw = _post(f"{st.url}/v1/completions", body)
        buffered = _shape(status, raw)
        status, headers, raw = _post(f"{st.url}/v1/completions",
                                     dict(body, stream=True))
        frames, done = _sse(raw)
        assert status == 200 and done and len(frames) >= 2
        assert headers["Content-Type"].startswith("text/event-stream")
        assert all(f["choices"][0]["finish_reason"] is None
                   for f in frames[:-1])
        text = "".join(f["choices"][0]["text"] for f in frames)
        assert text == buffered[1]["choices"][0]["text"]
        return buffered, frames[-1]["choices"][0]["finish_reason"]

    ref, port = _both_stacks(stacks, run)
    assert ref[0][0] == 200 and ref[0][1]["usage"]["completion_tokens"] == 8
    assert port == ref


def test_chat_completion_e2e(stacks):
    msgs = [{"role": "system", "content": "hi"},
            {"role": "user", "content": "abc"}]

    def run(st):
        body = {"messages": msgs, "max_tokens": 6, "temperature": 0}
        buffered = _shape(*_post(f"{st.url}/v1/chat/completions", body)[::2])
        status, _, raw = _post(f"{st.url}/v1/chat/completions",
                               dict(body, stream=True))
        frames, done = _sse(raw)
        assert status == 200 and done and frames
        for f in frames:
            f.pop("id"), f.pop("created")
        return buffered, frames

    ref, port = _both_stacks(stacks, run)
    assert ref[0][1]["object"] == "chat.completion"
    assert ref[1][0]["choices"][0]["delta"].get("role") == "assistant"
    assert port == ref


BAD_COMPLETIONS = [
    {},                                             # missing prompt
    {"prompt": ""},                                 # empty prompt
    {"prompt": PROMPT, "max_tokens": 0},            # max_tokens < 1
    {"prompt": PROMPT, "temperature": -1},          # bad temperature
    {"prompt": PROMPT, "top_p": 0},                 # bad top_p
    {"prompt": PROMPT, "n": 2},                     # unsupported n
    {"prompt": [1.5, 2.5]},                         # non-int tokens
    {"prompt": PROMPT, "stop_token_ids": 5},        # non-list stops
    {"prompt": PROMPT, "max_tokens": 256},          # beyond slot cap
    {"prompt": PROMPT, "stop": "ab"},               # multi-token stop
    {"prompt": PROMPT, "max_tokens": "x"},          # malformed number
]


def test_gateway_validation_400(stacks):
    """The reference's invalid bodies answer 400 with its bodies and
    codes on both stacks, as do an empty chat, a body that is not JSON and
    one that is not an object; an unknown key without ``require_api_key``
    rides the default tenant and is served."""
    def run(st):
        out = [_shape(*_post(f"{st.url}/v1/completions", b)[::2])
               for b in BAD_COMPLETIONS]
        out.append(_shape(*_post(f"{st.url}/v1/chat/completions",
                                 {"messages": []})[::2]))
        out.append(_shape(*_post(f"{st.url}/v1/completions", None,
                                 raw=b"{nope")[::2]))
        out.append(_shape(*_post(f"{st.url}/v1/completions", [1])[::2]))
        status, _, _ = _post(f"{st.url}/v1/completions",
                             {"prompt": PROMPT, "max_tokens": 2},
                             headers={"Authorization": "Bearer nope"})
        return out, status

    ref, port = _both_stacks(stacks, run)
    assert all(s == 400 and d["error"]["type"] == "invalid_request_error"
               for s, d in ref[0]) and ref[1] == 200
    assert port == ref


def test_missing_or_invalid_api_key_answers_401(stacks):
    def run(st):
        url = f"{st.keyed_url}/v1/completions"
        body = {"prompt": PROMPT, "max_tokens": 2, "temperature": 0}
        return [_shape(*_post(url, body)[::2]),
                _shape(*_post(url, body, headers={
                    "Authorization": "Bearer nope"})[::2]),
                _post(url, body, headers={
                    "Authorization": "Bearer key-big"})[0]]

    ref, port = _both_stacks(stacks, run)
    assert [r[0] for r in ref[:2]] == [401, 401] and ref[2] == 200
    assert port == ref


def test_per_tenant_rate_limit_enforced(stacks):
    """``small`` affords one request; its second answers 429 with
    ``Retry-After`` while ``big`` is served."""
    def run(st):
        body = {"prompt": PROMPT, "max_tokens": 4, "temperature": 0}
        url = f"{st.url}/v1/completions"
        first = _post(url, body, headers={"X-Tenant": "small"})[0]
        status, headers, raw = _post(url, body, headers={"X-Tenant": "small"})
        big = _post(url, body, headers={"X-Tenant": "big"})[0]
        return (first, _shape(status, raw), "Retry-After" in headers, big)

    ref, port = _both_stacks(stacks, run)
    assert ref[0] == 200 and ref[1][0] == 429 and ref[2] and ref[3] == 200
    assert ref[1][1]["error"]["code"] == "rate_limit_exceeded"
    assert port == ref


def test_unserveable_cost_answers_400_not_429(stacks):
    def run(st):
        return _shape(*_post(f"{st.url}/v1/completions",
                             {"prompt": PROMPT, "max_tokens": 50},
                             headers={"X-Tenant": "tiny"})[::2])

    ref, port = _both_stacks(stacks, run)
    assert ref[0] == 400 and "never be admitted" in ref[1]["error"]["message"]
    assert port == ref


def test_unknown_x_tenant_collapses_to_default(stacks):
    def run(st):
        statuses = [_post(f"{st.url}/v1/completions",
                          {"prompt": PROMPT, "max_tokens": 2},
                          headers={"X-Tenant": f"minted-{i}"})[0]
                    for i in range(3)]
        tenants = stacks.loop.call(lambda: sorted(st.sched.tenants))
        return statuses, tenants

    ref, port = _both_stacks(stacks, run)
    assert ref[0] == [200] * 3
    assert not any(t.startswith("minted-") for t in ref[1])
    assert port == ref


def test_admission_holds_at_full_kv_pool(stacks):
    """A full pool (past the admit gate) holds a request in the queue, the
    engine never sees it; freeing the pool dispatches it to completion,
    with the same greedy tokens on both stacks."""
    def run(st):
        sched = st.sched
        srv = next(iter(sched._servers.values()))
        pkg = REF if st is stacks.ref else PORT

        async def submit():
            srv.kv_occupancy = 0.99
            req = pkg.scheduler.GatewayRequest.build(
                "t", PROMPT, {"max_new_tokens": 4, "greedy": True})
            sched.submit(req)
            await asyncio.sleep(0.3)
            held = (sched.queue_depth(), sched.inflight())
            srv.kv_occupancy = 0.0
            sched._wake.set()
            got = []
            async for ev in sched.events(req):
                got.extend(ev.get("token_ids", []))
            return held, got, sched.queue_depth()

        return stacks.loop.run(submit())

    ref, port = _both_stacks(stacks, run)
    assert ref[0] == (1, 0) and len(ref[1]) == 4
    assert port == ref


def test_all_breakers_open_answers_503_with_retry_after(stacks):
    def run(st):
        servers = list(st.sched._servers.values())
        stacks.loop.call(lambda: [setattr(s, "healthy", False)
                                  for s in servers])
        try:
            status, headers, raw = _post(f"{st.url}/v1/completions",
                                         {"prompt": PROMPT, "max_tokens": 2})
        finally:
            stacks.loop.call(lambda: [setattr(s, "healthy", True)
                                      for s in servers])
        return _shape(status, raw), int(headers["Retry-After"])

    ref, port = _both_stacks(stacks, run)
    assert ref[0][0] == 503 and ref[1] >= 1
    assert ref[0][1]["error"]["code"] == "service_unavailable"
    assert port == ref


def test_deadline_e2e_504_and_validation(stacks):
    """A budget that cannot be met answers 504 (body field or header; its
    message says where the request was shed, in the queue or at dispatch,
    which is timing, so the status and code are compared); malformed
    deadlines answer 400; a generous one changes nothing."""
    def run(st):
        url = f"{st.url}/v1/completions"
        status, body = _shape(*_post(url, {"prompt": PROMPT, "max_tokens": 8,
                                           "timeout": 0.0001})[::2])
        out = [(status, body["error"]["type"], body["error"]["code"]),
               _post(url, {"prompt": PROMPT, "max_tokens": 8},
                     headers={"X-Request-Deadline": "0.0001"})[0]]
        for bad in (-1, "soon", float("inf")):
            out.append(_shape(*_post(url, {"prompt": PROMPT,
                                           "max_tokens": 2,
                                           "timeout": bad})[::2]))
        out.append(_shape(*_post(url, {"prompt": PROMPT, "max_tokens": 4,
                                       "timeout": 300,
                                       "temperature": 0})[::2]))
        return out

    ref, port = _both_stacks(stacks, run)
    assert ref[0] == (504, "server_error", "deadline_exceeded")
    assert ref[1] == 504
    assert [r[0] for r in ref[2:5]] == [400] * 3 and ref[5][0] == 200
    assert port == ref


def test_brownout_clamp_applies_to_new_requests(stacks):
    def run(st):
        stacks.loop.call(setattr, st.config, "brownout_max_tokens", 3)
        try:
            return _shape(*_post(f"{st.url}/v1/completions",
                                 {"prompt": PROMPT, "max_tokens": 64,
                                  "temperature": 0})[::2])
        finally:
            stacks.loop.call(setattr, st.config, "brownout_max_tokens", None)

    ref, port = _both_stacks(stacks, run)
    assert ref[0] == 200 and ref[1]["usage"]["completion_tokens"] == 3
    assert port == ref


def _hang_up_after_first_frame(url, path, body):
    host, port = url[len("http://"):].split(":")
    sock = socket.create_connection((host, int(port)))
    data = json.dumps(body).encode()
    sock.sendall(f"POST {path} HTTP/1.1\r\nHost: x\r\nContent-Type: "
                 f"application/json\r\nContent-Length: {len(data)}\r\n\r\n"
                 .encode() + data)
    got = b""
    while b"data: {" not in got:
        chunk = sock.recv(4096)
        assert chunk, got
        got += chunk
    sock.close()


def _wait_released(st, what):
    deadline = time.monotonic() + 30
    while st.n_running() or not st.pages_free() or st.sched.inflight():
        assert time.monotonic() < deadline, f"{what}: the slot was kept"
        time.sleep(0.05)
    return True


def test_stream_early_disconnect_releases_slot(stacks):
    """A client that hangs up after the first frame frees the engine slot
    and its pages, straight to ``/generate_stream`` and through the
    gateway (and the gateway's tenant charge is settled)."""
    def run(st):
        _hang_up_after_first_frame(st.gen_url, "/generate_stream", {
            "rid": "dc", "input_ids": PROMPT,
            "sampling_params": {"max_new_tokens": 120, "greedy": True}})
        direct = _wait_released(st, "direct")
        _hang_up_after_first_frame(st.url, "/v1/completions", {
            "prompt": PROMPT, "max_tokens": 120, "temperature": 0,
            "stream": True})
        return direct, _wait_released(st, "gateway"), stacks.loop.call(
            lambda: st.sched.queue_depth())

    ref, port = _both_stacks(stacks, run)
    assert port == ref == (True, True, 0)


def test_generate_validation_400(stacks):
    """The gen servers behind the gateways answer the reference's invalid
    ``/generate`` bodies 400 with the same texts, on both routes."""
    bad = [
        {"input_ids": PROMPT},
        {"rid": "a", "input_ids": []},
        {"rid": "a", "input_ids": ["x"]},
        {"rid": "a", "input_ids": [5, 999]},
        {"rid": "a", "input_ids": PROMPT,
         "sampling_params": {"max_new_tokens": 0}},
        {"rid": "a", "input_ids": PROMPT,
         "sampling_params": {"temperature": -0.5}},
        {"rid": "a", "input_ids": PROMPT, "sampling_params": {"top_p": 0.0}},
        {"rid": "a", "input_ids": PROMPT, "sampling_params": {"top_k": 0}},
        {"rid": "a", "input_ids": PROMPT,
         "sampling_params": {"min_new_tokens": 9, "max_new_tokens": 4}},
        {"rid": "a", "input_ids": PROMPT,
         "sampling_params": {"max_new_tokens": 4096}},
    ]

    def run(st):
        out = [_shape(*_post(f"{st.gen_url}{ep}", b)[::2])
               for b in bad for ep in ("/generate", "/generate_stream")]
        return out, st.n_running()

    ref, port = _both_stacks(stacks, run)
    assert all(s == 400 for s, _ in ref[0]) and ref[1] == 0
    assert port == ref


def test_generate_stream_client_chunks_match_generate(stacks):
    """Each package's client against its own gen server: the streamed
    deltas concatenate to ``/generate``'s answer, one final frame; the
    same tokens on both."""
    sp = {"max_new_tokens": 10, "greedy": True}

    def run(st):
        pkg = REF if st is stacks.ref else PORT

        async def go():
            async with pkg.client.GenAPIClient() as c:
                want = await c.generate(st.gen_url, "ref", PROMPT, sp)
                frames = [f async for f in c.generate_stream(
                    st.gen_url, "stream", PROMPT, sp)]
            toks = [t for f in frames for t in f["token_ids"]]
            finals = [f for f in frames if f.get("finish_reason")]
            assert toks == want.output_ids and len(finals) == 1
            return toks, finals[0]["finish_reason"], want.finish_reason

        return stacks.loop.run(go())

    ref, port = _both_stacks(stacks, run)
    assert port == ref


def test_demand_occupancy_excludes_evictable_cache():
    """A cache-warm idle engine reads as not full to the admission gate:
    both engines hold prefix pages after one request and report a demand
    occupancy of 0."""
    params = ref_tfm.init_params(RefConfig(**CFG_KW), jax.random.key(5))
    prompt = list(range(1, 128)) + [5, 9, 11]
    ref = ref_engine.GenerationEngine(RefConfig(**CFG_KW), params,
                                      max_slots=2, max_seqlen=512)
    port = pt_engine.GenerationEngine(
        PtConfig(**CFG_KW), pt_tfm.params_from_numpy(
            jax.tree.map(np.asarray, params), device="cpu"),
        max_slots=2, max_seqlen=512, device="cpu")
    out = []
    for eng, req in ((ref, ref_engine.GenRequest), (port, pt_engine.GenRequest)):
        eng.submit(req(rid="a", input_ids=prompt, max_new_tokens=2,
                       greedy=True))
        eng.run_until_done(decode_steps=2)
        out.append((eng.n_running(), eng.kv_pool_occupancy() > 0.0,
                    eng.kv_pool_demand_occupancy()))
    assert out[0] == (0, True, 0.0)
    assert out[1] == out[0]


def test_gateway_metrics_models_and_health(stacks):
    def run(st):
        m = _get(f"{st.url}/metrics_json")
        models = _get(f"{st.url}/v1/models")
        models["data"][0].pop("created")
        return (sorted(m), m["queue_depth"], m["tenants"], models,
                _get(f"{st.url}/health"))

    ref, port = _both_stacks(stacks, run)
    assert port == ref


# --------------------------------------------------------------------- #
# gateway_main in a launcher world
# --------------------------------------------------------------------- #

WORLD_ARCH = dict(
    n_layers=2, n_q_heads=4, n_kv_heads=2, head_dim=8, hidden_dim=32,
    intermediate_dim=64, vocab_size=128, use_attention_bias=True,
    dtype="float32",
)


def _live_group_members(pgid):
    alive = []
    for pid in os.listdir("/proc"):
        if not pid.isdigit():
            continue
        try:
            with open(f"/proc/{pid}/stat") as f:
                fields = f.read().rsplit(")", 1)[1].split()
        except OSError:
            continue
        if int(fields[2]) == pgid and fields[0] not in ("Z", "X"):
            alive.append(pid)
    return alive


def test_gateway_main_in_a_world_on_the_cpu(tmp_path):
    """``python -m areal_tpu_torch.apps.main async-ppo`` with
    ``gateway.enabled``, two gen servers and the autoscaler on: a
    completion through the address published under ``names.gateway``
    answers; the gateway's tenant traffic shows in the manager's fleet
    view; the idle fleet's autoscaler shrink reaches the manager's
    ``/remove_server``. The world trains until the test has seen all
    three, then its process group is killed."""
    from areal_tpu_torch.base import name_resolve, names

    data = tmp_path / "math.jsonl"
    rng = np.random.default_rng(0)
    with open(data, "w") as f:
        for i in range(8):
            f.write(json.dumps({
                "query_id": f"q{i}", "task": "math",
                "prompt_ids": [int(x) for x in rng.integers(1, 128, 6)],
                "solutions": ["\\boxed{7}"]}) + "\n")
    exp = "gw-world"
    overrides = [
        f"experiment_name={exp}", "trial_name=t0",
        f"fileroot={tmp_path}/root", f"dataset.path={data}",
        "train_batch_size=2", "max_tokens_per_mb=512",
        "control.total_train_steps=1000", "control.ckpt_freq_steps=null",
        "control.ckpt_freq_secs=null", f"actor.arch={json.dumps(WORLD_ARCH)}",
        "actor.parallel=d1m1", "use_ref_model=false", "gen.n_servers=2",
        "gen.max_slots=4", "gen.max_seqlen=256", "gen.device=cpu",
        "trainer_device=cpu", "rollout.n_workers=1",
        "rollout.max_concurrent_tasks=2", "rollout.new_tokens_per_chunk=8",
        "manager.max_head_offpolicyness=100",
        'gconfig={"n": 2, "max_new_tokens": 12}',
        'ppo={"ppo_n_minibatches": 1, "disable_value": true}',
        "gateway.enabled=true", "gateway.autoscale=true",
        "gateway.min_servers=1", "gateway.autoscale_interval_s=1.0",
        "gateway.autoscale_cooldown_s=600.0",
    ]
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1",
               AREAL_TELEMETRY_EXPORT="0.5")
    for k in ("CUDA_VISIBLE_DEVICES", "AREAL_NAME_RESOLVE_ROOT",
              "AREAL_NAME_RESOLVE_RPC"):
        env.pop(k, None)
    proc = subprocess.Popen(
        [sys.executable, "-m", "areal_tpu_torch.apps.main", "async-ppo",
         *overrides], cwd=str(tmp_path), env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True, start_new_session=True)
    nr = name_resolve.FileNameRecordRepository(
        str(tmp_path / "root" / "name_resolve"))

    def lookup(key):
        try:
            return nr.get(key)
        except name_resolve.NameEntryNotFoundError:
            return None

    seen = {}
    try:
        deadline = time.monotonic() + 90
        while len(seen) < 4 and time.monotonic() < deadline:
            assert proc.poll() is None, proc.communicate()[0][-4000:]
            time.sleep(0.25)
            gw = lookup(names.gateway(exp, "t0"))
            mgr = lookup(names.gserver_manager(exp, "t0"))
            if gw and "answer" not in seen:
                status, _, raw = _post(f"{gw}/v1/completions", {
                    "prompt": PROMPT, "max_tokens": 4, "temperature": 0})
                if status == 200:
                    seen["answer"] = json.loads(raw)
            if mgr and "answer" in seen:
                m = _get(f"{mgr}/metrics_json")
                if len(m["servers"]) == 1:
                    seen["shrunk"] = m["servers"]
                fleet = m.get("fleet_telemetry") or {}
                tokens = fleet.get("gw/tenant_tokens/anonymous", 0)
                if tokens > 0:
                    seen["tenant_tokens"] = tokens
                if fleet.get("gw/scale_downs", 0) >= 1:
                    seen["scale_downs"] = fleet["gw/scale_downs"]
    finally:
        os.killpg(proc.pid, signal.SIGKILL)
        out, _ = proc.communicate()
        deadline = time.monotonic() + 15
        while _live_group_members(proc.pid) and time.monotonic() < deadline:
            time.sleep(0.1)
    assert set(seen) == {"answer", "shrunk", "tenant_tokens",
                         "scale_downs"}, (seen, out[-4000:])
    assert seen["answer"]["usage"]["completion_tokens"] == 4
    assert seen["tenant_tokens"] >= len(PROMPT) + 4
    assert not _live_group_members(proc.pid)
