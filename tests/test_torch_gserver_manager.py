"""Port parity of the gserver manager: the same requests and the same
name_resolve writes go to the reference's aiohttp manager and to the
port's standard-library one, and every answer must be equal. The cases are
``tests/test_gserver_manager.py``'s (round-robin and sticky routing, the
staleness gate, weight fan-out with partial failure, ack-gated pruning,
503 when every breaker is open, qid attribution of failures) plus
``tests/test_staleness.py::TestOffpolicynessMatrix``'s grid and a seeded
random sequence of allocations, finishes and trainer progress. Stub
generation servers are standard-library HTTP servers.
"""

import asyncio
import dataclasses
import json
import os
import random

import pytest
from aiohttp.test_utils import TestClient, TestServer

from areal_tpu.base import name_resolve as ref_nr
from areal_tpu.base import names as ref_names
from areal_tpu.system import gserver_manager as ref_gm
from areal_tpu_torch.base import http
from areal_tpu_torch.base import name_resolve as pt_nr
from areal_tpu_torch.base import names as pt_names
from areal_tpu_torch.system import gserver_manager as pt_gm

EXP, TRIAL = "t", "t"
CFG = dict(experiment_name=EXP, trial_name=TRIAL, train_batch_size=4,
           max_head_offpolicyness=1, max_concurrent_rollouts=3)


@pytest.fixture(autouse=True)
def _clean_names():
    ref_nr.reset()
    pt_nr.reset()
    yield
    ref_nr.reset()
    pt_nr.reset()


class _Side:
    """One manager (reference or port) behind a URL, and its name store."""

    def __init__(self, kind, cfg=None, urls=None):
        self.kind = kind
        mod = ref_gm if kind == "ref" else pt_gm
        self.nr = ref_nr if kind == "ref" else pt_nr
        self.names = ref_names if kind == "ref" else pt_names
        self.m = mod.GserverManager(
            mod.GserverManagerConfig(**{**CFG, **(cfg or {})}),
            server_urls=list(urls or []))
        self._client = None

    async def __aenter__(self):
        if self.kind == "ref":
            self._client = TestClient(TestServer(self.m.app))
            await self._client.start_server()
            self.url = str(self._client.make_url("")).rstrip("/")
        else:
            # routes only: the weight-poll loop stays off, as in the
            # reference's TestServer
            self._httpd, _ = http.start_server(self.m.routes(), "127.0.0.1",
                                               0, "mgr")
            self.url = f"http://127.0.0.1:{self._httpd.server_address[1]}"
        return self

    async def __aexit__(self, *exc):
        if self.kind == "ref":
            await self._client.close()
        else:
            self._httpd.shutdown()
            self._httpd.server_close()

    async def post(self, path, body):
        """(status, answer) of one POST, through the port's client."""
        try:
            return 200, await http.request_json("POST", self.url + path, body,
                                                timeout=10)
        except http.ClientResponseError as e:
            try:
                body = json.loads(e.message)
            except ValueError:
                body = None   # aiohttp's plain-text error pages
            return e.status, e.headers.get("retry-after"), body

    def set_trained(self, n):
        self.nr.add(self.names.training_samples(EXP, TRIAL), str(n),
                    replace=True)

    def publish(self, version, path):
        self.nr.add(self.names.model_version(EXP, TRIAL, "actor"),
                    f"{version}:{path}", replace=True)


async def _both(scenario, **kw):
    out = []
    for kind in ("ref", "port"):
        async with _Side(kind, **kw) as side:
            out.append(await scenario(side))
    return out


def _sched(qid):
    return {"qid": qid, "prompt_len": 10, "group_size": 2,
            "new_token_budget": 100}


async def test_round_robin_sticky_and_previous_version():
    async def scenario(s):
        out = [await s.post("/schedule_request", _sched(f"q{i}"))
               for i in range(4)]
        out.append(await s.post("/schedule_request", _sched("q0")))
        # a chunk re-scheduled at the version it was routed under returns
        s.m.version = 0
        out.append(await s.post("/schedule_request", {
            **_sched("q9"), "previous_server_url": "http://b",
            "previous_version": 0}))
        out.append(await s.post("/finish_rollout", {"qid": "q0"}))
        out.append(dict(s.m._request_counts))
        return out

    ref, port = await _both(scenario, urls=["http://a", "http://b"])
    assert ref == port
    assert [a["url"] for _, a in port[:5]] == ["http://a", "http://b",
                                                "http://a", "http://b",
                                                "http://a"]
    assert port[5][1]["url"] == "http://b"


async def test_least_requests_policy():
    async def scenario(s):
        s.m._request_counts["http://a"] = 5
        return await s.post("/schedule_request", _sched("x"))

    ref, port = await _both(scenario, cfg={"schedule_policy": "least_requests"},
                            urls=["http://a", "http://b"])
    assert ref == port and port[1]["url"] == "http://b"


async def test_staleness_gate_sequence():
    async def scenario(s):
        out = [await s.post("/allocate_rollout", {"qid": f"q{i}"})
               for i in range(10)]
        for i in range(2):
            out.append(await s.post("/finish_rollout",
                                    {"qid": f"q{i}", "accepted": True}))
        out.append(await s.post("/allocate_rollout", {"qid": "q10"}))
        s.set_trained(64)
        out.append(await s.post("/allocate_rollout", {"qid": "q11"}))
        s.m.version = 100
        out.append(await s.post("/allocate_rollout", {"qid": "q12"}))
        out.append(dataclasses.asdict(s.m.rollout_stat))
        return out

    ref, port = await _both(scenario, urls=["http://a"])
    assert ref == port
    oks = [a["success"] for _, a in port[:10]]
    assert oks[:3] == [True] * 3 and not any(oks[3:])
    assert "staled" in port[13][1]["reason"] and port[14][1]["success"]


@pytest.mark.parametrize("seed", [0, 1, 2])
async def test_gate_random_sequence(seed):
    """Allocations, finishes (accepted or not, duplicates too), trainer
    progress and version bumps in a seeded order: the same admit/deny
    sequence and reasons."""
    ops = []
    rng = random.Random(seed)
    for i in range(120):
        r = rng.random()
        if r < 0.55:
            ops.append(("alloc", f"q{i}"))
        elif r < 0.85:
            ops.append(("finish", f"q{rng.randrange(i + 1)}",
                        rng.random() < 0.5))
        elif r < 0.95:
            ops.append(("trained", rng.randrange(0, 40)))
        else:
            ops.append(("version", rng.randrange(0, 6)))

    async def scenario(s):
        out = []
        for op in ops:
            if op[0] == "alloc":
                out.append(await s.post("/allocate_rollout", {"qid": op[1]}))
            elif op[0] == "finish":
                out.append(await s.post("/finish_rollout",
                                        {"qid": op[1], "accepted": op[2]}))
            elif op[0] == "trained":
                s.set_trained(op[1])
            else:
                s.m.version = op[1]
            out.append(dataclasses.asdict(s.m.rollout_stat))
        return out

    ref, port = await _both(scenario, cfg={"max_concurrent_rollouts": 12},
                            urls=["http://a"])
    assert ref == port
    assert any(a.get("success") is False for _, a in
               (x for x in port if isinstance(x, tuple)))


@pytest.mark.parametrize("off", [0, 1, 4])
@pytest.mark.parametrize("bs", [4, 16])
def test_offpolicyness_matrix(off, bs):
    """``is_staled`` over TestOffpolicynessMatrix's grid, both managers."""
    def grid(kind):
        s = _Side(kind, cfg=dict(train_batch_size=bs,
                                 max_head_offpolicyness=off,
                                 max_concurrent_rollouts=10_000),
                  urls=["http://x"])
        s.m.version = 0
        out = []
        for trained, version, running in (
                ((off + 1) * bs - 1, 0, 0), ((off + 1) * bs, 0, 0),
                ((off + 1) * bs, 1, 0), ((off + 2) * bs, 1, 0),
                (0, 0, (off + 1) * bs - 1), (0, 0, (off + 1) * bs),
                (bs, 2, (off + 2) * bs - 1), (bs, 2, (off + 2) * bs)):
            s.set_trained(trained)
            s.m.version = version
            s.m.rollout_stat.running = running
            out.append(s.m.is_staled())
        return out

    got = grid("port")
    assert got == grid("ref")
    assert got == [False, True, False, True, False, True, False, True]


class _StubGen:
    """A standard-library generation-server stub recording weight updates;
    ``fail_updates`` answers success: false."""

    def __init__(self, fail_updates=False):
        self.update_calls = []
        self.fail_updates = fail_updates

        def update(body):
            self.update_calls.append(json.loads(body))
            if self.fail_updates:
                return 200, {"success": False, "message": "disk error"}
            return 200, {"success": True, "message": "ok",
                         "num_paused_requests": 2}

        self.httpd, _ = http.start_server(
            {("POST", "/update_weights_from_disk"): update,
             ("GET", "/health"): lambda b: (200, {})}, "127.0.0.1", 0, "stub")
        self.url = f"http://127.0.0.1:{self.httpd.server_address[1]}"

    def stop(self):
        self.httpd.shutdown()
        self.httpd.server_close()


async def _fanout(kind, tmp_path, fails):
    stubs = [_StubGen(fail_updates=f) for f in fails]
    s = _Side(kind, urls=[x.url for x in stubs])
    out = []
    try:
        for v in (1, 2):
            ckpt = tmp_path / kind / f"v{v}"
            ckpt.mkdir(parents=True)
            s.publish(v, str(ckpt))
            path = await s.m.check_new_params()
            out.append((os.path.basename(path), s.m.version))
            # later poll ticks are no-ops, neither survivor nor corpse
            for _ in range(3):
                out.append(await s.m.check_new_params())
        out.append([len(x.update_calls) for x in stubs])
        out.append([{k: c[k] for k in ("version", "allow_interrupt")}
                    for x in stubs for c in x.update_calls])
        snap = s.m.fleet.snapshot()
        out.append([(snap[x.url]["state"], snap[x.url]["acked_version"])
                    for x in stubs])
    finally:
        for x in stubs:
            x.stop()
    return out


@pytest.mark.parametrize("fails", [(False, False), (False, True, False)],
                         ids=["all_ok", "partial_failure"])
async def test_weight_update_fanout(tmp_path, fails):
    got = await _fanout("port", tmp_path, fails)
    assert got == await _fanout("ref", tmp_path, fails)
    assert got[0] == ("v1", 1) and got[4] == ("v2", 2)
    if fails[1]:
        # the failed server was evicted at v1 and left out of v2's fan-out
        assert got[8] == [2, 1, 2] and got[10][1] == ("open", -1)


def _prune(kind, tmp_path):
    s = _Side(kind, cfg={"n_checkpoints_to_keep": 1},
              urls=["http://a", "http://b"])
    root = tmp_path / kind
    dirs = []
    for v in (1, 2, 3):
        d = root / f"v{v}"
        d.mkdir(parents=True)
        dirs.append(str(d))
        s.m._ckpt_dirs.append(str(d))
        s.m._ckpt_versions[str(d)] = v
    out = []

    def state():
        return ([os.path.basename(d) for d in s.m._ckpt_dirs],
                sorted(os.listdir(root)))

    s.m.fleet.ack_version("http://a", 3)
    s.m.fleet.ack_version("http://b", 1)
    s.m._prune_checkpoints()
    out.append(state())
    s.m.fleet.ack_version("http://b", 3)
    s.m._prune_checkpoints()
    out.append(state())
    # an evicted laggard does not block pruning
    (root / "v2b").mkdir()
    s.m._ckpt_dirs.insert(0, str(root / "v2b"))
    s.m._ckpt_versions[str(root / "v2b")] = 2
    s.m.fleet.get("http://b").acked_version = 1
    s.m.fleet.evict("http://b", "test")
    s.m._prune_checkpoints()
    out.append(state())
    return out


def test_prune_respects_unacked_servers(tmp_path):
    got = _prune("port", tmp_path)
    assert got == _prune("ref", tmp_path)
    assert got[0] == (["v2", "v3"], ["v2", "v3"])
    assert got[1] == (["v3"], ["v3"]) and got[2] == (["v3"], ["v3"])


async def test_all_breakers_open_answers_503_and_failures_name_the_qid():
    async def scenario(s):
        out = [await s.post("/report_failure", {
            "url": "http://a", "reason": "connect timeout", "qid": "q-42"})]
        out.append(s.m.fleet.get("http://a").last_failure_reason)
        for u in ("http://a", "http://b"):
            s.m.fleet.evict(u, "test: breaker open")
        out.append(await s.post("/schedule_request", _sched("q-dead")))
        out.append(await s.post("/add_server", {}))
        out.append(await s.post("/remove_server", {"url": "http://a"}))
        out.append(await s.post("/remove_server", {"url": "http://b"}))
        out.append(await s.post("/get_model_version", {}))
        return out

    ref, port = await _both(scenario, urls=["http://a", "http://b"])
    assert ref[:2] == port[:2] and ref[6] == port[6]
    assert ref[2][:2] == port[2][:2]   # 503 + Retry-After
    assert "qid=q-42" in port[1]
    assert port[2][0] == 503 and int(port[2][1]) >= 1
    assert [port[i][0] for i in (3, 4, 5)] == [400, 200, 409]
    assert ref[3:6] == port[3:6]   # the 400 and 409 bodies too


async def test_manager_serves_and_polls_on_its_own_thread(tmp_path):
    """``serve_manager``: the address is published, /metrics_json and
    /health answer, and the background poll loop flushes a published
    version to the fleet without any caller driving it."""
    stub = _StubGen()
    m = pt_gm.GserverManager(pt_gm.GserverManagerConfig(**CFG),
                             server_urls=[stub.url])
    pt_gm.serve_manager(m, "127.0.0.1", 0)
    try:
        url = pt_nr.get(pt_names.gserver_manager(EXP, TRIAL))
        assert url == f"http://127.0.0.1:{m.port}"
        assert (await http.request_json("GET", url + "/health")) == \
            {"status": "ok"}
        ckpt = tmp_path / "v0"
        ckpt.mkdir()
        pt_nr.add(pt_names.model_version(EXP, TRIAL, "actor"), f"0:{ckpt}",
                  replace=True)
        for _ in range(200):
            met = await http.request_json("GET", url + "/metrics_json")
            if met["version"] == 0:
                break
            await asyncio.sleep(0.05)
        assert met["version"] == 0 and len(stub.update_calls) == 1
        assert met["counters"]["interrupted_requests"] == 2
        # a direct call finds nothing new
        assert await m.check_new_params() is None
    finally:
        m.stop()
        stub.stop()
