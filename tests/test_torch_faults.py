"""Fault injection in the port (``areal_tpu_torch/base/faults.py`` and its
call sites) against ``areal_tpu``'s: the rule windows fire identically on
one call script, and the port's counterparts of
``tests/test_fault_tolerance.py``'s scenarios run the same script through
both packages, whose ``ft/``, ``guard/`` and ``faults/`` counter deltas
must be equal:

- the client retries through a transient fault, and gives up after its
  attempts;
- a ``rollout.push`` fault requeues the sample without duplicates;
- a server killed mid-run loses no sample (its rollouts move on);
- a weight update with one failing server evicts it, and a probe
  re-admits it once it answers again;
- a ``train.step`` trip skips the update (params and AdamW state
  untouched) and the guard counts it, rolls back when it must and says
  when it cannot;
- ``ckpt.save`` mid-save leaves the committed checkpoint;
- ``signal.term`` preempts the trainer into a committed checkpoint.

Generation servers are scriptable stubs on the port's standard-library HTTP
server (no model), shared by both packages' clients. Every test disarms
what it arms (``faults.reset()``) and restores the name_resolve defaults.
"""

import asyncio
import json
import os
import time

import numpy as np
import pytest
import torch

from areal_tpu.base import faults as ref_faults
from areal_tpu.base import name_resolve as ref_nr
from areal_tpu_torch.base import faults, http
from areal_tpu_torch.base import metrics as pt_metrics
from areal_tpu_torch.base import name_resolve

EXP, TRIAL = "ft", "t0"


@pytest.fixture(autouse=True)
def _isolated():
    saved, ref_saved = name_resolve.default_repository(), ref_nr._DEFAULT
    name_resolve.set_repository(name_resolve.MemoryNameRecordRepository())
    ref_nr.set_repository(ref_nr.MemoryNameRecordRepository())
    faults.reset()
    ref_faults.reset()
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
    faults.reset()
    ref_faults.reset()
    name_resolve.set_repository(saved)
    ref_nr.set_repository(ref_saved)


# --------------------------------------------------------------------------- #
# rule windows
# --------------------------------------------------------------------------- #


def _window_script(f):
    """One call script over armed rules; what each call did."""
    rules = [
        f.inject("gen.http", url="u1", after=1, times=2),
        f.inject("gen.http", url="u2", action="drop", times=1),
        f.inject("train.step", action="trip", after=2, times=1),
        f.inject("gen.weight_update", action="delay", delay_s=0.0),
        f.inject("signal.term", action="trip"),
    ]
    out = []
    calls = [("gen.http", {"url": "u1", "op": "generate"})] * 5 + [
        ("gen.http", {"url": "u2"}), ("gen.http", {"url": "u2"}),
        ("gen.http", {"url": "u3"}), ("train.step", {"step": 0}),
        ("train.step", {"step": 1}), ("train.step", {"step": 2}),
        ("train.step", {"step": 3}), ("gen.weight_update", {"url": "x"}),
        ("signal.term", {}), ("signal.term", {}), ("rollout.push", {}),
    ]
    for point, kw in calls:
        try:
            f.maybe_fail(point, **kw)
            r = "ok"
        except f.FaultInjected:
            r = "raised"
        out.append((point, r, f.maybe_trip(point, **kw)))
    try:
        asyncio.run(f.maybe_fail_async("gen.http", url="u2"))
        out.append("async ok")
    except f.FaultInjected:
        out.append("async raised")
    out.append([(r.seen, r.fired) for r in rules])
    out.append(f.active())
    f.reset()
    out.append(f.active())
    return out


def test_rule_windows_fire_like_the_reference():
    assert _window_script(faults) == _window_script(ref_faults)
    assert faults.FAULT_POINTS == ref_faults.FAULT_POINTS
    assert issubclass(faults.FaultInjected, ConnectionError)


def test_unarmed_points_cost_nothing(monkeypatch):
    """Unarmed, a point is one module-bool check: no lock, no rule walk,
    no counter."""
    assert not faults.active()

    def boom(*a, **k):
        raise AssertionError("an unarmed point did work")

    monkeypatch.setattr(faults, "_pick", boom)
    monkeypatch.setattr(faults, "_lock", None)
    before = pt_metrics.counters.snapshot()
    for _ in range(1000):
        faults.maybe_fail("gen.http", url="u")
        assert faults.maybe_trip("train.step", step=0) is False
    asyncio.run(faults.maybe_fail_async("gen.http", url="u"))
    assert pt_metrics.counters.snapshot() == before
    with pytest.raises(ValueError, match="unknown fault point"):
        faults.inject("no.such.point")


# --------------------------------------------------------------------------- #
# scenarios, run through both packages
# --------------------------------------------------------------------------- #

WATCHED = ("ft/", "guard/", "faults/")


def _delta(metrics_mod, before):
    now = metrics_mod.counters.snapshot()
    return {k: v - before.get(k, 0.0) for k, v in now.items()
            if k.startswith(WATCHED) and v - before.get(k, 0.0)}


class StubGenServer:
    """The gen server's HTTP surface without a model. ``dead`` answers
    every call 500 (a crashed process still listening); ``die_after``
    kills it after that many answered generates."""

    def __init__(self, n_tokens=4, die_after=None):
        self.n_tokens = n_tokens
        self.die_after = die_after
        self.dead = False
        self.version = 0
        self.generate_calls = []
        self.update_calls = []
        self._httpd, _ = http.start_server({
            ("POST", "/generate"): self._generate,
            ("POST", "/update_weights_from_disk"): self._update,
            ("GET", "/health"): self._health,
        }, "127.0.0.1", 0, "stub-gen")
        self.url = f"http://127.0.0.1:{self._httpd.server_address[1]}"

    def stop(self):
        self._httpd.shutdown()
        self._httpd.server_close()

    def _generate(self, body):
        d = json.loads(body)
        if self.dead or (self.die_after is not None
                         and len(self.generate_calls) >= self.die_after):
            return 500, {"error": "dead"}
        self.generate_calls.append(d)
        n = min(d["sampling_params"]["max_new_tokens"], self.n_tokens)
        return 200, {"rid": d["rid"], "output_ids": list(range(1, n + 1)),
                     "output_logprobs": [-0.1] * n, "finish_reason": "stop",
                     "version": self.version}

    def _update(self, body):
        if self.dead:
            return 500, {"error": "dead"}
        d = json.loads(body)
        self.update_calls.append(d)
        self.version = d.get("version", self.version)
        return 200, {"success": True, "num_paused_requests": 0}

    def _health(self, body):
        return (500, {"status": "dead"}) if self.dead else (
            200, {"status": "ok"})


class Pkg:
    """One package's modules, so a scenario runs the same script on
    either."""

    def __init__(self, name):
        self.name = name
        if name == "ref":
            from areal_tpu.api import agent, data, model
            from areal_tpu.base import faults as f
            from areal_tpu.base import metrics as m
            from areal_tpu.base import name_resolve as nr
            from areal_tpu.base import names
            from areal_tpu.gen import client
            from areal_tpu.system import gserver_manager as gm
            from areal_tpu.system import rollout_worker as rw
        else:
            from areal_tpu_torch.api import agent, data, model
            from areal_tpu_torch.base import faults as f
            from areal_tpu_torch.base import metrics as m
            from areal_tpu_torch.base import name_resolve as nr
            from areal_tpu_torch.base import names
            from areal_tpu_torch.gen import client
            from areal_tpu_torch.system import gserver_manager as gm
            from areal_tpu_torch.system import rollout_worker as rw
        self.agent, self.data, self.model = agent, data, model
        self.faults, self.metrics, self.nr, self.names = f, m, nr, names
        self.client, self.gm, self.rw = client, gm, rw

    def manager(self, urls, **kw):
        cfg = dict(experiment_name=EXP, trial_name=TRIAL, train_batch_size=4,
                   max_head_offpolicyness=100, max_concurrent_rollouts=16,
                   health_fail_threshold=3, health_probe_cooldown=1000.0,
                   health_check_interval=0.05, heartbeat_interval=1000.0)
        cfg.update(kw)
        return self.gm.GserverManager(self.gm.GserverManagerConfig(**cfg),
                                      server_urls=list(urls))

    async def serve(self, manager):
        """Serve the manager's routes; returns (url, stop coroutine fn)."""
        if self.name == "ref":
            from areal_tpu.base import network

            port = network.find_free_port()
            runner = await self.gm.serve_manager(manager, "127.0.0.1", port)
            return f"http://127.0.0.1:{port}", runner.cleanup

        port = manager.start("127.0.0.1", 0)

        async def stop():
            manager.stop()

        return f"http://127.0.0.1:{port}", stop

    def echo_agent(self):
        pkg = self

        class EchoAgent(pkg.agent.Agent):
            """One obs/act round trip, one sequence a group."""

            gconfig = pkg.model.GenerationHyperparameters(n=1,
                                                          max_new_tokens=8)

            async def collect_trajectory(self, prompt, env, obs_queue,
                                         act_queue):
                qid = prompt.ids[0]
                ids = np.asarray(prompt.data["packed_prompts"]).tolist()
                await obs_queue.put((qid, ids, self.gconfig))
                act = await act_queue.get()
                if act.error is not None:
                    raise pkg.agent.GenerationFailedError(act.error)
                return [pkg.data.SequenceSample.from_default(
                    ids=[qid], seqlens=[sum(len(s) for s in act.seqs)],
                    data={"packed_input_ids": np.concatenate(
                        [np.asarray(s, np.int64) for s in act.seqs])})]

        return EchoAgent()

    def worker(self, manager_url, n_prompts, concurrency, pusher):
        pkg = self

        class Dataset:
            items = [pkg.data.SequenceSample.from_default(
                ids=[f"q{i}"], seqlens=[4],
                data={"packed_prompts": np.asarray([1, 2, 3, 4], np.int64)})
                for i in range(n_prompts)]

            def __len__(self):
                return len(self.items)

            def __getitem__(self, i):
                return self.items[i]

        class NullEnv:
            async def reset(self):
                pass

            async def step(self, action):
                return None, [1.0], None, None

        w = self.rw.RolloutWorker(
            experiment_name=EXP, trial_name=TRIAL, worker_index=0,
            n_workers=1, n_pullers=1, agent=self.echo_agent(), env=NullEnv(),
            dataset=Dataset(), max_concurrent_tasks=concurrency,
            pusher=pusher, manager_url=manager_url)
        load = w.load_next_data

        def one_epoch():
            # the epoch wraps inside load_next_data: a sample it returns
            # from the next epoch is not taken
            s = load()
            return None if w._epoch > 0 else s

        w.load_next_data = one_epoch
        return w


class ListPusher:
    def __init__(self):
        self.items = []

    def push(self, data):
        self.items.append(data)
        return True


async def _run_until(worker, done, timeout=30.0):
    run = asyncio.get_running_loop().create_task(worker.run_async())
    try:
        deadline = time.monotonic() + timeout
        while not done() and time.monotonic() < deadline:
            await asyncio.sleep(0.02)
    finally:
        run.cancel()
        await asyncio.gather(run, return_exceptions=True)


def _client_retries(pkg, exhausted):
    srv = StubGenServer()

    async def go():
        async with pkg.client.GenAPIClient(
                timeout=10, retry=pkg.client.RetryPolicy(
                    max_attempts=3, backoff_base_s=0.001,
                    backoff_cap_s=0.002), seed=0) as c:
            pkg.faults.inject("gen.http", url=srv.url, op="generate",
                              times=None if exhausted else 2)
            try:
                r = await c.generate(srv.url, "r1", [1, 2],
                                     {"max_new_tokens": 3})
                return r.output_ids
            except ConnectionError:
                return "gave up"

    try:
        return asyncio.run(go()), len(srv.generate_calls)
    finally:
        srv.stop()


def _push_fault(pkg):
    srv = StubGenServer()

    async def go():
        manager = pkg.manager([srv.url])
        url, stop = await pkg.serve(manager)
        pusher = ListPusher()
        w = pkg.worker(url, 3, 2, pusher)
        rule = pkg.faults.inject("rollout.push", qid="q1", times=1)
        try:
            await _run_until(w, lambda: w.accepted_cnt >= 3 and not w._tasks)
        finally:
            await stop()
        return (rule.fired, w.requeued_cnt, w.dropped_cnt,
                sorted(d["ids"][0] for d in pusher.items),
                manager.rollout_stat.running)

    try:
        return asyncio.run(go())
    finally:
        srv.stop()


def _kill_server_mid_run(pkg):
    s0, s1 = StubGenServer(die_after=1), StubGenServer()

    async def go():
        manager = pkg.manager([s0.url, s1.url])
        url, stop = await pkg.serve(manager)
        pusher = ListPusher()
        w = pkg.worker(url, 6, 1, pusher)
        try:
            await _run_until(w, lambda: w.accepted_cnt >= 6 and not w._tasks)
        finally:
            await stop()
        return (w.accepted_cnt, w.dropped_cnt,
                sorted(d["ids"][0] for d in pusher.items),
                manager.fleet.get(s0.url).state,
                manager.fleet.is_healthy(s1.url),
                len(s0.generate_calls), len(s1.generate_calls))

    try:
        return asyncio.run(go())
    finally:
        s0.stop()
        s1.stop()


def _weight_update(pkg, tmp_path, readmit):
    servers = [StubGenServer() for _ in range(3)]
    ckpt = tmp_path / pkg.name / "v1"
    ckpt.mkdir(parents=True)

    async def go():
        manager = pkg.manager([s.url for s in servers],
                              health_probe_cooldown=0.05)
        pkg.nr.add(pkg.names.model_version(EXP, TRIAL, "actor"),
                   f"1:{ckpt}", replace=True)
        pkg.faults.inject("gen.weight_update", url=servers[1].url, times=1)
        assert await manager.check_new_params() == str(ckpt)
        out = [manager.version, manager.fleet.get(servers[1].url).state,
               [len(s.update_calls) for s in servers],
               sorted(manager.fleet.healthy_urls())
               == sorted([servers[0].url, servers[2].url]),
               await manager.check_new_params()]
        if readmit:
            servers[1].dead = True
            await asyncio.sleep(0.1)
            await manager.run_health_checks(wait_probes=True)
            out.append(manager.fleet.get(servers[1].url).state)
            servers[1].dead = False
            await asyncio.sleep(0.1)
            await manager.run_health_checks(wait_probes=True)
            h = manager.fleet.get(servers[1].url)
            out += [h.state, h.acked_version, servers[1].version]
        return out

    try:
        return asyncio.run(go())
    finally:
        for s in servers:
            s.stop()


SCENARIOS = {
    "client_retry_transient": lambda pkg, tmp: _client_retries(pkg, False),
    "client_retry_exhausted": lambda pkg, tmp: _client_retries(pkg, True),
    "push_fault_requeued": lambda pkg, tmp: _push_fault(pkg),
    "kill_server_mid_run": lambda pkg, tmp: _kill_server_mid_run(pkg),
    "weight_update_partial_failure":
        lambda pkg, tmp: _weight_update(pkg, tmp, False),
    "readmission_after_probe":
        lambda pkg, tmp: _weight_update(pkg, tmp, True),
}

EXPECTED = {
    "client_retry_transient": {"ft/client_retries": 2,
                               "faults/gen.http": 2},
    "client_retry_exhausted": {"ft/client_retries": 2,
                               "faults/gen.http": 3},
    "push_fault_requeued": {"ft/rollout_requeues": 1,
                            "faults/rollout.push": 1},
    "kill_server_mid_run": {"ft/gen_server_failures": 3,
                            "ft/failures_observed": 3, "ft/evictions": 1,
                            "ft/sticky_remaps": 1},
    "weight_update_partial_failure": {"ft/weight_update_failures": 1,
                                      "ft/evictions": 1,
                                      "faults/gen.weight_update": 1},
    "readmission_after_probe": {"ft/weight_update_failures": 1,
                                "ft/evictions": 1, "ft/probe_failures": 1,
                                "ft/readmissions": 1,
                                "faults/gen.weight_update": 1},
}


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_fleet_scenario_counts_like_the_reference(scenario, tmp_path):
    got = {}
    for name in ("ref", "port"):
        pkg = Pkg(name)
        before = pkg.metrics.counters.snapshot()
        result = SCENARIOS[scenario](pkg, tmp_path)
        pkg.faults.reset()
        got[name] = (result, _delta(pkg.metrics, before))
    assert got["port"] == got["ref"]
    assert got["port"][1] == EXPECTED[scenario]
    result = got["port"][0]
    if scenario == "client_retry_transient":
        assert result == ([1, 2, 3], 1)
    elif scenario == "client_retry_exhausted":
        assert result == ("gave up", 0)
    elif scenario == "push_fault_requeued":
        # q1 exactly once, no slot leaked
        assert result == (1, 1, 0, ["q0", "q1", "q2"], 0)
    elif scenario == "kill_server_mid_run":
        # zero samples lost; the dead server is out of routing
        assert result[:5] == (6, 0, [f"q{i}" for i in range(6)], "open",
                              True)


# --------------------------------------------------------------------------- #
# trainer scenarios: train.step, ckpt.save, signal.term
# --------------------------------------------------------------------------- #


class TrainerPkg:
    """A tiny ``AsyncPPOTrainerWorker`` of either package over an empty
    stream, with the SFT batch and loss both engines train on."""

    CFG = dict(n_layers=1, n_q_heads=2, n_kv_heads=1, head_dim=8,
               hidden_dim=16, intermediate_dim=32, vocab_size=64,
               dtype="float32", use_attention_bias=True)

    def __init__(self, name, root, monkeypatch):
        self.name = name
        monkeypatch.setenv("AREAL_FILEROOT", str(root / name))
        if name == "ref":
            import jax

            from areal_tpu.api.data import MicroBatchSpec, SequenceSample
            from areal_tpu.api.model import PPOHyperparameters
            from areal_tpu.base import constants, faults as f, recover
            from areal_tpu.base import metrics as m
            from areal_tpu.interfaces.sft import sft_loss_fn
            from areal_tpu.models.config import ModelConfig
            from areal_tpu.parallel.mesh import ParallelConfig
            from areal_tpu.system import worker_base
            from areal_tpu.system.trainer_worker import (
                AsyncPPOTrainerWorker, TrainerControl)
            from areal_tpu.train.engine import OptimizerConfig, TrainEngine

            eng = TrainEngine(ModelConfig(**self.CFG),
                              ParallelConfig(data=1, fsdp=1, model=1),
                              OptimizerConfig(lr=1e-2))
            self._leaves = lambda: [np.asarray(x).copy() for x in
                                    jax.tree.leaves(eng.params)]
            self._opt = lambda: [np.asarray(x).copy() for x in
                                 jax.tree.leaves(eng.opt_state)]
        else:
            from areal_tpu_torch.api.data import MicroBatchSpec, SequenceSample
            from areal_tpu_torch.api.model import PPOHyperparameters
            from areal_tpu_torch.base import constants, faults as f, recover
            from areal_tpu_torch.base import metrics as m
            from areal_tpu_torch.interfaces.sft import sft_loss_fn
            from areal_tpu_torch.models.config import ModelConfig
            from areal_tpu_torch.system import worker_base
            from areal_tpu_torch.system.trainer_worker import (
                AsyncPPOTrainerWorker, TrainerControl)
            from areal_tpu_torch.train.engine import OptimizerConfig, TrainEngine

            eng = TrainEngine(ModelConfig(**self.CFG),
                              optimizer=OptimizerConfig(lr=1e-2),
                              device="cpu")
            self._leaves = lambda: [t.detach().clone().numpy() for _, t in
                                    recover.tree_leaves_with_path(eng.params)]
            self._opt = lambda: [
                v.detach().clone().numpy() if torch.is_tensor(v) else v
                for st in eng.optimizer.state.values()
                for v in st.values()]
        eng.init_random(0)
        eng.setup_optimizer(10)
        constants.set_experiment_trial_names(EXP, TRIAL)
        self.eng, self.faults, self.metrics = eng, f, m
        self.recover, self.constants = recover, constants
        self.worker_base = worker_base
        self.loss_fn = sft_loss_fn

        class EmptyStream:
            def get_batch(self, n, timeout=0.1):
                return []

            def clear(self):
                return 3    # three suspect trajectories were in flight

        self.worker = AsyncPPOTrainerWorker(
            experiment_name=EXP, trial_name=TRIAL, actor_engine=eng,
            stream=EmptyStream(),
            hp=PPOHyperparameters(disable_value=True, kl_ctl=0.0),
            control=TrainerControl(total_train_steps=10,
                                   guard_rollback_steps=2),
            train_batch_size=2, hf_family="qwen2")
        rng = np.random.default_rng(0)
        lens = [6, 9, 7]
        self.sample = SequenceSample.from_default(
            ids=[0, 1, 2], seqlens=lens, data={
                "packed_input_ids": rng.integers(0, 64, sum(lens)).astype(
                    np.int64),
                "prompt_mask": np.concatenate([
                    np.r_[np.ones(2, bool), np.zeros(n - 2, bool)]
                    for n in lens])})
        self.mb = MicroBatchSpec(n_mbs=1, max_tokens_per_mb=64)

    def step(self):
        stats = self.eng.train_batch(self.sample, self.mb, self.loss_fn)
        return {"guard/step_ok": float(stats["guard/step_ok"])}

    def flush(self, *oks):
        self.worker._pending_stats = [
            (i, time.time(), {"guard/step_ok": ok}) for i, ok in enumerate(oks)]
        self.worker.flush_stats()
        self.worker._join_publish()


def _train_step_trip(t):
    out = []
    t.flush(0.0, 0.0)             # no committed checkpoint: rollback fails
    t.worker.save_recover_checkpoint()
    t.flush(t.step()["guard/step_ok"])     # AdamW state exists from here
    p0, o0 = t._leaves(), t._opt()
    t.faults.inject("train.step", action="trip", times=1)
    st = t.step()
    out.append(st["guard/step_ok"])
    same = all(np.array_equal(a, b) for a, b in zip(p0, t._leaves()))
    same_opt = all(np.array_equal(np.asarray(a), np.asarray(b))
                   for a, b in zip(o0, t._opt()))
    out += [same, same_opt]
    t.flush(st["guard/step_ok"])
    out.append(t.worker._consec_anomalies)
    st = t.step()                 # untripped: the weights move
    out.append(st["guard/step_ok"])
    out.append(not all(np.array_equal(a, b)
                       for a, b in zip(p0, t._leaves())))
    t.flush(st["guard/step_ok"])
    v_live = t.eng.version
    t.flush(0.0, 0.0)             # two in a row: roll back and republish
    out += [t.worker._consec_anomalies, t.eng.version - v_live]
    return out


def _ckpt_save_mid_save(t):
    t.worker.step = 5
    t.eng.version = 5
    t.worker.save_recover_checkpoint()
    actor = os.path.join(t.constants.get_recover_root(), "trainer", "actor")
    t.worker.step = 9
    t.eng.version = 9
    t.faults.inject("ckpt.save", times=1)
    try:
        t.worker.save_recover_checkpoint()
        raised = False
    except t.faults.FaultInjected:
        raised = True
    t.faults.reset()
    resolved = t.recover.resolve_committed(actor)
    return [raised, resolved == actor,
            t.recover.read_manifest(actor)["version"]]


def _signal_term(t):
    t.worker.step = 3
    t.eng.version = 3
    sd = t.worker_base.GracefulShutdown(deadline_s=30.0, install=False)
    t.faults.inject("signal.term", action="trip", times=1)
    t.worker.run(shutdown=sd)
    actor = os.path.join(t.constants.get_recover_root(), "trainer", "actor")
    return [t.worker.preempted, t.recover.read_manifest(actor)["version"]]


TRAINER_SCENARIOS = {
    "train_step_trip": (_train_step_trip, {
        "faults/train.step": 1, "guard/anomalous_steps": 5,
        "guard/update_skipped": 5, "guard/rollback_failed": 1,
        "guard/rollbacks": 1, "ft/stale_dropped_on_recover": 3}),
    "ckpt_save_mid_save": (_ckpt_save_mid_save, {"faults/ckpt.save": 1}),
    "signal_term_preemption": (_signal_term, {
        "faults/signal.term": 1, "ft/preemptions": 1}),
}


@pytest.mark.parametrize("scenario", sorted(TRAINER_SCENARIOS))
def test_trainer_scenario_counts_like_the_reference(scenario, tmp_path,
                                                    monkeypatch):
    fn, expected = TRAINER_SCENARIOS[scenario]
    got = {}
    for name in ("ref", "port"):
        t = TrainerPkg(name, tmp_path, monkeypatch)
        before = t.metrics.counters.snapshot()
        result = fn(t)
        t.faults.reset()
        got[name] = (result, _delta(t.metrics, before))
    assert got["port"] == got["ref"]
    assert got["port"][1] == expected
    result = got["port"][0]
    if scenario == "train_step_trip":
        # the tripped step: skipped, params and AdamW state bit-equal; the
        # next one moves the weights; the rollback republishes a version
        assert result == [0.0, True, True, 1, 1.0, True, 0, 1]
    elif scenario == "ckpt_save_mid_save":
        assert result == [True, True, 5]
    else:
        assert result == [True, 3]
