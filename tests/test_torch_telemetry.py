"""The port's telemetry plane, obs CLI and flight recorder
(``areal_tpu_torch/system/{telemetry,worker_base}.py``, ``apps/obs.py``)
against ``areal_tpu``'s: the fleet aggregate over the same three-worker
snapshots (malformed and mismatched ones included), the exporter's
publish round trip through the port's file ``name_resolve`` (read back by
either package's collector), the disabled exporter, the obs renderings of
one aggregate, and the flight recorder's payload, sequence numbers,
``sys.excepthook`` chaining and its preemption and watchdog triggers.

Every test restores what it installs (the recorder, ``sys.excepthook``,
the armed fault rules, the name_resolve default).
"""

import copy
import json
import logging
import sys
import time

import numpy as np
import pytest

from areal_tpu.apps import obs as ref_obs
from areal_tpu.base import metrics as ref_metrics
from areal_tpu.base import name_resolve as ref_nr
from areal_tpu.system import telemetry as ref_tele
from areal_tpu.system import worker_base as ref_wb
from areal_tpu_torch.apps import obs
from areal_tpu_torch.base import constants, faults, name_resolve, names
from areal_tpu_torch.base import metrics as pt_metrics
from areal_tpu_torch.base import tracing
from areal_tpu_torch.system import telemetry, worker_base

EXP, TRIAL = "obs", "t0"


@pytest.fixture(autouse=True)
def _restore():
    saved, ref_saved = name_resolve.default_repository(), ref_nr._DEFAULT
    hook = sys.excepthook
    faults.reset()
    yield
    faults.reset()
    name_resolve.set_repository(saved)
    ref_nr.set_repository(ref_saved)
    rec = worker_base.flight_recorder()
    if rec is not None:
        rec.uninstall()
    sys.excepthook = hook


def _hist_state(m, name, vals):
    reg = m.CounterRegistry()
    for v in vals:
        reg.observe(name, v)
    return reg.export_state()["histograms"][name]


def _snapshots(seed):
    """Three workers' snapshots as the exporters publish them, with one
    malformed histogram state and one histogram whose edges differ."""
    rng = np.random.default_rng(seed)
    m = pt_metrics

    def vals(n, hi=4.0):
        return [float(x) / 64 for x in rng.integers(0, int(hi * 64), n)]

    gen = {
        "v": 1, "worker": "gen_server/0", "role": "gen_server", "step": 2,
        "pid": 11, "time": 1000.0, "spans": [
            {"name": "gen_engine/chunk", "elapsed_s": 0.25,
             "thread": "gen-engine"}],
        "gauges": {"gen_running": 3.0, "kv_pool_bytes": 1e9,
                   "bad_gauge": "x"},
        "counters": {m.GEN_SERVED: 40.0, m.GEN_TOKENS: 5120.0,
                     m.FT_CLIENT_RETRIES: 1.0, m.GEN_SPEC_K_CURRENT: 4.0,
                     m.GEN_SPEC_DRAFT_TOKENS: 100.0,
                     m.GEN_SPEC_ACCEPTED_TOKENS: 30.0},
        "kinds": {m.GEN_SERVED: "sum", m.GEN_TOKENS: "sum",
                  m.FT_CLIENT_RETRIES: "sum", m.GEN_SPEC_K_CURRENT: "gauge",
                  m.GEN_SPEC_DRAFT_TOKENS: "sum",
                  m.GEN_SPEC_ACCEPTED_TOKENS: "sum"},
        "histograms": {
            m.GEN_KV_POOL_OCCUPANCY: _hist_state(
                m, m.GEN_KV_POOL_OCCUPANCY, vals(30, 1.0)),
            m.TTFC_S: {"boundaries": [1.0, 2.0], "counts": [1, 0, 2],
                       "sum": 7.0, "count": 3, "min": 0.5, "max": 3.0},
        },
    }
    mgr = {
        "v": 1, "worker": "gserver_manager", "role": "manager", "step": 2,
        "pid": 12, "time": 1001.5, "spans": [], "gauges": {
            "rollouts_running": 5.0},
        "counters": {m.MANAGER_SCHEDULED: 80.0, m.MANAGER_ALLOCATED: 20.0,
                     m.FT_EVICTIONS: 1.0, m.PIPE_FWD_MAX_IN_FLIGHT: 2.0,
                     m.GEN_SPEC_K_CURRENT: 8.0},
        "kinds": {m.PIPE_FWD_MAX_IN_FLIGHT: "peak"},
        "histograms": {"broken": {"counts": [1]}},
        "server_states": {"http://a": "closed", "http://b": "open"},
    }
    trainer = {
        "v": 1, "worker": "trainer", "role": "trainer", "step": 2,
        "pid": 13, "time": 1002.0, "spans": [], "gauges": {
            "buffer_depth": 4.0, "kv_pool_bytes": 2e9},
        "counters": {m.TRAIN_STEPS: 2.0, m.PIPE_FWD_MAX_IN_FLIGHT: 3.0,
                     m.GUARD_ANOMALOUS_STEPS: 0.0},
        "kinds": {},
        "histograms": {
            m.STALENESS_VERSIONS: _hist_state(
                m, m.STALENESS_VERSIONS, vals(16, 3.0)),
            m.TTFC_S: _hist_state(m, m.TTFC_S, vals(16, 3.0)),
            m.QUEUE_WAIT_S: _hist_state(m, m.QUEUE_WAIT_S, vals(16, 9.0)),
        },
    }
    return [trainer, gen, mgr]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_fleet_aggregate_matches_the_reference(seed):
    snaps = _snapshots(seed)
    port = telemetry.aggregate(copy.deepcopy(snaps))
    ref = ref_tele.aggregate(copy.deepcopy(snaps))
    assert port.scalars() == ref.scalars()
    assert port.counters == ref.counters and port.kinds == ref.kinds
    assert {k: h.state() for k, h in port.histograms.items()} == {
        k: h.state() for k, h in ref.histograms.items()}
    assert port.workers == ref.workers
    s = port.scalars()
    assert s["workers"] == 3 and s["worker_pids"] == 3
    assert s["servers_open"] == 1 and s["servers_closed"] == 1
    assert s[pt_metrics.GEN_SPEC_K_CURRENT] == 8.0    # gauge: fleet max
    assert s[pt_metrics.PIPE_FWD_MAX_IN_FLIGHT] == 3.0
    assert s["kv_pool_bytes"] == 3e9                   # gauges summed
    assert s[pt_metrics.FT_ROLLOUT_DROPPED] == 0.0     # ft/ zero-filled
    # the mismatched ttfc edges: the first by worker name (the gen
    # server's) is kept
    assert port.histograms[pt_metrics.TTFC_S].count == 3


def test_obs_render_matches_the_reference(monkeypatch):
    snaps = _snapshots(0)
    port, ref = telemetry.aggregate(snaps), ref_tele.aggregate(snaps)
    assert obs.render(port, now=1010.0) == ref_obs.render(ref, now=1010.0)
    text = obs.render(port, now=1010.0)
    for role in ("gen_server", "manager", "trainer"):
        assert role in text
    assert "accept_rate=0.300" in text and "http://b" in text


def test_exporter_round_trip_through_the_file_store(tmp_path, monkeypatch):
    """A port exporter publishes through the file ``name_resolve``; both
    packages' collectors read it, ``obs.render_frame`` of the two agree,
    and its publishes flush the span ring to the file root."""
    monkeypatch.setenv("AREAL_FILEROOT", str(tmp_path))
    nr_root = str(tmp_path / "name_resolve")
    name_resolve.reconfigure(name_resolve.NameResolveConfig(
        type="file", root=nr_root))
    ref_nr.reconfigure(ref_nr.NameResolveConfig(type="file", root=nr_root))
    reg = pt_metrics.CounterRegistry()
    reg.add(pt_metrics.GEN_SERVED, 3)
    reg.observe(pt_metrics.TTFC_S, 0.25)
    tracing.drain()
    with tracing.span("t/exported"):
        pass
    ex = worker_base.TelemetryExporter(
        EXP, TRIAL, "gen_server/0", "gen_server", interval=0.05,
        step_fn=lambda: 7, gauges_fn=lambda: {"gen_running": 2.0},
        server_states_fn=lambda: 1 / 0,       # a failing callback
        registry=reg,
    )
    assert ex.enabled
    ex.maybe_start()
    deadline = time.time() + 10
    while ex.published < 2 and time.time() < deadline:
        time.sleep(0.02)
    reg.add(pt_metrics.GEN_SERVED, 1)
    ex.stop()                                # one final publish
    assert ex.published >= 3
    key = names.telemetry(EXP, TRIAL, "gen_server/0")
    snap = json.loads(name_resolve.get(key))
    assert snap["step"] == 7 and snap["role"] == "gen_server"
    assert snap["counters"][pt_metrics.GEN_SERVED] == 4.0
    assert "server_states" not in snap
    for mod in (telemetry, ref_tele):
        got = mod.collect_snapshots(EXP, TRIAL)
        assert [s["worker"] for s in got] == ["gen_server/0"]
    assert telemetry.collect_fleet_scalars(EXP, TRIAL) == (
        ref_tele.collect_fleet_scalars(EXP, TRIAL))
    # a live local snapshot replaces the worker's published one
    local = telemetry.build_snapshot("gen_server/0", "gen_server", step=9,
                                     registry=pt_metrics.CounterRegistry())
    assert telemetry.collect_fleet_scalars(
        EXP, TRIAL, local_snapshot=local).get(pt_metrics.GEN_SERVED) is None
    assert telemetry.collect_fleet_scalars("none", "none") is None
    monkeypatch.setattr(time, "strftime", lambda *a: "12:00:00")
    for as_json in (True, False):
        assert obs.render_frame(EXP, TRIAL, as_json) == ref_obs.render_frame(
            EXP, TRIAL, as_json)
    # the publishes flushed the span ring under the file root
    flushed = (tmp_path / "trace_spans" / "gen_server_0.jsonl").read_text()
    assert "t/exported" in flushed
    # the CLI over the same file root: both packages print the same JSON
    assert obs.discover_trials()[0][:2] == (EXP, TRIAL)
    assert obs.main([str(tmp_path), "--once", "--json"]) == 0
    assert obs.main([str(tmp_path), "--trace", "nothing"]) == 1


def test_the_disabled_exporter_is_a_no_op(monkeypatch):
    monkeypatch.delenv(constants.TELEMETRY_EXPORT_ENV, raising=False)
    name_resolve.set_repository(name_resolve.MemoryNameRecordRepository())
    ex = worker_base.TelemetryExporter(EXP, TRIAL, "w", "trainer")
    assert not ex.enabled and ex.maybe_start() is ex
    assert ex._thread is None
    ex.stop()
    assert ex.published == 0
    assert name_resolve.find_subtree(names.telemetry_root(EXP, TRIAL)) == []
    for raw, want in (("0", 0.0), ("off", 0.0), ("1", 15.0), ("on", 15.0),
                      ("2.5", 2.5), ("junk", 15.0), ("-3", 0.0)):
        monkeypatch.setenv(constants.TELEMETRY_EXPORT_ENV, raw)
        assert constants.telemetry_export_interval() == want
        assert ref_wb.constants.telemetry_export_interval() == want


# --------------------------------------------------------------------------- #
# flight recorder
# --------------------------------------------------------------------------- #


def _recorder(tmp_path, **kw):
    reg = pt_metrics.CounterRegistry()
    return worker_base.FlightRecorder(
        "trainer/0", root=str(tmp_path), span_tail=32, log_tail=50,
        registry=reg, **kw).install()


def test_flight_recorder_payload_matches_the_reference(tmp_path):
    rec = _recorder(tmp_path / "port")
    rec._registry.add(pt_metrics.TRAIN_STEPS, 7)
    logging.getLogger("areal_tpu_torch.fr_test").warning("last words")
    with tracing.span("t/fr_done"):
        pass
    with tracing.span("t/fr_open", rid="r1"):
        path = rec.dump("watchdog", extra={"stalled_s": 12.5})
    rec.uninstall()
    d = json.loads(open(path).read())
    ref_rec = ref_wb.FlightRecorder("trainer/0", root=str(tmp_path / "ref"),
                                    registry=ref_metrics.CounterRegistry())
    ref_d = json.loads(open(ref_rec.dump("watchdog")).read())
    assert set(d) == set(ref_d)
    assert d["schema"] == ref_d["schema"] == 1
    assert d["worker"] == "trainer/0" and d["reason"] == "watchdog"
    assert d["extra"] == {"stalled_s": 12.5}
    assert d["counters"] == {pt_metrics.TRAIN_STEPS: 7.0}
    assert any(s["name"] == "t/fr_done" for s in d["spans"])
    assert any(s["name"] == "t/fr_open" for s in d["open_spans"])
    assert any("last words" in ln for ln in d["log_tail"])
    assert path.endswith(f"trainer_0-{d['pid']}-001-watchdog.json")
    assert not list((tmp_path / "port").glob("*.tmp"))


def test_flight_dump_sequence_numbers_and_module_hook(tmp_path):
    assert worker_base.flight_dump("nothing") is None      # none installed
    n0 = pt_metrics.counters.get(pt_metrics.TRACE_FLIGHT_DUMPS)
    rec = _recorder(tmp_path)
    assert worker_base.flight_recorder() is rec
    p1 = worker_base.flight_dump("a")
    p2 = rec.dump("b")
    assert p1.endswith("-001-a.json") and p2.endswith("-002-b.json")
    assert rec.dumps == 2
    assert pt_metrics.counters.get(pt_metrics.TRACE_FLIGHT_DUMPS) == n0 + 2
    rec.uninstall()
    assert worker_base.flight_recorder() is None
    # an unwritable root degrades to None, never raises
    bad = worker_base.FlightRecorder("x", root=str(tmp_path / "f" / "\0"))
    assert bad.dump("c") is None


def test_excepthook_dumps_then_chains(tmp_path):
    seen = []
    sys.excepthook = lambda *a: seen.append(a[0])
    rec = _recorder(tmp_path)
    assert sys.excepthook == rec._excepthook
    try:
        raise RuntimeError("boom")
    except RuntimeError:
        sys.excepthook(*sys.exc_info())
    assert seen == [RuntimeError]             # the previous hook ran
    (path,) = tmp_path.glob("*-crash.json")
    d = json.loads(path.read_text())
    assert d["extra"]["exc"] == "RuntimeError"
    assert any("boom" in ln for ln in d["extra"]["traceback"])
    rec.uninstall()
    assert sys.excepthook is not rec._excepthook


def test_preemption_request_dumps_once(tmp_path):
    rec = _recorder(tmp_path)
    sd = worker_base.GracefulShutdown(deadline_s=5.0, install=False)
    assert not sd.should_stop()
    faults.inject("signal.term", action="trip", times=1)
    assert sd.should_stop()                   # the scripted SIGTERM
    sd.request()                              # a second request: no dump
    assert sd.should_stop()
    assert [p.name.split("-")[-1] for p in tmp_path.glob("*.json")] == [
        "preempt.json"]
    assert rec.dumps == 1
    assert pt_metrics.counters.get("faults/" + "signal.term") >= 1


def test_watchdog_trip_dumps_and_counts(tmp_path, caplog):
    rec = _recorder(tmp_path)
    n0 = pt_metrics.counters.get(pt_metrics.GUARD_WATCHDOG_DUMPS)
    stalls = []
    wd = worker_base.HangWatchdog("trainer", timeout_s=0.05,
                                  poll_interval=0.01,
                                  on_dump=stalls.append)
    with tracing.span("t/wedged"):
        wd.start()
        deadline = time.time() + 10
        while not stalls and time.time() < deadline:
            time.sleep(0.01)
        wd.stop()
    assert wd.dumps >= 1
    assert pt_metrics.counters.get(pt_metrics.GUARD_WATCHDOG_DUMPS) >= n0 + 1
    dumps = sorted(tmp_path.glob("*-watchdog.json"))
    d = json.loads(dumps[0].read_text())
    assert d["extra"]["timeout_s"] == 0.05
    assert any(s["name"] == "t/wedged" for s in d["open_spans"])
    assert rec.dumps == len(dumps)


# --------------------------------------------------------------------------- #
# the async-PPO world with the plane on
# --------------------------------------------------------------------------- #


def test_the_world_leaves_joinable_traces_and_fleet_lines(tmp_path,
                                                          monkeypatch):
    """``python -m areal_tpu_torch.apps.main async-ppo`` on the CPU with
    telemetry and span flushing on: ``chip_smoke.py``'s own
    ``async_ppo`` checks of what the plane left (span flushes from the
    four workers, one qid's trace across the processes, the obs CLI, the
    ``ppo/`` / ``fleet/`` partition of ``metrics.jsonl``) hold."""
    import os

    import chip_smoke
    from test_torch_launcher import (REPO, _run_world, _world_overrides,
                                     _write_prompt_dataset)

    for k, v in chip_smoke.OBS_WORLD_ENV.items():
        monkeypatch.setenv(k, v)
    # the world's rendezvous under its file root, where obs looks (an
    # in-process entry point run earlier in this process may have set
    # these)
    monkeypatch.delenv("AREAL_NAME_RESOLVE_ROOT", raising=False)
    monkeypatch.delenv("AREAL_NAME_RESOLVE_RPC", raising=False)
    overrides = _world_overrides(tmp_path, "obsw")
    # prompts to spare and a tight gate, so the trained prompts are not
    # rolled out again (a qid resolves to its newest trajectory)
    _write_prompt_dataset(str(tmp_path / "math.jsonl"), n=64)
    rc, out = _run_world(tmp_path, overrides + [
        "gen.device=cpu", "manager.max_head_offpolicyness=1"])
    assert rc == 0, out[-4000:]
    root = tmp_path / "root"
    logs = root / "logs" / "obsw" / "t0"
    lines = [json.loads(ln) for ln in open(logs / "metrics.jsonl")]
    ppo, fleet = chip_smoke.metrics_partition(lines, 2, "cpu")
    dump = json.load(open(logs / "gen_server_0.json"))
    row = chip_smoke.observability_checks(
        str(root), fleet, n_steps=2, groups=4, gen_tokens=dump["gen_tokens"],
        env=dict(os.environ, PYTHONPATH=str(REPO)), label="cpu")
    assert row["chrome_trace_pids"] == 4
    assert set(row["trained_trace_workers"]) == set(chip_smoke.OBS_WORKERS)
    assert {"gen_server/0", "rollout_worker/0"} <= set(row["trace_workers"])
    # every process installed a flight recorder and none dumped
    assert not (root / "flight").exists() or not list(
        (root / "flight").iterdir())
