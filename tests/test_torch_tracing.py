"""The port's span plane, profiler plane and trace join
(``areal_tpu_torch/base/tracing.py``, ``system/tracejoin.py``) against
``areal_tpu``'s: traceparent parsing on the reference's malformed cases,
span records, nesting and context propagation, the bounded ring and its
drop counter, flushes read across the packages in both directions, the
Chrome trace / span tree / rendering of one span list, and
``maybe_trace`` writing a ``torch.profiler`` trace on the CPU.

Every test resets the span ring and the knobs it sets, so other files in
the same worker see a clean process.
"""

import json
import os

import numpy as np
import pytest
import torch

from areal_tpu.base import tracing as ref_tracing
from areal_tpu.system import tracejoin as ref_join
from areal_tpu_torch.base import constants
from areal_tpu_torch.base import metrics as pt_metrics
from areal_tpu_torch.base import tracing
from areal_tpu_torch.system import tracejoin


@pytest.fixture(autouse=True)
def _clean_ring(monkeypatch):
    monkeypatch.delenv(constants.TRACE_ENV, raising=False)
    monkeypatch.delenv(constants.TRACE_SPANS_ENV, raising=False)
    monkeypatch.delenv(constants.TRACE_RING_ENV, raising=False)
    tracing.drain()
    ref_tracing.drain()
    yield
    tracing.drain()
    ref_tracing.drain()


BAD_TRACEPARENTS = [
    None, 7, "", "nonsense", "00-zz-ff-01",
    "00-" + "a" * 31 + "-" + "b" * 16 + "-01",   # short trace id
    "00-" + "a" * 32 + "-" + "b" * 15 + "-01",   # short span id
    "00-" + "a" * 32 + "-" + "b" * 16,           # missing flags
    "00-" + "g" * 32 + "-" + "b" * 16 + "-01",   # not hex
]
GOOD_TRACEPARENTS = [
    "00-" + "a" * 32 + "-" + "b" * 16 + "-01",
    "00-" + "0123456789abcdef" * 2 + "-" + "0" * 16 + "-01",
    "  00-" + "F" * 32 + "-" + "1" * 16 + "-00  ",
]


@pytest.mark.parametrize("value", BAD_TRACEPARENTS + GOOD_TRACEPARENTS)
def test_parse_traceparent_matches_the_reference(value):
    assert tracing.parse_traceparent(value) == ref_tracing.parse_traceparent(
        value)
    if value in BAD_TRACEPARENTS:
        assert tracing.parse_traceparent(value) is None


def test_span_records_nesting_and_the_wire_context():
    with tracing.activate(qid="q7") as tid:
        assert tracing.current_qid() == "q7"
        with tracing.span("t/client", rid="r1") as attrs:
            attrs["extra"] = 3
            wire = tracing.wire_context()
            with tracing.span("t/inner"):
                pass
    assert tracing.current() is None and tracing.current_qid() is None
    # the server side of the hop: same trace, parent = the client span
    with tracing.activate(wire) as tid2:
        assert tid2 == tid and tracing.current_qid() == "q7"
        with tracing.span("t/server"):
            pass
    with pytest.raises(KeyError):
        with tracing.span("t/fails"):
            raise KeyError("x")
    spans = {s["name"]: s for s in tracing.drain()}
    assert set(spans) == {"t/client", "t/inner", "t/server", "t/fails"}
    c, i, srv = spans["t/client"], spans["t/inner"], spans["t/server"]
    assert c["trace_id"] == i["trace_id"] == srv["trace_id"] == tid
    assert c["parent_id"] is None
    assert i["parent_id"] == c["span_id"] == srv["parent_id"]
    assert c["attrs"] == {"rid": "r1", "extra": 3, "qid": "q7"}
    assert srv["attrs"] == {"qid": "q7"}
    assert spans["t/fails"]["error"] and spans["t/fails"]["exc"] == "KeyError"
    assert spans["t/fails"]["trace_id"] != tid   # a fresh root
    # the reference's record layout, key for key
    with ref_tracing.activate(qid="q7"):
        with ref_tracing.span("t/client", rid="r1"):
            pass
    ref_rec = ref_tracing.drain()[0]
    assert set(c) == set(ref_rec)
    assert c["pid"] == os.getpid() and c["dur_s"] >= 0
    # accumulating counters, as the reference's span always keeps
    assert pt_metrics.counters.get("t/client_n") >= 1
    assert pt_metrics.counters.get("t/client_s") >= 0


def test_the_wire_context_degrades_like_the_reference():
    for mod in (tracing, ref_tracing):
        assert mod.wire_context() is None           # no active context
        assert mod.wire_context(qid="q")["qid"] == "q"
        # malformed wire context roots a fresh trace
        with mod.activate({"traceparent": "junk", "qid": 5}) as tid:
            assert len(tid) == 32 and mod.current_qid() == "5"
        with mod.activate("00-" + "c" * 32 + "-" + "0" * 16 + "-01") as tid:
            assert tid == "c" * 32
            assert mod.current() == {"trace_id": tid, "span_id": ""}


def test_disabled_spans_keep_only_counters(monkeypatch):
    monkeypatch.setenv(constants.TRACE_SPANS_ENV, "0")
    n0 = pt_metrics.counters.get("t/off_n")
    with tracing.activate(qid="q") as tid:
        assert tid is None
        with tracing.span("t/off"):
            assert tracing.live_spans() == []
    assert tracing.drain() == []
    assert tracing.wire_context() is None
    assert pt_metrics.counters.get("t/off_n") == n0 + 1


def test_the_ring_is_bounded_and_counts_drops(monkeypatch):
    monkeypatch.setenv(constants.TRACE_RING_ENV, "3")   # floored at 16
    assert constants.trace_ring_size() == 16
    d0 = pt_metrics.counters.get(pt_metrics.TRACE_DROPPED)
    s0 = pt_metrics.counters.get(pt_metrics.TRACE_SPANS)
    for i in range(20):
        with tracing.span("t/ring", i=i):
            pass
    assert pt_metrics.counters.get(pt_metrics.TRACE_DROPPED) == d0 + 4
    assert pt_metrics.counters.get(pt_metrics.TRACE_SPANS) == s0 + 20
    kept = tracing.drain()
    assert [s["attrs"]["i"] for s in kept] == list(range(4, 20))
    # the flight recorder's tail is never drained
    assert [s["attrs"]["i"] for s in tracing.recent_spans(3)] == [17, 18, 19]


def test_live_spans_show_what_is_open():
    with tracing.span("t/outer"):
        with tracing.span("t/open"):
            live = tracing.live_spans()
    assert [s["name"] for s in live][-2:] == ["t/outer", "t/open"]
    assert all(s["elapsed_s"] >= 0 for s in live)


def _emit_spans(mod, tag):
    with mod.activate(qid=f"{tag}-q"):
        with mod.span(f"{tag}/root", rid=f"{tag}-q-0001"):
            with mod.span(f"{tag}/child"):
                pass


def test_flushes_are_read_across_the_packages(tmp_path):
    """The port's flush read by the reference's ``tracejoin.scan`` and the
    reference's flush by the port's, with a torn last line skipped."""
    root = tmp_path / "trace_spans"
    root.mkdir()
    _emit_spans(tracing, "port")
    _emit_spans(ref_tracing, "ref")
    f0 = pt_metrics.counters.get(pt_metrics.TRACE_FLUSHED_SPANS)
    assert tracing.flush("rollout_worker/0", root=str(root)) == 2
    assert pt_metrics.counters.get(pt_metrics.TRACE_FLUSHED_SPANS) == f0 + 2
    assert ref_tracing.flush("gen_server/0", root=str(root)) == 2
    assert tracing.flush("idle", root=str(root)) == 0
    with open(root / "gen_server_0.jsonl", "a") as f:
        f.write('{"name": "torn", "span_id": ')     # a crashed writer
    assert sorted(p.name for p in root.iterdir()) == [
        "gen_server_0.jsonl", "rollout_worker_0.jsonl"]
    for scan in (ref_join.scan, tracejoin.scan):
        spans = scan(str(tmp_path))
        assert sorted(s["name"] for s in spans) == [
            "port/child", "port/root", "ref/child", "ref/root"]
        assert {s["worker"] for s in spans} == {"rollout_worker/0",
                                                "gen_server/0"}
    assert tracejoin.scan(str(tmp_path)) == ref_join.scan(str(tmp_path))


def _span_list(seed):
    """One synthetic multi-worker span list: two traces, a missing parent,
    an error span, rids and qids."""
    rng = np.random.default_rng(seed)
    t0 = 1.7e9
    spans = []
    for t in range(2):
        tid = f"{t + 10:032x}"
        ids = [f"{t * 100 + i + 1:016x}" for i in range(6)]
        parents = [None, ids[0], ids[1], ids[1], "f" * 16, ids[0]]
        workers = ["rollout_worker/0", "gserver_manager", "gen_server/0",
                   "gen_server/0", "trainer", "rollout_worker/0"]
        for i in range(6):
            spans.append({
                "worker": workers[i], "name": f"n{i}", "trace_id": tid,
                "span_id": ids[i], "parent_id": parents[i],
                "start": t0 + t + float(rng.integers(0, 1000)) / 1000,
                "dur_s": float(rng.integers(1, 500)) / 1000,
                "thread": ["MainThread", "gen-http"][i % 2],
                "pid": 100 + i, "error": i == 3,
                **({"exc": "ValueError"} if i == 3 else {}),
                "attrs": {"qid": f"q{t}", **({"rid": f"q{t}-abcd0123"}
                                            if i == 2 else {})},
            })
    spans.sort(key=lambda s: s["start"])
    return spans


@pytest.mark.parametrize("seed", [0, 1])
def test_chrome_trace_and_span_tree_match_the_reference(seed, tmp_path):
    spans = _span_list(seed)
    tid = spans[0]["trace_id"]
    assert tracejoin.chrome_trace(spans) == ref_join.chrome_trace(spans)
    assert tracejoin.span_tree(spans, tid) == ref_join.span_tree(spans, tid)
    assert tracejoin.render_tree(spans, tid) == ref_join.render_tree(
        spans, tid)
    assert tracejoin.render_tree(spans, "0" * 32) == ref_join.render_tree(
        spans, "0" * 32)
    for needle in ("q0", "q1", "q1-abcd0123", f"{10:032x}"[:12], "nope", ""):
        assert tracejoin.resolve_trace_id(spans, needle) == (
            ref_join.resolve_trace_id(spans, needle))
    doc = tracejoin.chrome_trace(spans)
    pids = {e["pid"] for e in doc["traceEvents"] if e["ph"] == "X"}
    assert len(pids) == 4
    # write_chrome_trace and the CLI over a flushed file
    root = tmp_path / "trace_spans"
    root.mkdir()
    with open(root / "all.jsonl", "w") as f:
        for s in spans:
            f.write(json.dumps(s) + "\n")
    out = tmp_path / "trace.json"
    assert tracejoin.write_chrome_trace(str(out), str(tmp_path)) == 12
    assert json.loads(out.read_text()) == doc
    assert tracejoin.main([str(tmp_path), "--trace", "q1",
                           "--out", str(out)]) == 0
    assert tracejoin.main([str(tmp_path), "--trace", "nope"]) == 1


def test_maybe_trace_writes_a_profiler_trace_on_the_cpu(monkeypatch,
                                                        tmp_path):
    monkeypatch.setenv("AREAL_FILEROOT", str(tmp_path))
    with tracing.maybe_trace("off") as path:
        assert path is None                       # knob off: nothing
    monkeypatch.setenv(constants.TRACE_ENV, "1")
    monkeypatch.setenv("AREAL_TRACE_STEP", "7")
    assert tracing.trace_enabled() and tracing.trace_step() == 7
    with tracing.maybe_trace("unit") as path:
        with tracing.maybe_trace("nested") as inner:
            assert inner is None                  # records into the outer
        with tracing.annotate("mfc:actor_train"):
            torch.ones(8, 8).matmul(torch.ones(8, 8)).sum()
        with tracing.span("t/traced"):
            pass
    assert os.path.dirname(path) == str(tmp_path / "traces" / "unit")
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    names = {e.get("name") for e in events}
    assert "mfc:actor_train" in names and "t/traced" in names
    assert any("mm" in (n or "") for n in names)
