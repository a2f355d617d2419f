"""The port's standard-library generation server on a CPU engine: the
/generate, /health, /metrics_json, /pause_generation and
/continue_generation routes, 400 answers with the same texts as
``areal_tpu.gen.server.parse_generate_request``, and 500 once the engine
has failed (the server never carries on without it)."""

import json
import threading
import time
import urllib.error
import urllib.request

import pytest
import torch

from areal_tpu.gen import server as jax_server
from areal_tpu_torch.gen import engine as pt_engine
from areal_tpu_torch.gen import server as pt_server
from areal_tpu_torch.models import transformer as pt_tfm
from areal_tpu_torch.models.config import ModelConfig


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tensors here are tiny, so torch's intra-op thread pool buys nothing;
    one pool per test worker crowds out the timing-sensitive tests that
    other workers run beside this file."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


CFG = ModelConfig(n_layers=2, n_q_heads=4, n_kv_heads=2, head_dim=8,
                  hidden_dim=32, intermediate_dim=64, vocab_size=128,
                  dtype="float32")


def _engine(max_seqlen=128, **kw):
    params = pt_tfm.init_params(CFG, seed=2, device="cpu")
    return pt_engine.GenerationEngine(CFG, params, max_slots=2,
                                      max_seqlen=max_seqlen, page_size=8,
                                      device="cpu", **kw)


@pytest.fixture
def server():
    srv = pt_server.serve(_engine(), "127.0.0.1", 0, decode_steps=4)
    yield srv
    srv.stop()


def _call(port, path, body=None, raw=None):
    data = raw if raw is not None else (
        None if body is None else json.dumps(body).encode()
    )
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=data,
        method="GET" if data is None else "POST",
    )
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_generate_matches_a_direct_engine_run(server):
    body = {"rid": "a", "input_ids": [3, 1, 4, 1, 5, 9, 2, 6, 5],
            "sampling_params": {"max_new_tokens": 7, "greedy": True}}
    status, ans = _call(server.port, "/generate", body)
    assert status == 200
    assert set(ans) == {"rid", "output_ids", "output_logprobs",
                        "finish_reason", "version"}
    eng = _engine()
    eng.submit(pt_engine.GenRequest(rid="a", input_ids=body["input_ids"],
                                    max_new_tokens=7, greedy=True))
    (want,) = eng.run_until_done(decode_steps=4)
    assert ans["rid"] == "a" and ans["output_ids"] == want.output_ids
    assert ans["finish_reason"] == "length" and ans["version"] == 0
    assert len(ans["output_logprobs"]) == 7


def test_concurrent_requests_health_and_metrics(server):
    assert _call(server.port, "/health") == (200, {"status": "ok"})
    bodies = [{"rid": f"r{i}", "input_ids": [1 + i] * 12,
               "sampling_params": {"max_new_tokens": 5, "temperature": 1.0,
                                   "top_p": 0.9}} for i in range(5)]
    results = {}

    def go(b):
        results[b["rid"]] = _call(server.port, "/generate", b)

    threads = [threading.Thread(target=go, args=(b,)) for b in bodies]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert all(s == 200 and len(a["output_ids"]) == 5
               for s, a in results.values())
    status, m = _call(server.port, "/metrics_json")
    assert status == 200
    assert m["served"] == 5 and m["gen_tokens"] == 25 and m["running"] == 0
    assert m["max_slots"] == 2 and m["slot_capacity"] == 128
    assert m["kv_dtype"] == "float32" and m["engine_admitted"] == 5
    assert m["pages_free"] + m["prefix_pages"] == m["pages_total"]
    assert m["fused_sample"] is False and m["engine_fused_sample_steps"] == 0
    assert m["n_weight_updates"] == 0
    assert _call(server.port, "/nope")[0] == 404


def test_pipelined_engine_answers_every_request():
    """Behind the server a pipelined engine harvests each chunk one step
    late: the engine loop keeps stepping while a chunk is in flight, so
    the last finishes are answered too, and /metrics_json reports the
    chunk counters."""
    srv = pt_server.serve(_engine(pipeline_chunks=True), "127.0.0.1", 0,
                          decode_steps=4)
    bodies = [{"rid": f"r{i}", "input_ids": [2 + i] * (3 + i),
               "sampling_params": {"max_new_tokens": 3 + 2 * i,
                                   "greedy": True}} for i in range(5)]
    results = {}
    try:
        threads = [threading.Thread(
            target=lambda b=b: results.update(
                {b["rid"]: _call(srv.port, "/generate", b)}))
            for b in bodies]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
        assert not any(t.is_alive() for t in threads)
        status, m = _call(srv.port, "/metrics_json")
        inflight = srv.engine.has_inflight
    finally:
        srv.stop()
    assert status == 200 and not inflight
    for b in bodies:
        code, ans = results[b["rid"]]
        n = b["sampling_params"]["max_new_tokens"]
        eng = _engine()
        eng.submit(pt_engine.GenRequest(rid=b["rid"], input_ids=b["input_ids"],
                                        max_new_tokens=n, greedy=True))
        (want,) = eng.run_until_done(decode_steps=4)
        assert code == 200 and ans["output_ids"] == want.output_ids
        assert ans["finish_reason"] == "length"
    assert m["pipeline_chunks"] is True and m["served"] == 5
    assert m["running"] == 0 and m["pending"] == 0
    assert m["chunk_flag_fetches"] == m["engine_chunk_flag_fetches"] > 0
    assert m["chunk_flag_blocked"] == 0          # the CPU copies at once
    # a CPU engine runs its chunk programs eagerly: no graph
    assert m["graph_captures"] == m["graph_replays"] == 0


def test_metrics_show_the_fused_sampler(monkeypatch):
    monkeypatch.setenv("AREAL_FUSED_SAMPLE", "1")
    srv = pt_server.serve(_engine(), "127.0.0.1", 0, decode_steps=4)
    try:
        bodies = [
            {"rid": "g", "input_ids": [3, 1, 4, 1, 5],
             "sampling_params": {"max_new_tokens": 6, "greedy": True}},
            {"rid": "p", "input_ids": [2, 7, 1, 8],
             "sampling_params": {"max_new_tokens": 6, "top_p": 0.8}},
        ]
        answers = [_call(srv.port, "/generate", b) for b in bodies]
        status, m = _call(srv.port, "/metrics_json")
    finally:
        srv.stop()
    assert all(s == 200 and len(a["output_ids"]) == 6 for s, a in answers)
    assert m["fused_sample"] is True
    assert m["engine_fused_sample_steps"] == m["engine_decode_steps"] > 0
    assert m["engine_sampler_fallback_rows"] > 0
    monkeypatch.delenv("AREAL_FUSED_SAMPLE")
    eng = _engine()
    eng.submit(pt_engine.GenRequest(rid="g", input_ids=[3, 1, 4, 1, 5],
                                    max_new_tokens=6, greedy=True))
    assert answers[0][1]["output_ids"] == eng.run_until_done(4)[0].output_ids


def test_metrics_dump_at_intervals_and_on_stop(tmp_path):
    """``metrics_dump_path``: the ``/metrics_json`` body lands in the file
    at start, every 10 s and at stop (the reference's dump), whole."""
    path = tmp_path / "gen_server_0.json"
    srv = pt_server.serve(_engine(), "127.0.0.1", 0, decode_steps=4,
                          metrics_dump_path=str(path))
    try:
        deadline = time.monotonic() + 30
        while not path.exists() and time.monotonic() < deadline:
            time.sleep(0.01)
        first = json.loads(path.read_text())
        assert first["served"] == 0
        status, answer = _call(srv.port, "/generate", {
            "rid": "g", "input_ids": [3, 1, 4, 1, 5],
            "sampling_params": {"max_new_tokens": 6, "greedy": True}})
        assert status == 200
    finally:
        srv.stop()
    last = json.loads(path.read_text())
    assert last["served"] == 1 and last["gen_tokens"] == 6
    assert last["engine_decode_steps"] > 0
    assert set(last["kernel_launches"]) == {
        "paged_decode", "flash_fwd", "flash_bwd", "fused_sample"}
    assert not list(tmp_path.glob("*.tmp"))


@pytest.fixture
def long_server():
    """Slots long enough that a request is still running when the pause
    lands, however fast the engine steps."""
    srv = pt_server.serve(_engine(max_seqlen=1024), "127.0.0.1", 0,
                          decode_steps=4)
    yield srv
    srv.stop()


def test_pause_interrupts_and_continue_resumes(long_server):
    server = long_server
    got = {}
    body = {"rid": "long", "input_ids": [7, 8, 9],
            "sampling_params": {"max_new_tokens": 1000, "greedy": True}}
    t = threading.Thread(
        target=lambda: got.update(ans=_call(server.port, "/generate", body))
    )
    t.start()
    deadline = time.time() + 60
    while server.engine.stats["decode_steps"] < 4:
        assert time.time() < deadline
        time.sleep(0.01)
    assert _call(server.port, "/pause_generation", {}) == (
        200, {"num_paused_requests": 1}
    )
    t.join(60)
    status, ans = got["ans"]
    assert status == 200 and ans["finish_reason"] == "interrupted"
    assert 0 < len(ans["output_ids"]) < 1000
    assert _call(server.port, "/metrics_json")[1]["paused"] is True
    assert _call(server.port, "/continue_generation", {}) == (
        200, {"success": True}
    )
    status, ans = _call(server.port, "/generate", {
        "rid": "after", "input_ids": [1, 2],
        "sampling_params": {"max_new_tokens": 2, "greedy": True},
    })
    assert status == 200 and len(ans["output_ids"]) == 2


BAD_BODIES = [
    [1, 2],
    {"input_ids": [1]},
    {"rid": "x", "input_ids": []},
    {"rid": "x", "input_ids": ["a"]},
    {"rid": "x", "input_ids": [1, 999]},
    {"rid": "x", "input_ids": [1], "sampling_params": []},
    {"rid": "x", "input_ids": [1], "sampling_params": {"max_new_tokens": "z"}},
    {"rid": "x", "input_ids": [1], "sampling_params": {"max_new_tokens": 0}},
    {"rid": "x", "input_ids": [1],
     "sampling_params": {"max_new_tokens": 2, "min_new_tokens": 3}},
    {"rid": "x", "input_ids": [1], "sampling_params": {"temperature": -1}},
    {"rid": "x", "input_ids": [1], "sampling_params": {"top_p": 0.0}},
    {"rid": "x", "input_ids": [1], "sampling_params": {"top_k": 0}},
    {"rid": "x", "input_ids": [1] * 100,
     "sampling_params": {"max_new_tokens": 50}},
]


@pytest.mark.parametrize("i", range(len(BAD_BODIES)))
def test_bad_requests_get_the_reference_400_texts(server, i):
    body = BAD_BODIES[i]
    eng = server.engine
    with pytest.raises(jax_server.RequestValidationError) as ref:
        jax_server.parse_generate_request(body, CFG.vocab_size, eng.S, eng.G)
    assert _call(server.port, "/generate", body) == (
        400, {"error": str(ref.value)}
    )


def test_invalid_json_is_a_400(server):
    assert _call(server.port, "/generate", raw=b"{nope") == (
        400, {"error": "body is not valid JSON"}
    )


def test_engine_failure_answers_500(server):
    def boom(decode_steps=16):
        raise RuntimeError("kernel launch failed")

    server.engine.step = boom
    status, ans = _call(server.port, "/generate", {
        "rid": "z", "input_ids": [1, 2],
        "sampling_params": {"max_new_tokens": 2},
    })
    assert status == 500 and "kernel launch failed" in ans["error"]
    assert _call(server.port, "/health")[0] == 500
