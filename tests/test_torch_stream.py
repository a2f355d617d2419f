"""``/generate_stream`` on the port's standard-library server and the
client's ``generate_stream``, on a CPU engine (the counterparts of
``areal_tpu/gen/server.py::_generate_stream`` and
``areal_tpu/gen/client.py::generate_stream``): the route table against
the reference's, deltas that concatenate to ``/generate``'s answer, the
final frame and ``data: [DONE]``, a disconnect freeing its slot, the
deadline frame, the reference's 400 texts, and the client's retry only
before the stream opens."""

import asyncio
import json
import socket
import time
import urllib.request

import pytest
import torch

from areal_tpu.gen import server as jax_server
from areal_tpu_torch.base import http
from areal_tpu_torch.gen import client as pt_client
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


def _engine(**kw):
    params = pt_tfm.init_params(CFG, seed=2, device="cpu")
    return pt_engine.GenerationEngine(CFG, params, max_slots=2,
                                      max_seqlen=1024, page_size=8,
                                      device="cpu", **kw)


@pytest.fixture
def server():
    srv = pt_server.serve(_engine(), "127.0.0.1", 0, decode_steps=4)
    yield srv
    srv.stop()


def _post(port, path, body=None, raw=None):
    data = raw if raw is not None else json.dumps(body).encode()
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=data,
                                 method="POST")
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, r.headers.get("Content-Type"), r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers.get("Content-Type"), e.read()


def _frames(raw: bytes):
    """The ``data:`` payloads of an SSE body, in order (comments and blank
    separators dropped)."""
    return [ln[len(b"data:"):].strip().decode()
            for ln in raw.split(b"\n") if ln.startswith(b"data:")]


def _body(rid, ids, n, **sp):
    return {"rid": rid, "input_ids": ids,
            "sampling_params": {"max_new_tokens": n, "greedy": True, **sp}}


def test_route_table_is_the_references_minus_spec_decode(server):
    """The port's routes are the (method, path) pairs the reference's
    ``_bind_routes`` registers on a bare aiohttp Application (no engine
    built), ``/spec_decode`` included now that speculative decoding is
    ported (the test keeps the name it had while that route was missing)."""
    web = pytest.importorskip("aiohttp.web")
    ref = object.__new__(jax_server.GenerationHTTPServer)
    app = web.Application()
    ref._bind_routes(app)
    want = {(r.method, r.resource.canonical) for r in app.router.routes()
            if r.method != "HEAD"}
    assert ("POST", "/spec_decode") in want
    assert set(server.routes()) == want


def test_spec_decode_toggle_and_metrics(server):
    """``POST /spec_decode`` flips the engine between chunks and answers
    the reference's fields; a body without ``enabled`` is a 400; greedy
    answers are the same either way, and ``/metrics_json`` reports the
    spec config and accept counters."""
    ids = [3, 1, 4, 1, 5, 9, 2, 6, 5, 3, 5, 8]
    status, _, raw = _post(server.port, "/generate", _body("v", ids, 17))
    vanilla = json.loads(raw)["output_ids"]
    status, _, raw = _post(server.port, "/spec_decode", {"enabled": True})
    assert status == 200
    assert json.loads(raw) == {"success": True, "spec_decode": True,
                               "spec_k": server.engine.spec_k}
    assert server.engine.spec
    status, _, raw = _post(server.port, "/generate", _body("s", ids, 17))
    assert json.loads(raw)["output_ids"] == vanilla
    status, _, raw = _post(server.port, "/spec_decode", {})
    assert status == 400 and server.engine.spec
    with urllib.request.urlopen(
            f"http://127.0.0.1:{server.port}/metrics_json", timeout=60) as r:
        m = json.loads(r.read())
    assert m["spec_decode"] is True and m["spec_k"] == m["spec_k_current"]
    assert m["engine_spec_draft_tokens"] > 0 and 0 <= m[
        "spec_accept_rate"] <= 1
    assert m["spec_draft_model"] is False and m["draft_kv_pool_bytes"] == 0
    status, _, raw = _post(server.port, "/spec_decode", {"enabled": False})
    assert json.loads(raw)["spec_decode"] is False and not server.engine.spec


def test_stream_deltas_concatenate_to_the_generate_answer(server):
    """A greedy stream's deltas concatenate to ``/generate``'s answer for
    the same request; the final frame carries ``finish_reason`` and
    ``version``, and ``data: [DONE]`` ends the body."""
    ids = [3, 1, 4, 1, 5, 9, 2, 6, 5, 3, 5]
    status, _, raw = _post(server.port, "/generate", _body("a", ids, 23))
    want = json.loads(raw)
    assert status == 200
    status, ctype, raw = _post(server.port, "/generate_stream",
                               _body("b", ids, 23))
    assert status == 200 and ctype == "text/event-stream"
    frames = _frames(raw)
    assert frames[-1] == "[DONE]"
    events = [json.loads(f) for f in frames[:-1]]
    # a delta per harvested chunk (four steps each), then the final frame
    assert len(events) >= 3
    assert all(e["rid"] == "b" and e["finish_reason"] is None
               for e in events[:-1])
    last = events[-1]
    assert last["finish_reason"] == want["finish_reason"] == "length"
    assert last["version"] == want["version"] == 0
    toks = [t for e in events for t in e["token_ids"]]
    lps = [x for e in events for x in e["logprobs"]]
    assert toks == want["output_ids"] and len(toks) == 23
    assert lps == pytest.approx(want["output_logprobs"], abs=1e-6)
    assert server.engine.free_slots() == 2


def test_a_disconnect_cancels_and_frees_the_slot(server):
    """A client that reads the first frame and hangs up frees its slot
    within a chunk or two; the next request is served."""
    eng = server.engine
    sock = socket.create_connection(("127.0.0.1", server.port))
    data = json.dumps(_body("gone", [7, 8, 9], 1000)).encode()
    sock.sendall(b"POST /generate_stream HTTP/1.1\r\nHost: x\r\n"
                 b"Content-Type: application/json\r\n"
                 + f"Content-Length: {len(data)}\r\n\r\n".encode() + data)
    got = b""
    while b"data: {" not in got:
        chunk = sock.recv(4096)
        assert chunk
        got += chunk
    assert eng.free_slots() == 1
    steps = eng.stats["decode_steps"]
    sock.close()
    deadline = time.time() + 30
    while eng.free_slots() < 2:
        assert time.time() < deadline, "the slot was never freed"
        time.sleep(0.01)
    # noticed before the next frame's write and cancelled between two
    # steps: a chunk or two (of 4 steps) later, a few more on a busy host
    assert eng.stats["decode_steps"] - steps <= 8 * 4
    assert eng.n_running() == 0 and eng.n_pending() == 0
    status, _, raw = _post(server.port, "/generate", _body("next", [1, 2], 3))
    assert status == 200 and len(json.loads(raw)["output_ids"]) == 3
    with server._streams_lock:
        assert not server._streams


def test_deadline_ends_the_stream_and_cancels(server):
    """``deadline_s`` runs out mid-generation: a ``"deadline"`` final frame,
    ``[DONE]``, and the slot freed."""
    t0 = time.monotonic()
    body = dict(_body("slow", [7, 8, 9], 1000), deadline_s=0.4)
    status, _, raw = _post(server.port, "/generate_stream", body)
    assert status == 200 and time.monotonic() - t0 < 30
    frames = _frames(raw)
    assert frames[-1] == "[DONE]"
    final = json.loads(frames[-2])
    assert final == {"rid": "slow", "token_ids": [], "logprobs": [],
                     "finish_reason": "deadline"}
    deadline = time.time() + 30
    while server.engine.free_slots() < 2:
        assert time.time() < deadline
        time.sleep(0.01)


BAD_BODIES = [
    [1, 2],
    {"input_ids": [1]},
    {"rid": "x", "input_ids": []},
    {"rid": "x", "input_ids": [1, 999]},
    {"rid": "x", "input_ids": [1], "sampling_params": {"top_p": 0.0}},
    {"rid": "x", "input_ids": [1] * 100,
     "sampling_params": {"max_new_tokens": 1000}},
]


@pytest.mark.parametrize("i", range(len(BAD_BODIES)))
def test_bad_bodies_get_the_reference_400_texts(server, i):
    body = BAD_BODIES[i]
    eng = server.engine
    with pytest.raises(jax_server.RequestValidationError) as ref:
        jax_server.parse_generate_request(body, CFG.vocab_size, eng.S, eng.G)
    status, ctype, raw = _post(server.port, "/generate_stream", body)
    assert (status, json.loads(raw)) == (400, {"error": str(ref.value)})
    assert ctype == "application/json"


def test_bad_json_and_bad_deadline_are_400s(server):
    assert _post(server.port, "/generate_stream", raw=b"{nope")[::2] == (
        400, b'{"error": "body is not valid JSON"}')
    body = dict(_body("d", [1, 2], 3), deadline_s="soon")
    status, _, raw = _post(server.port, "/generate_stream", body)
    assert (status, json.loads(raw)) == (
        400, {"error": "'deadline_s' must be a number"})
    assert server.engine.n_pending() == 0


def _collect(url, rid, ids, n, client=None, **kw):
    client = client or pt_client.GenAPIClient(timeout=60)

    async def go():
        return [f async for f in client.generate_stream(
            url, rid, ids, {"max_new_tokens": n, "greedy": True}, **kw)]

    return asyncio.run(go())


def test_client_generate_stream_yields_the_servers_frames(server):
    """The client yields the server's frames (``[DONE]`` consumed), and the
    deadline is forwarded in the body."""
    url = f"http://127.0.0.1:{server.port}"
    ids = [5, 6, 7, 8, 9, 10, 11]
    frames = _collect(url, "c", ids, 13)
    _, _, raw = _post(server.port, "/generate_stream", _body("c2", ids, 13))
    want = [json.loads(f) for f in _frames(raw)[:-1]]
    assert [t for f in frames for t in f["token_ids"]] == [
        t for f in want for t in f["token_ids"]]
    assert frames[-1]["finish_reason"] == "length"
    assert frames[-1]["version"] == 0
    assert all(f["finish_reason"] is None for f in frames[:-1])
    late = _collect(url, "d", ids, 1000, deadline_s=0.3)
    assert late[-1]["finish_reason"] == "deadline"


def test_client_set_spec_decode_toggles_the_server(server):
    """``GenAPIClient.set_spec_decode`` posts the reference's body and
    returns the server's answer."""
    url = f"http://127.0.0.1:{server.port}"
    client = pt_client.GenAPIClient(timeout=60)
    on = asyncio.run(client.set_spec_decode(url, True))
    assert on["spec_decode"] is True and server.engine.spec
    off = asyncio.run(client.set_spec_decode(url, 0))
    assert off == {"success": True, "spec_decode": False,
                   "spec_k": server.engine.spec_k}
    assert not server.engine.spec


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_client_retries_only_before_the_stream_opens():
    """A refused connection is retried (up to ``max_attempts``); a 400 is
    not; a stream dropped before ``[DONE]`` raises without a retry; a
    deadline shorter than the backoff raises ``DeadlineExceeded``."""
    retry = pt_client.RetryPolicy(max_attempts=3, backoff_base_s=0.01)
    dead = f"http://127.0.0.1:{_free_port()}"
    client = pt_client.GenAPIClient(timeout=10, retry=retry, seed=0)
    with pytest.raises(pt_client.ClientConnectionError):
        _collect(dead, "r", [1, 2], 3, client=client)
    assert client.retries == 2
    slow = pt_client.RetryPolicy(max_attempts=3, backoff_base_s=5.0,
                                 jitter=0.0)
    client = pt_client.GenAPIClient(timeout=10, retry=slow)
    with pytest.raises(pt_client.DeadlineExceeded):
        _collect(dead, "r", [1, 2], 3, client=client, deadline_s=1.0)
    assert client.retries == 0

    def dropped(body):
        def frames():
            yield b'data: {"rid": "r", "token_ids": [1], "logprobs": [0.0], ' \
                  b'"finish_reason": null}\n\n'
            raise RuntimeError("the server died mid-stream")
        return 200, http.Stream(frames())

    def bad(body):
        return 400, {"error": "nope"}

    httpd, thread = http.start_server(
        {("POST", "/generate_stream"): dropped}, "127.0.0.1", 0, "t-drop")
    try:
        url = f"http://127.0.0.1:{httpd.server_address[1]}"
        client = pt_client.GenAPIClient(timeout=10, retry=retry)
        got = []

        async def go():
            async for f in client.generate_stream(url, "r", [1], {}):
                got.append(f)

        with pytest.raises(pt_client.ClientConnectionError, match="DONE"):
            asyncio.run(go())
        assert got and got[0]["token_ids"] == [1]
        assert client.retries == 0
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join()
    httpd, thread = http.start_server(
        {("POST", "/generate_stream"): bad}, "127.0.0.1", 0, "t-bad")
    try:
        url = f"http://127.0.0.1:{httpd.server_address[1]}"
        client = pt_client.GenAPIClient(timeout=10, retry=retry)
        with pytest.raises(pt_client.ClientResponseError) as e:
            _collect(url, "r", [1], 2, client=client)
        assert e.value.status == 400 and client.retries == 0
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join()


def test_pause_ends_a_stream_as_interrupted(server):
    """``/pause_generation`` harvests a streaming request: its final frame
    is ``"interrupted"``, and its deltas hold every token generated."""
    url = f"http://127.0.0.1:{server.port}"
    client = pt_client.GenAPIClient(timeout=60)
    frames = []

    async def go():
        async for f in client.generate_stream(
                url, "p", [4, 5, 6], {"max_new_tokens": 1000, "greedy": True}):
            frames.append(f)
            if len(frames) == 2:
                await asyncio.to_thread(
                    _post, server.port, "/pause_generation", {})

    asyncio.run(go())
    assert frames[-1]["finish_reason"] == "interrupted"
    n = sum(len(f["token_ids"]) for f in frames)
    assert 0 < n < 1000
    assert server.engine.free_slots() == 2
    _post(server.port, "/continue_generation", {})
