"""Port parity of the rollout side's host modules against ``areal_tpu``:
the math/code verifiers (every ``tests/test_rewards.py`` parametrisation),
``SequenceSample``'s stream and buffer methods, the staleness-ordered
buffer (the ``tests/test_staleness.py::TestSequenceBuffer`` cases), the
math agent's trajectory from one fixed bundle, the standard-library stream
(a pusher started before its puller; a full queue drops and counts) and
the client's concurrency (16 ``/generate`` calls held in flight at once).
"""

import asyncio
import json
import threading
import time

import numpy as np
import pytest

from areal_tpu.agents.math_single_step import MathSingleStepAgent as RefAgent
from areal_tpu.api.agent import BundledGenerationOutputs as RefBundle
from areal_tpu.api.data import SequenceSample as RefSample
from areal_tpu.api.model import GenerationHyperparameters as RefGconfig
from areal_tpu.envs.math_code_single_step import MathCodeSingleStepEnv as RefEnv
from areal_tpu.rewards import code_verify as ref_code
from areal_tpu.rewards import math_verify as ref_math
from areal_tpu.system import buffer as ref_buffer
from areal_tpu_torch.agents.math_single_step import MathSingleStepAgent
from areal_tpu_torch.api.agent import BundledGenerationOutputs
from areal_tpu_torch.api.data import SequenceSample
from areal_tpu_torch.api.model import GenerationHyperparameters
from areal_tpu_torch.base import http, network
from areal_tpu_torch.envs.math_code_single_step import MathCodeSingleStepEnv
from areal_tpu_torch.gen import client as pt_client
from areal_tpu_torch.rewards import code_verify, math_verify
from areal_tpu_torch.system import buffer as pt_buffer
from areal_tpu_torch.system import push_pull_stream as pps
from areal_tpu_torch.system.stream_dataset import PullerStreamDataset
from tests import test_rewards


def _cases(fn):
    (mark,) = [m for m in fn.pytestmark if m.name == "parametrize"]
    return mark.args[1]


# --------------------------------------------------------------------------- #
# rewards: the reference's verdicts on tests/test_rewards.py's cases
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("text,expected",
                         _cases(test_rewards.test_extract_answer))
def test_extract_answer_matches_reference(text, expected):
    got = math_verify.extract_answer(text)
    assert got == ref_math.extract_answer(text) == expected


_EQ_SUITES = {
    "answers_equal": test_rewards.test_answers_equal,
    "latex_matrix": test_rewards.test_answers_equal_latex_matrix,
    "review": test_rewards.test_answers_equal_review_regressions,
    "grammar": test_rewards.test_answers_equal_latex2sympy_grammar,
}
_EQ_CASES = [(suite, *case) for suite, fn in _EQ_SUITES.items()
             for case in _cases(fn)]


@pytest.mark.parametrize(
    "suite,a,b,eq", _EQ_CASES,
    ids=[f"{s}-{i}" for i, (s, *_) in enumerate(_EQ_CASES)])
def test_answers_equal_matches_reference(suite, a, b, eq):
    got = math_verify.answers_equal(a, b)
    assert got == ref_math.answers_equal(a, b) == eq, (a, b)


def test_verify_solutions_match_reference():
    sol = [r"... the result is \boxed{\frac{3}{4}}"]
    for ans in (r"I think \boxed{0.75}", r"I think \boxed{0.7}", "gibberish"):
        assert math_verify.verify_math_solution(ans, sol) == \
            ref_math.verify_math_solution(ans, sol)
    gen = "```python\nn = int(input())\nprint(n * 2)\n```"
    for io in ({"inputs": ["3\n", "10\n"], "outputs": ["6\n", "20\n"]},
               {"inputs": ["3\n"], "outputs": ["7\n"]}):
        assert code_verify.verify_code_solution(gen, io) == \
            ref_code.verify_code_solution(gen, io)


# --------------------------------------------------------------------------- #
# SequenceSample: the stream's and the buffer's methods
# --------------------------------------------------------------------------- #


def _samples(cls, rng_seed=0):
    rng = np.random.default_rng(rng_seed)
    out = []
    for i, (n, ln) in enumerate(((2, 5), (3, 4), (1, 7))):
        lens = rng.integers(2, 2 + ln, n).tolist()
        out.append(cls(
            keys={"packed_input_ids", "packed_logprobs", "rewards",
                  "version_start"},
            ids=[f"q{i}"],
            seqlens={"packed_input_ids": [lens], "packed_logprobs": [lens],
                     "rewards": [[1] * n], "version_start": [[1] * n]},
            data={"packed_input_ids": rng.integers(0, 99, sum(lens)),
                  "packed_logprobs": rng.standard_normal(sum(lens)).astype(
                      np.float32),
                  "rewards": rng.standard_normal(n).astype(np.float32),
                  "version_start": np.full(n, i, np.int32)},
            metadata={"submit_time": [float(i)]},
        ))
    return out


def _same(a, b):
    assert a.keys == b.keys and list(a.ids) == list(b.ids)
    assert a.seqlens == b.seqlens and a.metadata == b.metadata
    assert a.dtypes == b.dtypes and a.trailing_shapes == b.trailing_shapes
    if a.data is None or b.data is None:
        assert a.data is None and b.data is None
        return
    assert set(a.data) == set(b.data)
    for k in a.data:
        np.testing.assert_array_equal(a.data[k], b.data[k])
        assert a.data[k].dtype == b.data[k].dtype, k


def test_sequence_sample_methods_match_reference():
    pt, ref = _samples(SequenceSample), _samples(RefSample)
    keys = {"packed_input_ids", "rewards"}
    g, rg = SequenceSample.gather(pt), RefSample.gather(ref)
    _same(g, rg)
    _same(SequenceSample.gather(pt, keys=keys), RefSample.gather(ref, keys=keys))
    for a, b in zip(g.unpack(), rg.unpack()):
        _same(a, b)
    _same(g.select(keys), rg.select(keys))
    _same(g.meta(), rg.meta())
    wire = g.as_json_compatible()
    assert json.loads(json.dumps(wire)) == json.loads(
        json.dumps(rg.as_json_compatible()))
    _same(SequenceSample.from_json_compatible(json.loads(json.dumps(wire))),
          RefSample.from_json_compatible(json.loads(json.dumps(wire))))
    _same(SequenceSample.from_json_compatible(wire), g)
    assert g.total_len("packed_input_ids") == rg.total_len("packed_input_ids")
    assert g.cpu_nbytes() == rg.cpu_nbytes() > 0
    data = {"packed_input_ids": np.arange(9), "rewards": np.ones(3)}
    _same(SequenceSample.from_default(["a", "b", "c"], [2, 3, 4], data),
          RefSample.from_default(["a", "b", "c"], [2, 3, 4], dict(data)))
    with pytest.raises(ValueError, match="missing keys"):
        SequenceSample.gather([pt[0], pt[1].select({"rewards"})],
                              keys={"packed_input_ids"})


# --------------------------------------------------------------------------- #
# SequenceBuffer: the reference's cases, both buffers, same pops and drops
# --------------------------------------------------------------------------- #


def _traj(cls, qid, version_start, n=2, ln=6, extra_keys=True):
    lens = [ln] * n
    data = {"packed_input_ids": np.arange(n * ln, dtype=np.int64),
            "rewards": np.ones(n, np.float32)}
    seqlens = {"packed_input_ids": [lens], "rewards": [[1] * n]}
    if extra_keys:
        data["version_start"] = np.full(n, version_start, np.int32)
        seqlens["version_start"] = [[1] * n]
    return cls(keys=set(seqlens), ids=[qid], seqlens=seqlens, data=data)


# (buffer kwargs, [("put", qid, version_start, current) |
#                  ("put_untagged", qid, current) | ("pop", n, current)])
BUFFER_CASES = {
    "version_priority_pop": ({}, [
        ("put", "new", 5, 5), ("put", "old", 1, 5), ("put", "mid", 3, 5),
        ("pop", 2, 5), ("pop", 5, 0)]),
    "overstale_dropped_at_put_and_pop": ({"max_version_lag": 2}, [
        ("put", "ancient", 0, 5), ("put", "ok", 4, 5), ("pop", 1, 9)]),
    "untagged_samples_never_dropped": ({"max_version_lag": 0}, [
        ("put_untagged", "sync", 100), ("pop", 1, 0)]),
    "capacity_drops_oldest": ({"capacity": 2}, [
        ("put", "v1", 1, 1), ("put", "v2", 2, 2), ("put", "v3", 3, 3),
        ("pop", 5, 0)]),
    "window_mix": ({"max_version_lag": 1, "capacity": 3}, [
        ("put", "a", 0, 0), ("put", "b", 1, 1), ("put", "c", 0, 1),
        ("put", "d", 2, 2), ("pop", 1, 2), ("put", "e", 2, 3),
        ("pop", 4, 3)]),
}


def _drive_buffer(buf_mod, cls, kw, ops):
    buf = buf_mod.SequenceBuffer(**kw)
    trace = []
    for op in ops:
        if op[0] == "put":
            buf.put(_traj(cls, op[1], op[2]), current_version=op[3])
        elif op[0] == "put_untagged":
            buf.put(_traj(cls, op[1], 0, extra_keys=False),
                    current_version=op[2])
        else:
            out = buf.pop_batch(op[1], current_version=op[2])
            trace.append([(s.ids[0], buf_mod.sample_version_start(s))
                          for s in out])
        trace.append((len(buf), buf.n_dropped_stale, buf.n_dropped_capacity))
    return trace


@pytest.mark.parametrize("case", sorted(BUFFER_CASES))
def test_sequence_buffer_matches_reference(case):
    kw, ops = BUFFER_CASES[case]
    got = _drive_buffer(pt_buffer, SequenceSample, kw, ops)
    assert got == _drive_buffer(ref_buffer, RefSample, kw, ops)


def test_record_consumption_observes_the_stamps():
    from areal_tpu_torch.base import metrics as pt_metrics

    names = (pt_metrics.STALENESS_VERSIONS, pt_metrics.TTFC_S,
             pt_metrics.REWARD_LAG_S, pt_metrics.QUEUE_WAIT_S,
             pt_metrics.E2E_LATENCY_S)
    for n in names:
        pt_metrics.counters.clear(n)
    t = _traj(SequenceSample, "a", 3)
    now = time.time()
    t.metadata.update(submit_time=[now - 10.0], enqueue_time=[now - 4.0],
                      first_chunk_time=[now - 9.5], reward_time=[now - 2.0])
    pt_buffer.record_batch_consumption([t], current_version=5)
    h = {n: pt_metrics.counters.histogram(n) for n in names}
    assert all(x.count == 1 for x in h.values())
    assert h[pt_metrics.STALENESS_VERSIONS].sum == 2
    assert h[pt_metrics.TTFC_S].sum == pytest.approx(0.5)
    assert h[pt_metrics.REWARD_LAG_S].sum == pytest.approx(8.0)
    assert 4.0 <= h[pt_metrics.QUEUE_WAIT_S].sum < 5.0
    assert 10.0 <= h[pt_metrics.E2E_LATENCY_S].sum < 11.0


# --------------------------------------------------------------------------- #
# the math agent: one fixed bundle -> the identical trajectory
# --------------------------------------------------------------------------- #

PROMPT = [5, 6, 7]
OUTPUTS = [[11, 12, 13, 14], [7], [21, 22]]
META = {"q": {"task": "math", "solutions": [r"\boxed{7}"]}}


class _BoxedFirstToken:
    """Stands in for a tokenizer: decodes a sequence to ``\\boxed{<its
    first token id>}``, so an answer's grade is chosen by its tokens."""

    @staticmethod
    def batch_decode(ids_list, **_):
        return [rf"\boxed{{{ids[0]}}}" for ids in ids_list]


def _collect(agent_cls, bundle_cls, sample_cls, env_cls, gcls, **kw):
    agent = agent_cls(gconfig=gcls(n=3, max_new_tokens=4), **kw)
    agent.tokenizer = _BoxedFirstToken()
    bundle = bundle_cls(
        qid="q", prompt_ids=PROMPT, output_ids=OUTPUTS,
        logprobs=[[-0.5 - i for i, _ in enumerate(o)] for o in OUTPUTS],
        no_eos=[True, False, True], version_start=[0, 0, 1],
        version_end=[1, 0, 1], submit_time=1.0, first_chunk_time=2.0,
    )
    prompt = sample_cls(keys={"packed_prompts"}, ids=["q"],
                        seqlens={"packed_prompts": [[3]]},
                        data={"packed_prompts": np.asarray(PROMPT)})

    async def run():
        obs, act = asyncio.Queue(), asyncio.Queue()
        await act.put(bundle)
        return await agent.collect_trajectory(prompt, env_cls(META), obs, act)

    return asyncio.run(run())


@pytest.mark.parametrize("band", [(0.0, 1.0), (0.5, 1.0)],
                         ids=["kept", "filtered"])
def test_math_agent_builds_the_reference_trajectory(band):
    kw = dict(success_rate_lb=band[0], success_rate_ub=band[1],
              reward_scaling=2.0, reward_bias=0.25)
    got = _collect(MathSingleStepAgent, BundledGenerationOutputs,
                   SequenceSample, MathCodeSingleStepEnv,
                   GenerationHyperparameters, **kw)
    want = _collect(RefAgent, RefBundle, RefSample, RefEnv, RefGconfig, **kw)
    assert len(got) == len(want) == (1 if band[0] == 0.0 else 0)
    if not got:
        return   # one success in three is below the 0.5 floor
    (g,), (w,) = got, want
    assert g.keys == w.keys and g.seqlens == w.seqlens and g.ids == w.ids
    for k in g.keys - {"birth_time"}:
        np.testing.assert_array_equal(g.data[k], w.data[k], err_msg=k)
        assert g.data[k].dtype == w.data[k].dtype, k
    # the "7" answer is the only correct one
    np.testing.assert_allclose(g.data["rewards"],
                               [(-1 - 0.25) * 2, (1 - 0.25) * 2,
                                (-1 - 0.25) * 2])
    lp = g.data["packed_logprobs"][:7]
    np.testing.assert_allclose(lp, [0, 0, -0.5, -1.5, -2.5, -3.5, 0])
    assert set(g.metadata) == set(w.metadata)


# --------------------------------------------------------------------------- #
# the stream, on the standard library
# --------------------------------------------------------------------------- #


def test_stream_delivers_when_the_pusher_starts_first():
    port = network.find_free_port()
    pusher = pps.JsonPusher("127.0.0.1", port)
    for i in range(3):
        assert pusher.push({"i": i, "payload": list(range(i))})
    time.sleep(0.2)   # the sender is retrying its connect meanwhile
    puller = pps.JsonPuller("127.0.0.1", port, default_timeout_ms=2000)
    try:
        got = [puller.pull() for _ in range(3)]
        assert got == [{"i": i, "payload": list(range(i))} for i in range(3)]
        with pytest.raises(pps.Empty):
            puller.pull(timeout_ms=50)
        assert pusher.drop_cnt == 0 and pusher.sent_cnt == 3
    finally:
        pusher.close()
        puller.close()


def test_stream_drops_and_counts_when_its_queue_is_full():
    port = network.find_free_port()   # nobody listens: the queue fills
    pusher = pps.ZMQJsonPusher("127.0.0.1", port, hwm=2)
    t0 = time.monotonic()
    ok = [pusher.push({"i": i}) for i in range(6)]
    assert time.monotonic() - t0 < 1.0          # push never blocks
    # the sender thread may hold one frame while it connects
    assert ok[:2] == [True, True] and sum(ok) in (2, 3)
    assert pusher.drop_cnt == 6 - sum(ok)
    pusher.close()


def test_name_resolving_stream_and_stream_dataset():
    from areal_tpu_torch.base import name_resolve

    name_resolve.reset()
    assert pps.grouping(3, 2) == {0: [0, 2], 1: [1]}
    ds = PullerStreamDataset("s", "t", 0, offline_dataset_size=7,
                             pull_timeout_ms=50)
    pusher = pps.NameResolvingZmqPusher("s", "t", 0, 1, 1)
    try:
        sample = _samples(SequenceSample)[1]
        assert pusher.push(sample.as_json_compatible())
        got = []
        deadline = time.time() + 10
        while not got and time.time() < deadline:
            got = ds.get_batch(4, timeout=0.1)
        assert len(got) == 1 and len(ds) == 7
        _same(got[0], sample)
    finally:
        pusher.close()
        ds.close()
        name_resolve.reset()


def test_file_name_resolve_is_shared_with_the_reference(tmp_path):
    """The file backend's layout is the reference's: a key one package
    writes, the other reads, waits for and lists."""
    from areal_tpu.base import name_resolve as ref_nr
    from areal_tpu_torch.base import name_resolve as pt_nr
    from areal_tpu_torch.base import names

    pt = pt_nr.FileNameRecordRepository(str(tmp_path))
    ref = ref_nr.FileNameRecordRepository(str(tmp_path))
    key = names.gserver_manager("e", "t")
    pt.add(key, "http://a:1")
    assert ref.get(key) == "http://a:1" == ref.wait(key, timeout=1)
    with pytest.raises(pt_nr.NameEntryExistsError):
        pt.add(key, "x")
    ref.add(names.gen_server("e", "t", 0), "u0")
    ref.add(names.gen_server("e", "t", 1), "u1")
    root = names.gen_servers("e", "t")
    assert pt.get_subtree(root) == ref.get_subtree(root) == ["u0", "u1"]
    assert pt.find_subtree(root) == ref.find_subtree(root)
    pt.add(key, "http://b:2", replace=True)
    assert ref.get(key) == "http://b:2"
    pt.reset()
    with pytest.raises(ref_nr.NameEntryNotFoundError):
        ref.get(key)
    with pytest.raises(TimeoutError):
        pt.wait(key, timeout=0.05)
    assert pt.get(names.gen_server("e", "t", 1)) == "u1"


# --------------------------------------------------------------------------- #
# the client: concurrency, retries, status errors
# --------------------------------------------------------------------------- #

N_INFLIGHT = 16


def test_client_holds_16_generate_calls_in_flight():
    """Every stub /generate waits until all 16 have arrived: the calls
    complete only if the client had them in flight at once."""
    barrier = threading.Barrier(N_INFLIGHT, timeout=20)
    peak = {"now": 0, "max": 0}
    lock = threading.Lock()

    def generate(body):
        d = json.loads(body)
        with lock:
            peak["now"] += 1
            peak["max"] = max(peak["max"], peak["now"])
        barrier.wait()
        with lock:
            peak["now"] -= 1
        return 200, {"rid": d["rid"], "output_ids": [1], "output_logprobs":
                     [-0.1], "finish_reason": "length", "version": 0}

    httpd, t = http.start_server({("POST", "/generate"): generate},
                                 "127.0.0.1", 0, "stub")
    url = f"http://127.0.0.1:{httpd.server_address[1]}"

    async def run():
        c = pt_client.GenAPIClient(timeout=30)
        return await asyncio.gather(
            *(c.generate(url, f"r{i}", [1, 2], {"max_new_tokens": 1})
              for i in range(N_INFLIGHT)),
            return_exceptions=True)

    try:
        res = asyncio.run(run())
    finally:
        httpd.shutdown()
        httpd.server_close()
    assert all(isinstance(r, pt_client.APIGenerateResult) for r in res), res
    assert sorted(r.rid for r in res) == sorted(f"r{i}" for i in range(16))
    assert peak["max"] == N_INFLIGHT


def test_client_retry_and_status_semantics():
    calls = {"metrics": 0}

    def metrics(body):
        calls["metrics"] += 1
        if calls["metrics"] < 3:
            return 503, {"error": "restarting"}
        return 200, {"ok": True}

    routes = {
        ("GET", "/metrics_json"): metrics,
        ("POST", "/generate"): lambda b: (400, {"error": "too long"}),
        ("GET", "/health"): lambda b: (200, {"status": "ok"}),
    }
    httpd, _ = http.start_server(routes, "127.0.0.1", 0, "stub")
    url = f"http://127.0.0.1:{httpd.server_address[1]}"
    dead = f"http://127.0.0.1:{network.find_free_port()}"

    async def run():
        c = pt_client.GenAPIClient(
            timeout=5, retry=pt_client.RetryPolicy(max_attempts=3,
                                                   backoff_base_s=0.001),
            seed=0)
        assert await c.metrics(url) == {"ok": True}   # two 503s retried
        assert c.retries == 2
        with pytest.raises(pt_client.ClientResponseError) as e:
            await c.generate(url, "r", [1], {})
        assert e.value.status == 400 and c.retries == 2   # never retried
        with pytest.raises(pt_client.ClientConnectionError):
            await c.generate(dead, "r", [1], {})
        assert c.retries == 4          # refused: retried up to the budget
        assert await c.health(url) and not await c.health(dead)

    try:
        asyncio.run(run())
    finally:
        httpd.shutdown()
        httpd.server_close()
    # the jitter draws come from the seeded generator
    import random

    p = pt_client.RetryPolicy()
    assert [p.delay(a, random.Random(3)) for a in range(3)] == [
        p.delay(a, random.Random(3)) for a in range(3)]
