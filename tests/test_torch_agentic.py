"""Port parity: the multi-turn agent and the graders of ``areal_tpu_torch``
(``agents/math_multi_turn.py``, ``rewards/tool_use.py``,
``evaluation/{mcq,grading}.py``, ``rewards/remote.py`` and the env's
``tool_use`` / ``gpqa`` / remote branches) against ``areal_tpu``'s, on the
CPU.

- ``MathMultiTurnAgent``: both agents run on the same scripted fleet (an
  obs/act queue pair answering each turn from a script) over math,
  tool_use and gpqa prompts: success at turn 0, at turn 2, never, and a
  fleet error at turn 1. The samples must be equal field by field (ids,
  seqlens, every array and its dtype, the metadata's keys and stamps but
  the wall-clock ``reward_time``), and the error raises
  ``GenerationFailedError`` in both;
- the graders on ``tests/test_rewards.py``'s tool_use cases and gpqa
  answers: exact equality with the reference's functions; the env's three
  branches against the reference env on the same metadata;
- the remote sandbox client: the port's and the reference's run against
  one local stub sandbox (a standard-library HTTP server on 127.0.0.1)
  through the scenarios of ``tests/test_remote_sandbox.py``: injected
  500s, system errors, timeouts, exhausted retries, bad payloads, a body
  that is not JSON, the concurrency cap and setting. Results, attempts
  per payload and the cap must agree; nothing leaves localhost.
"""

import asyncio
import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import pytest

from areal_tpu.agents.math_multi_turn import MathMultiTurnAgent as RefAgent
from areal_tpu.api.agent import BundledGenerationOutputs as RefBundle
from areal_tpu.api.agent import GenerationFailedError as RefFailed
from areal_tpu.api.data import SequenceSample as RefSample
from areal_tpu.api.model import GenerationHyperparameters as RefGconfig
from areal_tpu.envs.math_code_single_step import MathCodeSingleStepEnv as RefEnv
from areal_tpu.evaluation import grading as ref_grading
from areal_tpu.evaluation import mcq as ref_mcq
from areal_tpu.rewards import remote as ref_remote
from areal_tpu.rewards import tool_use as ref_tool_use
from areal_tpu_torch.agents.math_multi_turn import MathMultiTurnAgent
from areal_tpu_torch.api.agent import (BundledGenerationOutputs,
                                       GenerationFailedError, make_agent)
from areal_tpu_torch.api.data import SequenceSample
from areal_tpu_torch.api.model import GenerationHyperparameters
from areal_tpu_torch.base import http
from areal_tpu_torch.envs.math_code_single_step import MathCodeSingleStepEnv
from areal_tpu_torch.evaluation import grading, mcq
from areal_tpu_torch.rewards import remote, tool_use
from tests import test_rewards

REF = (RefAgent, RefBundle, RefSample, RefEnv, RefGconfig)
PT = (MathMultiTurnAgent, BundledGenerationOutputs, SequenceSample,
      MathCodeSingleStepEnv, GenerationHyperparameters)

# --------------------------------------------------------------------------- #
# the multi-turn agent on a scripted fleet
# --------------------------------------------------------------------------- #

# a stand-in tokenizer's texts, chosen by a turn's first generated token
TEXTS = {
    7: r"so the answer is \boxed{7}",
    1: test_rewards.TOOL_RESP,                    # answers "Paris"
    2: r"Answer: \boxed{C}",
    3: '{"function": {"name": "search", "arguments": {"query": "x"}}}',
}
META = {
    "m": {"task": "math", "solutions": [r"\boxed{7}"]},
    "t": {"task": "tool_use", "answer": "Paris"},
    "g": {"task": "gpqa", "solutions": ["C"]},
}
FEEDBACK = [90, 91, 92]


class _FirstTokenText:
    @staticmethod
    def decode(ids, **_):
        return TEXTS.get(ids[0], "no idea")


# qid -> the outputs of each turn the fleet answers (None = a fleet error)
SCRIPTS = {
    "success_t0": ("m", [[7, 40, 41]]),
    "success_t2": ("m", [[5, 40], [6], [7, 44, 45, 46]]),
    "never": ("m", [[5, 40], [6, 41, 42], [8]]),
    "tool_use_t1": ("t", [[3, 50, 51], [1, 52]]),   # a format-only score first
    "gpqa_never": ("g", [[4], [5, 60], [6]]),
    "gpqa_t1": ("g", [[4, 61], [2]]),
    "error_t1": ("m", [[5, 40], None]),
}


def _run_agent(pkg, case, **kw):
    agent_cls, bundle_cls, sample_cls, env_cls, gcls = pkg
    qid, turns = SCRIPTS[case]
    agent = agent_cls(gconfig=gcls(n=1, max_new_tokens=8),
                      feedback_token_ids=FEEDBACK, **kw)
    agent.tokenizer = _FirstTokenText()
    prompt_ids = [11, 12, 13, 14]
    prompt = sample_cls(keys={"packed_prompts"}, ids=[qid],
                        seqlens={"packed_prompts": [[len(prompt_ids)]]},
                        data={"packed_prompts": np.asarray(prompt_ids)})
    seen = []

    async def fleet(obs, act):
        for t, out in enumerate(turns):
            sub_qid, ids, gconfig = await obs.get()
            seen.append((sub_qid, list(ids), gconfig.n))
            if out is None:
                await act.put(bundle_cls(
                    qid=sub_qid, prompt_ids=ids, output_ids=[[]],
                    logprobs=[[]], no_eos=[False], version_start=[0],
                    version_end=[0], error="server gone"))
                return
            await act.put(bundle_cls(
                qid=sub_qid, prompt_ids=list(ids), output_ids=[out],
                logprobs=[[-0.25 * (t + 1) - 0.01 * i
                           for i in range(len(out))]],
                no_eos=[t % 2 == 0], version_start=[t], version_end=[t + 1],
                submit_time=10.0 + t, first_chunk_time=20.0 + t))

    async def run():
        obs, act = asyncio.Queue(), asyncio.Queue()
        task = asyncio.ensure_future(fleet(obs, act))
        try:
            return await agent.collect_trajectory(prompt, env_cls(META),
                                                  obs, act)
        finally:
            await task

    try:
        return asyncio.run(run()), seen, None
    except Exception as e:  # noqa: BLE001 - compared across packages
        return None, seen, e


@pytest.mark.parametrize("case", sorted(SCRIPTS))
def test_multi_turn_samples_match_the_reference(case):
    kw = dict(max_turns=3, turn_discount=0.9, reward_scaling=2.0,
              reward_bias=0.25)
    got, got_seen, got_err = _run_agent(PT, case, **kw)
    want, want_seen, want_err = _run_agent(REF, case, **kw)
    assert got_seen == want_seen
    if case == "error_t1":
        assert isinstance(got_err, GenerationFailedError)
        assert isinstance(want_err, RefFailed)
        assert str(got_err) == str(want_err)
        return
    assert got_err is None and want_err is None
    assert len(got) == len(want)
    qid = SCRIPTS[case][0]
    assert [s.ids for s in got] == [[f"{qid}-t{t}"] for t in range(len(got))]
    for g, w in zip(got, want):
        assert g.keys == w.keys and g.ids == w.ids and g.seqlens == w.seqlens
        for k in g.keys:
            np.testing.assert_array_equal(g.data[k], w.data[k], err_msg=k)
            assert g.data[k].dtype == w.data[k].dtype, k
        assert set(g.metadata) == set(w.metadata)
        for k in ("submit_time", "first_chunk_time"):
            assert g.metadata[k] == w.metadata[k]
    # turn t+1's prompt is turn t's whole sequence and the feedback
    for (_, prev, _), (_, nxt, _), s in zip(got_seen, got_seen[1:], got):
        assert nxt == s.data["packed_input_ids"].tolist() + FEEDBACK
        assert prev == nxt[:len(prev)]


def test_multi_turn_rewards_discount_and_logprob_offsets():
    """The ladder on a prompt that never succeeds: (0 - 0.5) * 2 times
    0.9 per turn; each turn's logprobs start at its prompt length - 1."""
    got, seen, _ = _run_agent(PT, "never", max_turns=3, turn_discount=0.9)
    np.testing.assert_allclose([float(s.data["rewards"][0]) for s in got],
                               [-1.0, -0.9, -0.81], rtol=1e-6)
    for (_, ids, _), s, out in zip(seen, got, SCRIPTS["never"][1]):
        plen = len(ids)
        lp = s.data["packed_logprobs"]
        assert np.all(lp[:plen - 1] == 0) and np.all(lp[plen - 1 + len(out):] == 0)
        assert np.all(lp[plen - 1:plen - 1 + len(out)] < 0)
        assert s.data["prompt_mask"].sum() == plen


def test_multi_turn_agent_is_registered():
    agent = make_agent("math-multi-turn",
                       gconfig=GenerationHyperparameters(n=1), max_turns=2)
    assert isinstance(agent, MathMultiTurnAgent) and agent.tokenizer is None


# --------------------------------------------------------------------------- #
# graders
# --------------------------------------------------------------------------- #

TOOL_CASES = [
    test_rewards.TOOL_RESP,
    test_rewards.TOOL_RESP
    + ' {"function": {"name": "answer", "arguments": {"answer": "Lyon"}}}',
    '{"answer": "42"}', "just text", "Paris", "wrong",
    '{"function": {"name": "answer", "arguments": '
    '{"answer": "He said \\"hi\\" loudly"}}}',
    "The  Quick, Brown Fox!", "the Paris", "Paris France", "",
]
TRUTHS = ["Paris", "42", "he said hi loudly", "quick brown fox", ""]


@pytest.mark.parametrize("method", ["f1", "em"])
def test_tool_use_grader_matches_the_reference(method):
    for text in TOOL_CASES:
        assert tool_use.extract_answer(text) == ref_tool_use.extract_answer(text)
        assert (tool_use.normalize_answer(text)
                == ref_tool_use.normalize_answer(text))
        assert (tool_use.validate_tool_call_format(text)
                == ref_tool_use.validate_tool_call_format(text))
        for truth in TRUTHS:
            assert tool_use.em_check(text, truth) == ref_tool_use.em_check(
                text, truth)
            assert tool_use.f1_score(text, truth) == ref_tool_use.f1_score(
                text, truth)
            kw = dict(correctness_weight=1.0, format_weight=0.2,
                      scoring_method=method)
            assert tool_use.tool_use_reward(text, truth, **kw) == (
                ref_tool_use.tool_use_reward(text, truth, **kw))
    assert tool_use.tool_use_reward(test_rewards.TOOL_RESP, "Paris") == (
        pytest.approx(1.2))


GPQA_ANSWERS = [
    r"\boxed{D}", r"\boxed{(D)}", r"\boxed{D. 10^-4 ev}", "so it is D",
    r"\boxed{10^-4 ev}", "A or B? B.", "none", r"Answer: \boxed{c}",
    r"\boxed{E}", "",
]


def test_gpqa_grader_matches_the_reference():
    for a in GPQA_ANSWERS:
        assert mcq.extract_choice(a) == ref_mcq.extract_choice(a)
        for gold in ("D", "B", ["D"], ["C", "D"], [], "c"):
            assert grading.grade_gpqa_answer(a, gold) == (
                ref_grading.grade_gpqa_answer(a, gold)), (a, gold)
            if isinstance(gold, str):
                assert mcq.grade_choice(a, gold) == ref_mcq.grade_choice(
                    a, gold)
    assert grading.grade_gpqa_answer(r"\boxed{D}", ["D"]) == 1.0


ENV_META = {
    "t": {"task": "tool_use", "answer": "Paris"},
    "t_em": {"task": "tool_use", "answer": "the Paris",
             "scoring_method": "em"},
    "g": {"task": "gpqa", "solutions": ["D"]},
    "g_none": {"task": "gpqa"},
    "m": {"task": "math", "solutions": [r"\boxed{7}"]},
    "c": {"task": "code", "input_output": {"inputs": ["1\n"],
                                           "outputs": ["2\n"]}},
}
ENV_ANSWERS = [test_rewards.TOOL_RESP, "Paris", r"\boxed{D}", r"\boxed{7}",
               "```python\nprint(int(input()) + 1)\n```", "nothing"]


@pytest.mark.parametrize("qid", sorted(ENV_META))
def test_env_branches_match_the_reference(qid):
    got = asyncio.run(MathCodeSingleStepEnv(ENV_META).step((qid, ENV_ANSWERS)))
    want = asyncio.run(RefEnv(ENV_META).step((qid, ENV_ANSWERS)))
    assert got == want
    if qid == "g_none":      # no gold letter: nothing grades correct
        assert not any(got[1])
    else:
        assert any(got[1]) and not all(got[1])


# --------------------------------------------------------------------------- #
# the remote sandbox client against a local stub
# --------------------------------------------------------------------------- #


class StubSandbox:
    """A scriptable verifier on 127.0.0.1, behaviour by ``payload['mode']``
    (as ``tests/test_remote_sandbox.py``'s mock): ``ok``; ``flaky`` (500
    until the second attempt of its uid); ``hang`` (answers after
    ``HANG_S``, past the client's timeout, or stops once the client has
    gone); ``syserr`` (a SystemError
    result first, success after); ``reject`` (always 400); ``garbage``
    (200 with a body that is not JSON)."""

    HANG_S = 2.0

    def __init__(self):
        self.attempts = {}
        self.in_flight = self.max_in_flight = 0
        self._lock = threading.Lock()
        box = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def do_POST(self):
                n = int(self.headers.get("Content-Length") or 0)
                d = json.loads(self.rfile.read(n) or b"{}")
                status, body = box.answer(self.path, d, self.connection)
                data = body if isinstance(body, bytes) else json.dumps(
                    body).encode()
                try:
                    self.send_response(status)
                    self.send_header("Content-Type", "application/json")
                    self.send_header("Content-Length", str(len(data)))
                    self.end_headers()
                    self.wfile.write(data)
                except OSError:
                    pass   # the client timed out and went away

            def log_message(self, *a):
                pass

        class Server(ThreadingHTTPServer):
            daemon_threads = True
            # every call may open a connection of its own: the default
            # backlog of 5 would drop connects of a 16-wide burst
            request_queue_size = 256

        self.httpd = Server(("127.0.0.1", 0), Handler)
        self.thread = threading.Thread(target=self.httpd.serve_forever,
                                       daemon=True)
        self.thread.start()
        self.base = f"http://127.0.0.1:{self.httpd.server_address[1]}"
        self.url = f"{self.base}/test_verify"

    def reset(self):
        with self._lock:
            self.attempts = {}
            self.max_in_flight = 0

    def answer(self, path, d, conn):
        uid, mode = d.get("uid", ""), d.get("mode", "ok")
        with self._lock:
            self.attempts[uid] = n = self.attempts.get(uid, 0) + 1
            self.in_flight += 1
            self.max_in_flight = max(self.max_in_flight, self.in_flight)
        try:
            time.sleep(0.01)
            if mode == "hang":
                # until the client gives up (as an aiohttp server cancels
                # the handler of a request whose client went away)
                end = time.monotonic() + self.HANG_S
                while time.monotonic() < end and not http.peer_closed(conn):
                    time.sleep(0.01)
            if mode == "flaky" and n < 2:
                return 500, b"transient"
            if mode == "reject":
                return 400, b"bad payload"
            if mode == "garbage":
                return 200, b"<html>not json</html>"
            if mode == "syserr" and n < 2:
                return 200, {"uid": uid, "success": True, "results": [
                    {"success": False, "errorType": "SystemError"}]}
            return 200, {"uid": uid, "success": True, "path": path,
                         "results": [{"success": True}]}
        finally:
            with self._lock:
                self.in_flight -= 1

    def close(self):
        self.httpd.shutdown()
        self.httpd.server_close()


@pytest.fixture
def sandbox():
    box = StubSandbox()
    yield box
    box.close()


def _both(box, payloads, **kw):
    """The same batch through the port's client and the reference's: each
    one's results, attempts per uid and peak calls in flight."""
    out = {}
    for name, mod in (("torch", remote), ("jax", ref_remote)):
        box.reset()
        res = asyncio.run(mod.batch_function_call_async(payloads, box.url,
                                                        **kw))
        out[name] = (res, dict(box.attempts), box.max_in_flight)
    return out


def test_hundred_call_batch_with_injected_faults(sandbox):
    modes = ["ok"] * 80 + ["flaky"] * 10 + ["hang"] * 5 + ["syserr"] * 5
    payloads = [{"uid": f"u{i}", "mode": m, "code": "x"}
                for i, m in enumerate(modes)]
    out = _both(sandbox, payloads, timeout=1.0, concurrency=16,
                max_retries=3, initial_retry_interval=0.01)
    (res, attempts, peak), ref = out["torch"], out["jax"]
    assert res == ref[0] and attempts == ref[1]
    assert [r["uid"] for r in res] == [p["uid"] for p in payloads]
    for i, m in enumerate(modes):
        r = res[i]
        if m == "hang":
            assert not r["success"]
            assert "timed out" in r["results"][0]["reason"]
            assert attempts[f"u{i}"] == 1            # never retried
        else:
            assert r["success"], (m, r)
            assert attempts[f"u{i}"] == (1 if m == "ok" else 2)
    assert 0 < peak <= 16 and 0 < ref[2] <= 16


def test_retries_exhausted_and_payload_validation(sandbox):
    payloads = [
        {"uid": "r0", "mode": "reject"},
        {},
        {"uid": "c0", "code": "", "mode": "ok"},
        {"uid": "x0", "mode": "garbage"},
    ]
    out = _both(sandbox, payloads, timeout=1.0, concurrency=4,
                max_retries=2, initial_retry_interval=0.01)
    (res, attempts, _), ref = out["torch"], out["jax"]
    assert res == ref[0] and attempts == ref[1]
    assert not res[0]["success"]
    assert "max retries" in res[0]["results"][0]["reason"]
    assert "Empty payload" in res[1]["results"][0]["reason"]
    assert "Empty code" in res[2]["results"][0]["reason"]
    assert "max retries" in res[3]["results"][0]["reason"]
    assert attempts == {"r0": 2, "x0": 2}        # invalid ones never sent


def test_unreachable_sandbox_fails_every_payload():
    box = StubSandbox()
    url = box.url
    box.close()                                   # nothing listens there now
    payloads = [{"uid": "a", "code": "x"}, {"uid": "b", "code": "y"}]
    got = asyncio.run(remote.batch_function_call_async(
        payloads, url, timeout=1.0, concurrency=2, max_retries=2,
        initial_retry_interval=0.01))
    want = asyncio.run(ref_remote.batch_function_call_async(
        payloads, url, timeout=1.0, concurrency=2, max_retries=2,
        initial_retry_interval=0.01))
    assert got == want
    assert all("max retries" in r["results"][0]["reason"] for r in got)


@pytest.mark.parametrize("env", [
    {}, {"AREAL_FUNCTIONCALL_CONCURRENCY": "7"},
    {"AREAL_FUNCTIONCALL_DP": "100"}, {"AREAL_FUNCTIONCALL_DP": "0"},
    {"AREAL_FUNCTIONCALL_CONCURRENCY": "many"},
])
def test_default_concurrency_matches_the_reference(env, monkeypatch):
    for k in ("AREAL_FUNCTIONCALL_CONCURRENCY", "AREAL_FUNCTIONCALL_DP"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    assert remote.default_concurrency() == ref_remote.default_concurrency()


def test_wrappers_and_env_remote_branch_match_the_reference(sandbox,
                                                            monkeypatch):
    """``math_verify_remote`` / ``code_verify_remote`` hit the domain's
    routes; with the sandbox switched on, the env's math and code grading
    goes to it in both packages (tool_use and gpqa never do)."""
    monkeypatch.setenv("AREAL_FUNCTIONCALL_SERVICE_DOMAIN", sandbox.base)
    monkeypatch.setenv("AREAL_ENABLE_FUNCTION_CALL", "1")
    monkeypatch.setattr(ref_remote, "ENABLED", True)
    assert remote.enabled()
    seen = {}
    for name, mod, env_cls in (("torch", remote, MathCodeSingleStepEnv),
                               ("jax", ref_remote, RefEnv)):
        sandbox.reset()

        async def go():
            ok = await mod.math_verify_remote(["42"], [["42"]], ["q1"])
            ok2 = await mod.code_verify_remote(["print(1)"], ["q2"])
            env = env_cls(ENV_META)
            steps = [await env.step((q, ["a", "b"])) for q in ("m", "c", "t")]
            return ok, ok2, steps

        seen[name] = (asyncio.run(go()), dict(sandbox.attempts))
    assert seen["torch"] == seen["jax"]
    (ok, ok2, steps), attempts = seen["torch"]
    assert ok == [True] and ok2 == [True]
    assert [s[1] for s in steps[:2]] == [[True, True], [True, True]]
    assert attempts == {"q1": 1, "q2": 1, "m": 2, "c": 2}
    monkeypatch.setenv("AREAL_ENABLE_FUNCTION_CALL", "0")
    assert not remote.enabled()


# --------------------------------------------------------------------------- #
# the card's agentic phase: its pinned graph and its traffic
# --------------------------------------------------------------------------- #


def test_chip_smoke_pins_the_reference_graph_levels():
    """``chip_smoke.py``'s ``agentic_ppo`` holds the trainer's graph to
    ``AGENTIC_LEVELS``: the reference's ``build_ppo_graph`` levels for an
    RM-scored, ref-free, critic-free PPO with the decoupled loss."""
    import chip_smoke
    from areal_tpu.api.model import PPOHyperparameters as RefHp
    from areal_tpu.experiments.graphs import build_ppo_graph as ref_build

    g, _ = ref_build(RefHp(disable_value=True, adv_norm=True,
                           use_decoupled_loss=True, ppo_n_minibatches=2),
                     use_ref=False, use_critic=False, use_reward_model=True)
    assert [[m.name for m in lvl] for lvl in g.levels] == (
        chip_smoke.AGENTIC_LEVELS)


def test_chip_smoke_agentic_traffic_scores_zero_and_its_answers_pass():
    """The phase's random-token answers score 0 under every task's grader
    (so every conversation runs all its turns), and its host-side correct
    answers score at least 0.5, in both packages' envs."""
    import chip_smoke

    rng = np.random.default_rng(0)
    records = chip_smoke.agentic_records(rng, 151936, 4, 32)
    meta = {r["query_id"]: {k: v for k, v in r.items()
                            if k not in ("query_id", "prompt_ids")}
            for r in records}
    for r in records:
        answers = [" ".join(map(str, rng.integers(0, 151936, 256)))
                   for _ in range(4)]
        answers.append(chip_smoke.AGENTIC_CORRECT[r["task"]])
        for env_cls in (MathCodeSingleStepEnv, RefEnv):
            _, scores, *_ = asyncio.run(
                env_cls(meta).step((r["query_id"], answers)))
            assert [float(x) for x in scores[:4]] == [0.0] * 4
            assert float(scores[4]) >= 0.5
