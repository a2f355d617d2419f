"""The port's async rollout loop end to end on the CPU, and its wire
compatibility with the reference.

- ``test_async_rollout_end_to_end`` ports ``tests/test_async_rollout_e2e.py
  ::test_async_rollout_end_to_end`` (plain and pipelined decode): a tiny
  generation server, the gserver manager, a rollout worker driving the
  math agent through chunked generation, the stream into a
  ``PullerStreamDataset``, a PPO step of the port's trainer on the
  streamed batch, its HF export and a weight update through the manager.
- Chunked greedy rollout through ``PartialRolloutManager`` gives the
  tokens of one un-chunked ``/generate`` and of the JAX engine, and its
  later chunks borrow the earlier chunks' pages from the prefix cache.
- The reference's aiohttp ``GenAPIClient`` talks to the port's server and
  the reference's ``PartialRolloutManager`` to the port's manager, and
  both get the port client's answers.
"""

import asyncio
import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from areal_tpu.api.model import GenerationHyperparameters as RefGconfig
from areal_tpu.gen import client as ref_client
from areal_tpu.gen import engine as jax_engine
from areal_tpu.models import transformer as jax_tfm
from areal_tpu.models.config import ModelConfig as JaxConfig
from areal_tpu.system.partial_rollout import PartialRolloutManager as RefPRM
from areal_tpu_torch.agents.math_single_step import MathSingleStepAgent
from areal_tpu_torch.api.data import MicroBatchSpec, SequenceSample
from areal_tpu_torch.api.dataset import DatasetUtility
from areal_tpu_torch.api.model import (
    GenerationHyperparameters,
    PPOHyperparameters,
    make_interface,
)
from areal_tpu_torch.base import name_resolve, names, network
from areal_tpu_torch.datasets.prompt import MathCodePromptDataset
from areal_tpu_torch.envs.math_code_single_step import MathCodeSingleStepEnv
from areal_tpu_torch.gen import client as pt_client
from areal_tpu_torch.gen.engine import GenerationEngine
from areal_tpu_torch.gen.server import serve
from areal_tpu_torch.models import transformer as tfm
from areal_tpu_torch.models.config import ModelConfig
from areal_tpu_torch.system.buffer import SequenceBuffer
from areal_tpu_torch.system.gserver_manager import (
    GserverManager,
    GserverManagerConfig,
    serve_manager,
)
from areal_tpu_torch.system.partial_rollout import PartialRolloutManager
from areal_tpu_torch.system.push_pull_stream import ZMQJsonPuller, ZMQJsonPusher
from areal_tpu_torch.system.rollout_worker import RolloutWorker
from areal_tpu_torch.system.stream_dataset import PullerStreamDataset
from areal_tpu_torch.train.engine import OptimizerConfig, TrainEngine


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


CFG_KW = dict(n_layers=2, n_q_heads=4, n_kv_heads=2, head_dim=8,
              hidden_dim=32, intermediate_dim=64, vocab_size=128,
              use_attention_bias=True, dtype="float32")
CFG = ModelConfig(**CFG_KW)
EXP, TRIAL = "e2e", "t0"
TRAJ_KEYS = {"packed_input_ids", "prompt_mask", "packed_logprobs", "rewards",
             "seq_no_eos_mask", "version_start", "version_end"}


@pytest.fixture(scope="module")
def tree():
    return jax.tree.map(
        np.asarray, jax_tfm.init_params(JaxConfig(**CFG_KW), jax.random.key(0)))


@pytest.fixture(autouse=True)
def _names():
    name_resolve.reset()
    yield
    name_resolve.reset()


def _server(tree, pipelined=False):
    eng = GenerationEngine(CFG, tfm.params_from_numpy(tree, device="cpu"),
                           max_slots=4, max_seqlen=256, page_size=8, seed=0,
                           pipeline_chunks=pipelined, device="cpu")
    srv = serve(eng, "127.0.0.1", 0, decode_steps=4)
    url = f"http://127.0.0.1:{srv.port}"
    name_resolve.add(names.gen_server(EXP, TRIAL, 0), url, replace=True)
    return eng, srv, url


def _manager(**kw):
    m = GserverManager(GserverManagerConfig(
        experiment_name=EXP, trial_name=TRIAL, **kw))
    m.discover_servers()
    return serve_manager(m, "127.0.0.1", 0)


def _write_dataset(path, rng, n=6, plen=8):
    with open(path, "w") as f:
        for i in range(n):
            f.write(json.dumps({
                "query_id": f"q{i}",
                "prompt_ids": [int(x) for x in rng.integers(1, 128, plen)],
                "task": "math",
                "solutions": ["\\boxed{7}"],
            }) + "\n")


@pytest.mark.parametrize("pipelined", [False, True], ids=["plain", "pipelined"])
async def test_async_rollout_end_to_end(tmp_path, tree, pipelined):
    eng, srv, gen_url = _server(tree, pipelined=pipelined)
    manager = _manager(train_batch_size=4, max_head_offpolicyness=100,
                       max_concurrent_rollouts=8)
    assert manager.server_urls == [gen_url]

    data_path = str(tmp_path / "math.jsonl")
    _write_dataset(data_path, np.random.default_rng(0))
    dataset = MathCodePromptDataset(
        util=DatasetUtility(seed=1, dp_rank=0, world_size=1), path=data_path)
    env = MathCodeSingleStepEnv(dataset.load_metadata())
    agent = MathSingleStepAgent(
        gconfig=GenerationHyperparameters(n=2, max_new_tokens=16),
        answer_save_path=str(tmp_path / "answers"),
    )
    pull_port = network.find_free_port()
    puller = ZMQJsonPuller("*", pull_port, default_timeout_ms=200)
    pusher = ZMQJsonPusher("127.0.0.1", pull_port)
    stream = PullerStreamDataset(EXP, TRIAL, 0,
                                 offline_dataset_size=len(dataset),
                                 puller=puller)
    worker = RolloutWorker(
        experiment_name=EXP, trial_name=TRIAL, worker_index=0, n_workers=1,
        n_pullers=1, agent=agent, env=env, dataset=dataset,
        new_tokens_per_chunk=8,  # forces chunked re-scheduling
        max_concurrent_tasks=4, pusher=pusher,
        manager_url=f"http://127.0.0.1:{manager.port}",
    )
    run_task = asyncio.get_running_loop().create_task(worker.run_async())
    try:
        buf = SequenceBuffer(max_version_lag=4)
        for _ in range(600):  # up to ~60 s
            await asyncio.sleep(0.1)
            for s in stream.get_batch(8, timeout=0.01):
                buf.put(s, current_version=0)
            if len(buf) >= 4:
                break
        assert len(buf) >= 4, f"only {len(buf)} arrived; pushed={worker.push_cnt}"
        samples = buf.pop_batch(4, current_version=0)
    finally:
        run_task.cancel()
        await asyncio.gather(run_task, return_exceptions=True)
        await worker.drain(timeout=60)
    assert worker.n_tasks() == 0 and pusher.drop_cnt == 0

    s = samples[0]
    assert s.keys >= TRAJ_KEYS
    group = len(s.seqlens["packed_input_ids"][0])
    assert group == 2
    total = sum(s.seqlens["packed_input_ids"][0])
    assert s.data["packed_input_ids"].shape[0] == total
    assert s.data["packed_logprobs"].shape[0] == total
    # chunked generation really ran more than one chunk per sequence
    assert manager.rollout_stat.accepted >= 2
    assert worker.prm.stats["chunks"] >= 2 * 2 * 4
    assert set(s.data["version_start"]) == set(s.data["version_end"]) == {0}

    # PPO on the streamed batch, from the served weights
    batch = SequenceSample.gather(samples, keys={
        "packed_input_ids", "prompt_mask", "packed_logprobs", "rewards",
        "seq_no_eos_mask"})
    trainer = TrainEngine(CFG, optimizer=OptimizerConfig(lr=1e-4),
                          device="cpu").load_params(
        tfm.params_to_numpy(eng.params)).setup_optimizer(10)
    actor = make_interface("ppo_actor", hp=PPOHyperparameters(
        ppo_n_minibatches=1, disable_value=True, adv_norm=True,
        use_decoupled_loss=False, recompute_logprob=False))
    stats = actor.train_step(trainer, batch,
                             MicroBatchSpec(max_tokens_per_mb=256))
    assert np.isfinite(stats["actor_loss"])

    # the export reaches the server through the manager
    ckpt = str(tmp_path / "v1")
    trainer.save_hf(ckpt, "qwen2")
    name_resolve.add(names.model_version(EXP, TRIAL, "actor"), f"1:{ckpt}",
                     replace=True)
    path = await manager.check_new_params()
    assert path == ckpt and manager.version == 1 and eng.version == 1
    stream.close()
    pusher.close()
    srv.stop()
    manager.stop()


async def _chunked(tree, prompt, n_new):
    """One greedy /generate and a 2-member group through the partial-
    rollout manager in chunks of 6; the prefix-hit tokens the chunks got."""
    eng, srv, url = _server(tree)
    manager = _manager(train_batch_size=4, max_concurrent_rollouts=8)
    try:
        one = await pt_client.GenAPIClient().generate(
            url, "one", prompt, {"max_new_tokens": n_new, "greedy": True})
        hits0 = eng.stats["prefix_hit_tokens"]
        reqs, replies = asyncio.Queue(), asyncio.Queue()
        prm = PartialRolloutManager(reqs, replies,
                                    f"http://127.0.0.1:{manager.port}",
                                    new_tokens_per_chunk=6)
        await reqs.put(("q", prompt, GenerationHyperparameters(
            n=2, max_new_tokens=n_new, greedy=True)))
        while replies.empty():
            await prm.run_step()
        bundle = replies.get_nowait()
    finally:
        srv.stop()
        manager.stop()
    assert prm.stats["chunks"] == 2 * 4   # 6 + 6 + 6 + 3 tokens each
    return one, bundle, eng.stats["prefix_hit_tokens"] - hits0


async def test_chunked_rollout_matches_one_generate_and_the_jax_engine(tree):
    prompt = np.random.default_rng(3).integers(1, 128, 13).tolist()
    n_new = 21
    # the JAX engine's greedy continuation
    jeng = jax_engine.GenerationEngine(
        JaxConfig(**CFG_KW), jax.tree.map(jnp.asarray, tree), max_slots=4,
        max_seqlen=256, page_size=8)
    jeng.submit(jax_engine.GenRequest(rid="j", input_ids=prompt,
                                      max_new_tokens=n_new, greedy=True))
    (want,) = jeng.run_until_done(decode_steps=4)
    one, bundle, hits = await _chunked(tree, prompt, n_new)
    assert bundle.error is None
    assert one.output_ids == want.output_ids
    for out, lps in zip(bundle.output_ids, bundle.logprobs):
        assert out == want.output_ids
        np.testing.assert_allclose(lps, want.output_logprobs, atol=1e-4)
    assert bundle.version_start == bundle.version_end == [0, 0]
    # a chunk borrows the pages its member's earlier chunks wrote: the
    # fourth chunk reuses 13 + 18 - 1 = 30 positions, 3 pages
    assert hits >= 2 * 3 * 8


async def test_reference_clients_talk_to_the_port(tmp_path, tree):
    """The reference's aiohttp client against the port's server, and the
    reference's partial-rollout manager against the port's manager: the
    same answers as the port's client and partial-rollout manager."""
    eng, srv, url = _server(tree)
    manager = _manager(train_batch_size=4, max_concurrent_rollouts=8)
    mgr_url = f"http://127.0.0.1:{manager.port}"
    prompt = [3, 14, 15, 9, 2, 6, 5]
    sp = {"max_new_tokens": 7, "greedy": True}
    try:
        async with ref_client.GenAPIClient(timeout=60) as rc:
            ref_out = await rc.generate(url, "r1", prompt, sp)
            with pytest.raises(Exception) as bad:
                await rc.generate(url, "r2", [999], sp)
            ckpt = str(tmp_path / "ckpt")
            TrainEngine(CFG, device="cpu").load_params(tree).save_hf(
                ckpt, "qwen2")
            ref_upd = await rc.update_weights_from_disk(url, ckpt, version=1)
        pc = pt_client.GenAPIClient(timeout=60)
        pt_out = await pc.generate(url, "p1", prompt, sp)
        with pytest.raises(pt_client.ClientResponseError) as pt_bad:
            await pc.generate(url, "p2", [999], sp)
        pt_upd = await pc.update_weights_from_disk(url, ckpt, version=2)

        bundles = []
        for prm_cls, gcls in ((RefPRM, RefGconfig),
                              (PartialRolloutManager,
                               GenerationHyperparameters)):
            reqs, replies = asyncio.Queue(), asyncio.Queue()
            prm = prm_cls(reqs, replies, mgr_url, new_tokens_per_chunk=3)
            await reqs.put((f"q-{prm_cls.__module__}", prompt,
                            gcls(n=2, max_new_tokens=8, greedy=True)))
            while replies.empty():
                await prm.run_step()
            bundles.append(replies.get_nowait())
    finally:
        srv.stop()
        manager.stop()
    assert (ref_out.output_ids, ref_out.finish_reason, ref_out.version) == (
        pt_out.output_ids, pt_out.finish_reason, 0)
    np.testing.assert_allclose(ref_out.output_logprobs, pt_out.output_logprobs)
    assert bad.value.status == pt_bad.value.status == 400
    assert ref_upd["success"] and pt_upd["success"]
    assert set(ref_upd) == set(pt_upd) and eng.version == 2
    ref_b, pt_b = bundles
    assert ref_b.error is None and pt_b.error is None
    assert ref_b.output_ids == pt_b.output_ids
    assert ref_b.version_start == pt_b.version_start == [2, 2]
    assert ref_b.no_eos == pt_b.no_eos
    np.testing.assert_allclose(ref_b.logprobs, pt_b.logprobs, atol=1e-6)
