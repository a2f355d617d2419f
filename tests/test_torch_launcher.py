"""The port's experiment configs and launcher (``areal_tpu_torch/
experiments``, ``apps/launcher.py``, ``apps/main.py``) against
``areal_tpu``'s, and the async-PPO world on the CPU.

- ``load_config`` on ``examples/async_ppo_tiny.yaml`` with overrides gives
  the reference's config, field by field;
- the manager config the launcher builds equals the reference's (its
  ``train_batch_size`` is in sequences, ``gconfig.n`` x the trainer's
  groups: the staleness gate's unit differs between the reference's
  launcher and its trainer, and the port keeps that as it is);
- entry points refuse to fall back: with no GPU and no device asked for,
  ``_load_engine`` raises, and a world whose server is designated for the
  card exits non-zero;
- ``sft``, ``sync-ppo``, ``rw`` and ``profile`` run in-process through
  ``main.main`` on the CPU and raise without a device; their configs
  equal the reference's; ``run_sync_ppo`` takes two steps and a save
  (the port of ``tests/test_experiment_e2e.py::test_sync_ppo_experiment``);
- ``python -m areal_tpu_torch.apps.main async-ppo`` on the CPU with a tiny
  model for 2 steps (the counterpart of
  ``tests/test_experiment_e2e.py::test_async_ppo_experiment``): rc 0, two
  finite ``metrics.jsonl`` lines, weight-sync dirs ``["v1", "v2"]``, the
  server's metrics dump at version 2. The world runs in a process group of
  its own under a deadline and is killed whole if it overruns.
"""

import dataclasses
import json
import os
import pathlib
import signal
import subprocess
import sys
import time
import types

import numpy as np
import pytest
import torch

from areal_tpu.experiments import AsyncPPOExperiment as JaxExperiment
from areal_tpu.experiments import load_config as jax_load_config
from areal_tpu_torch.apps import launcher
from areal_tpu_torch.experiments import AsyncPPOExperiment, load_config

REPO = pathlib.Path(__file__).resolve().parents[1]
TINY_YAML = str(REPO / "examples" / "async_ppo_tiny.yaml")
TINY_ARCH = dict(
    n_layers=2, n_q_heads=4, n_kv_heads=2, head_dim=8, hidden_dim=32,
    intermediate_dim=64, vocab_size=128, use_attention_bias=True,
    dtype="float32",
)
OVERRIDES = [
    "train_batch_size=3", "gconfig.n=2", 'ppo={"kl_ctl": 0.0}',
    "manager.max_head_offpolicyness=2", "control.ckpt_freq_secs=null",
    'actor.overrides={"remat_policy": "full"}', "gen.n_pages=64",
    "gen.stop_token_ids=[5, 9]", "rollout.agent_args={\"x\": 1}",
]


def test_load_config_matches_the_reference():
    ours = load_config(AsyncPPOExperiment, TINY_YAML, OVERRIDES)
    theirs = jax_load_config(JaxExperiment, TINY_YAML, OVERRIDES)
    a, b = dataclasses.asdict(ours), dataclasses.asdict(theirs)
    assert a == b
    assert ours.mb_spec.max_tokens_per_mb == theirs.mb_spec.max_tokens_per_mb
    assert ours.actor.model_config().n_layers == 2
    assert ours.actor.model_config(is_critic=True).is_critic
    assert ours.actor.model_config().remat_policy == "full"
    # no YAML: overrides only, and PyYAML is not needed
    bare = load_config(AsyncPPOExperiment, None, ["gen.device=cpu"])
    assert bare.gen.device == "cpu" and bare.actor.arch is None


def test_manager_config_matches_the_reference(monkeypatch, tmp_path):
    """The reference's ``gserver_manager_main`` builds its config inline:
    capture it where it constructs the manager."""
    from areal_tpu.base import name_resolve as jax_nr
    from areal_tpu.system import gserver_manager as jax_gm
    from areal_tpu.apps import launcher as jax_launcher

    overrides = OVERRIDES + [f"fileroot={tmp_path}"]
    monkeypatch.setenv("AREAL_FILEROOT", str(tmp_path))
    monkeypatch.setenv("AREAL_NAME_RESOLVE_ROOT", str(tmp_path / "nr"))
    captured = {}

    class Captured(Exception):
        pass

    def fake_manager(cfg):
        captured["cfg"] = cfg
        raise Captured()

    monkeypatch.setattr(jax_gm, "GserverManager", fake_manager)
    saved = jax_nr.default_repository()
    try:
        with pytest.raises(Captured):
            jax_launcher.gserver_manager_main(
                jax_load_config(JaxExperiment, TINY_YAML, overrides))
    finally:
        jax_nr.set_repository(saved)
    ours = launcher.gserver_manager_config(
        load_config(AsyncPPOExperiment, TINY_YAML, overrides))
    assert dataclasses.asdict(ours) == dataclasses.asdict(captured["cfg"])
    # sequences, not groups: 3 groups x n 2
    assert ours.train_batch_size == 6


def test_load_engine_refuses_to_fall_back(monkeypatch):
    cfg = load_config(AsyncPPOExperiment, None,
                      [f"actor.arch={json.dumps(TINY_ARCH)}"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        launcher._load_engine(cfg.actor)
    eng = launcher._load_engine(cfg.actor, device="cpu", total_steps=3)
    assert eng.device.type == "cpu" and eng.optimizer is not None


@pytest.mark.parametrize("option,value", [
    ("gateway.enabled", "true"), ("evaluator.enabled", "true"),
    ("gen.tp_size", "2"), ("gen.spec_decode", "true"),
    ("reward", json.dumps({"arch": TINY_ARCH})),
])
def test_unported_options_raise_before_anything_starts(option, value,
                                                       monkeypatch):
    """Each option raises before anything starts, except ``reward``,
    ``gen.spec_decode`` and ``gateway.enabled``, which are ported now: a
    trained reward model's config passes the check and loads a fourth
    engine, spec decode's builds a generation engine that speculates, and
    the gateway's spawns ``gateway_main`` beside the rest of the world."""
    cfg = load_config(AsyncPPOExperiment, None, [f"{option}={value}"])
    if option == "gateway.enabled":
        launcher._check_ported(cfg)

        class FakeProcess:
            def __init__(self, target, args, daemon):
                self.target, self.pid = target, 0

            def start(self):
                pass

        monkeypatch.setattr(launcher.mp, "get_context",
                            lambda method: types.SimpleNamespace(
                                Process=FakeProcess))
        procs = launcher._spawn_all(cfg)
        assert procs["gateway"].target is launcher.gateway_main
        assert launcher.ROLE_MAINS["gateway"] is launcher.gateway_main
        return
    if option == "gen.spec_decode":
        launcher._check_ported(cfg)
        cfg.gen.device = "cpu"
        cfg.actor.arch = TINY_ARCH
        eng = launcher.gen_engine(cfg, 0)
        assert eng.spec is True and eng._draft is None
        return
    if option == "reward":
        launcher._check_ported(cfg)
        cfg.trainer_device = "cpu"
        cfg.actor.arch = TINY_ARCH
        actor, ref, critic, reward = launcher._load_ppo_engines(cfg, 3)
        assert reward.cfg.is_critic and reward.optimizer is None
        assert actor.optimizer is not None and critic is None
        return
    with pytest.raises(NotImplementedError, match="not ported"):
        launcher.run_async_ppo(cfg)


@pytest.mark.parametrize("overrides", [
    [], ["use_ref_model=false"], ['ppo={"kl_ctl": 0.0}'],
    ['ppo={"kl_ctl": 0.0}', "ema_ref_eta=0.5"],
    [f"critic={json.dumps({'arch': TINY_ARCH})}"],
    [f"critic={json.dumps({'arch': TINY_ARCH})}",
     'ppo={"disable_value": true}'],
    [f"reward={json.dumps({'arch': TINY_ARCH})}"],
    [f"reward={json.dumps({'arch': TINY_ARCH})}",
     f"critic={json.dumps({'arch': TINY_ARCH})}", "use_ref_model=false"],
])
def test_load_ppo_engines_gating_matches_the_reference(overrides,
                                                       monkeypatch):
    """``_load_ppo_engines`` returns (actor, ref, critic, reward) under the
    reference's gating rules: which engines exist, from which spec, with
    or without a critic head and an optimizer."""
    from areal_tpu.apps import launcher as jax_launcher

    def recorder(cfg):
        names = {id(getattr(cfg, k)): k for k in ("actor", "critic",
                                                  "reward")
                 if getattr(cfg, k) is not None}

        def load(spec, is_critic=False, with_optimizer=True, total_steps=0,
                 device=None):
            return (names[id(spec)], is_critic, with_optimizer)
        return load

    got = {}
    for name, mod, exp, load in (
            ("jax", jax_launcher, JaxExperiment, jax_load_config),
            ("torch", launcher, AsyncPPOExperiment, load_config)):
        cfg = load(exp, None, overrides)
        monkeypatch.setattr(mod, "_load_engine", recorder(cfg))
        got[name] = mod._load_ppo_engines(cfg, 5)
    assert got["torch"] == got["jax"]
    assert len(got["torch"]) == 4


@pytest.mark.parametrize("option,value", [
    ("gen.tp_size", "2"), ("gen.spec_decode", "true"), ("gen.spec_k", "4"),
    ("gen.spec_draft_model", "/nowhere"),
])
def test_gen_server_main_raises_for_tp_and_spec_decode(option, value):
    """``gen.tp_size > 1`` raises before a server starts. The spec options
    are ported now (the test keeps the name it had while they raised):
    each builds the server's engine, with spec on, with K set (spec off,
    as the fleet's default), or with the draft path ignored because spec
    decode is off (the path does not exist, so loading it would fail)."""
    cfg = load_config(AsyncPPOExperiment, None, [f"{option}={value}"])
    if option == "gen.tp_size":
        with pytest.raises(NotImplementedError, match="not ported"):
            launcher.gen_server_main(cfg, 0)
        return
    launcher._check_gen_ported(cfg.gen)
    cfg.gen.device = "cpu"
    cfg.actor.arch = TINY_ARCH
    eng = launcher.gen_engine(cfg, 0)
    assert eng.spec is (option == "gen.spec_decode")
    assert eng.spec_k == 4      # gen.spec_k=4, else AREAL_SPEC_K's default
    assert eng._draft is None and eng.draft_kv_pool_bytes() == 0


@pytest.mark.parametrize("spec_on", [True, False])
def test_gen_engine_loads_the_draft_model_only_with_spec_on(tmp_path,
                                                             spec_on):
    """``gen.spec_draft_model`` (an HF dir) becomes the engine's
    ``TransformerDrafter`` when spec decode is on, with its own pool at the
    draft's depth; with spec off it is ignored."""
    from areal_tpu_torch.models import hf as hf_conv
    from areal_tpu_torch.models import transformer as tfm
    from areal_tpu_torch.models.config import ModelConfig

    dcfg = ModelConfig(**{**TINY_ARCH, "n_layers": 1})
    hf_conv.save_hf_checkpoint(
        tfm.params_to_numpy(tfm.init_params(dcfg, seed=4, device="cpu")),
        dcfg, "qwen2", str(tmp_path))
    cfg = load_config(AsyncPPOExperiment, None, [
        f"gen.spec_decode={str(spec_on).lower()}", "gen.spec_k=2",
        f"gen.spec_draft_model={tmp_path}", "gen.device=cpu",
        f"actor.arch={json.dumps(TINY_ARCH)}"])
    eng = launcher.gen_engine(cfg, 0)
    assert eng.spec is spec_on and eng.spec_k == 2
    if not spec_on:
        assert eng._draft is None and eng.state.draft_cache is None
        return
    assert eng._draft is not None and eng.draft_cfg.n_layers == 1
    assert eng.draft_kv_pool_bytes() == eng.kv_pool_bytes() // 2


def _write_jsonl(path, records):
    with open(path, "w") as f:
        for r in records:
            f.write(json.dumps(r) + "\n")


def _entry_point_args(cmd, tmp_path):
    """``main.main`` arguments that run ``cmd`` on the CPU with the tiny
    arch, over a small dataset written from a seed."""
    rng = np.random.default_rng(0)
    ids = lambda n: [int(x) for x in rng.integers(1, 128, n)]  # noqa: E731
    if cmd == "profile":
        return ["profile", "--seqlens", "16x2", "--n-steps", "1",
                "--device", "cpu", f"arch={json.dumps(TINY_ARCH)}"]
    data = str(tmp_path / f"{cmd}.jsonl")
    common = [f"experiment_name={cmd}-main", "trial_name=t0",
              f"fileroot={tmp_path}/files", f"dataset.path={data}",
              "control.total_train_steps=2", "batch_size=2",
              "max_tokens_per_mb=256", "trainer_device=cpu"]
    if cmd == "sft":
        _write_jsonl(data, [{"prompt_ids": ids(4), "answer_ids": ids(5)}
                            for _ in range(4)])
        return [cmd, *common, "dataset.name=prompt_answer",
                f"model.arch={json.dumps(TINY_ARCH)}"]
    if cmd == "rw":
        _write_jsonl(data, [{"prompt_ids": ids(3), "pos_answer_ids": [ids(5)],
                             "neg_answer_ids": [ids(4)]} for _ in range(4)])
        return [cmd, *common, "dataset.name=rw_paired",
                f"model.arch={json.dumps(TINY_ARCH)}"]
    _write_prompt_dataset(data, n=4)
    return [cmd, *common, f"actor.arch={json.dumps(TINY_ARCH)}",
            'gconfig={"n": 2, "max_new_tokens": 4}',
            'ppo={"ppo_n_minibatches": 1, "disable_value": true}']


@pytest.mark.parametrize("cmd", ["sft", "sync-ppo", "rw", "profile"])
def test_in_process_entry_points_run_on_the_cpu(cmd, tmp_path, capsys):
    """``sft``, ``sync-ppo``, ``rw`` and ``profile`` through ``main.main``
    on the CPU: each returns 0 and leaves its record (two finite metrics
    lines, or the profile's JSON line)."""
    from areal_tpu_torch.apps import main

    assert main.main(_entry_point_args(cmd, tmp_path)) == 0
    if cmd == "profile":
        out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert out["metric"] == "profile_step" and np.isfinite(out["mfu"])
        return
    key = {"sft": "sft/loss", "rw": "reward/rw_loss",
           "sync-ppo": "sync_ppo/actor_loss"}[cmd]
    logs = tmp_path / "files" / "logs" / f"{cmd}-main" / "t0"
    lines = [json.loads(l) for l in open(logs / "metrics.jsonl")]
    assert [ln["step"] for ln in lines] == [1, 2]
    assert all(np.isfinite(ln[key]) for ln in lines)


@pytest.mark.parametrize("cmd", ["sft", "sync-ppo", "rw", "profile"])
def test_in_process_entry_points_refuse_to_fall_back(cmd, tmp_path,
                                                     monkeypatch):
    """With no device named and no GPU, each entry point raises."""
    from areal_tpu_torch.apps import main

    args = [a for a in _entry_point_args(cmd, tmp_path)
            if not a.startswith("trainer_device=")
            and a not in ("--device", "cpu")]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        main.main(args)


@pytest.mark.parametrize("name", ["SyncPPOExperiment", "SFTExperiment",
                                  "RWExperiment"])
def test_in_process_configs_match_the_reference(name):
    """The reference's defaults and overrides, field by field; the port's
    SFT and RW experiments add ``trainer_device`` and nothing else."""
    import areal_tpu.experiments as jax_exps
    import areal_tpu_torch.experiments as exps

    role = "actor" if name == "SyncPPOExperiment" else "model"
    overrides = [f"{role}.arch={json.dumps(TINY_ARCH)}", "batch_size=3",
                 "control.save_freq_steps=2", "dataset.max_length=64"]
    if name == "SyncPPOExperiment":
        overrides += ['gconfig={"n": 4}', "ppo.kl_ctl=0.0"]
    ours = load_config(getattr(exps, name), None, overrides)
    theirs = jax_load_config(getattr(jax_exps, name), None, overrides)
    a, b = dataclasses.asdict(ours), dataclasses.asdict(theirs)
    if name != "SyncPPOExperiment":
        assert a.pop("trainer_device") == ""
    assert a == b


def test_sync_ppo_experiment(tmp_path):
    """Port of ``tests/test_experiment_e2e.py::test_sync_ppo_experiment``:
    in-process sync PPO for 2 steps with a save, on one device and
    ``trainer_device=cpu``. A ``reward`` model spec is ignored there, as
    the reference ignores it."""
    from areal_tpu_torch.experiments import SyncPPOExperiment

    data = str(tmp_path / "math.jsonl")
    _write_prompt_dataset(data)
    cfg = load_config(SyncPPOExperiment, None, [
        "experiment_name=sppo-test",
        "trial_name=t0",
        f"fileroot={tmp_path}/files",
        f"dataset.path={data}",
        "batch_size=2",
        "max_tokens_per_mb=512",
        "control.total_train_steps=2",
        "control.save_freq_steps=2",
        f"actor.arch={json.dumps(TINY_ARCH)}",
        "actor.parallel=d1m1",
        "actor.optimizer.lr=0.0001",
        "use_ref_model=true",
        "trainer_device=cpu",
        'gconfig={"n": 2, "max_new_tokens": 12}',
        'ppo={"ppo_n_minibatches": 1, "disable_value": true,'
        ' "use_decoupled_loss": false, "recompute_logprob": false}',
        f"reward={json.dumps({'arch': TINY_ARCH})}",
    ])
    assert launcher.run_sync_ppo(cfg) == 0
    metrics = os.path.join(
        f"{tmp_path}/files", "logs", "sppo-test", "t0", "metrics.jsonl"
    )
    lines = [json.loads(l) for l in open(metrics)]
    assert len(lines) == 2
    assert np.isfinite(lines[-1]["sync_ppo/actor_loss"])
    assert "sync_ppo/reward_mean" in lines[-1]
    save_dir = os.path.join(
        f"{tmp_path}/files", "checkpoints", "sppo-test", "t0", "step2"
    )
    assert os.path.exists(os.path.join(save_dir, "model.safetensors"))


def test_sync_ppo_evaluator_raises_before_anything_starts():
    from areal_tpu_torch.experiments import SyncPPOExperiment

    cfg = load_config(SyncPPOExperiment, None, ["evaluator.enabled=true"])
    with pytest.raises(NotImplementedError, match="not ported"):
        launcher.run_sync_ppo(cfg)


# --------------------------------------------------------------------------- #
# the multiprocess world on the CPU
# --------------------------------------------------------------------------- #


def _write_prompt_dataset(path, n=8, plen=6):
    rng = np.random.default_rng(0)
    with open(path, "w") as f:
        for i in range(n):
            f.write(json.dumps({
                "query_id": f"q{i}",
                "prompt_ids": [int(x) for x in rng.integers(1, 128, plen)],
                "task": "math",
                "solutions": ["\\boxed{7}"],
            }) + "\n")


def _world_overrides(tmp_path, exp):
    data = str(tmp_path / "math.jsonl")
    _write_prompt_dataset(data)
    return [
        f"experiment_name={exp}", "trial_name=t0",
        f"fileroot={tmp_path}/root", f"dataset.path={data}",
        "train_batch_size=2", "max_tokens_per_mb=512",
        "control.total_train_steps=2", "control.ckpt_freq_steps=null",
        "control.ckpt_freq_secs=null", f"actor.arch={json.dumps(TINY_ARCH)}",
        "actor.parallel=d1m1", "actor.optimizer.lr=0.0001",
        "use_ref_model=true", "gen.n_servers=1", "gen.max_slots=4",
        "gen.max_seqlen=256", "trainer_device=cpu", "rollout.n_workers=1",
        "rollout.max_concurrent_tasks=4", "rollout.new_tokens_per_chunk=8",
        "manager.max_head_offpolicyness=100",
        'gconfig={"n": 2, "max_new_tokens": 12}',
        'ppo={"ppo_n_minibatches": 1, "disable_value": true, '
        '"use_decoupled_loss": true}',
    ]


def _run_world(tmp_path, overrides, deadline_s=120):
    """``python -m areal_tpu_torch.apps.main async-ppo`` in a process group
    of its own; returns (rc, log). Past the deadline the whole group is
    killed and the test fails."""
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    env.pop("CUDA_VISIBLE_DEVICES", None)
    proc = subprocess.Popen(
        [sys.executable, "-m", "areal_tpu_torch.apps.main", "async-ppo",
         *overrides],
        cwd=str(tmp_path), env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True, start_new_session=True,
    )
    try:
        out, _ = proc.communicate(timeout=deadline_s)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        out, _ = proc.communicate()
        pytest.fail(f"the async-ppo world overran {deadline_s} s:\n"
                    f"{out[-4000:]}")
    # every process of the world is gone (a zombie has exited; the
    # multiprocessing resource tracker may take a moment after the launcher)
    deadline = time.monotonic() + 15
    while _live_group_members(proc.pid) and time.monotonic() < deadline:
        time.sleep(0.1)
    left = _live_group_members(proc.pid)
    if left:
        os.killpg(proc.pid, signal.SIGKILL)
    assert not left, left
    return proc.returncode, out


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


def test_async_ppo_world_on_the_cpu(tmp_path):
    rc, out = _run_world(tmp_path, _world_overrides(tmp_path, "appo-test")
                         + ["gen.device=cpu"])
    assert rc == 0, out[-4000:]
    logs = tmp_path / "root" / "logs" / "appo-test" / "t0"
    lines = [json.loads(l) for l in open(logs / "metrics.jsonl")]
    assert len(lines) == 2
    for ln in lines:
        for k in ("ppo/actor_loss", "ppo/grad_norm", "ppo/n_tokens"):
            assert np.isfinite(ln[k]), k
    sync_root = (tmp_path / "root" / "checkpoints" / "appo-test" / "t0"
                 / "weight_sync")
    # v0 was published, then pruned by the manager's keep-2 policy
    assert sorted(os.listdir(sync_root)) == ["v1", "v2"]
    dump = json.load(open(logs / "gen_server_0.json"))
    assert dump["version"] == 2 and dump["engine_decode_steps"] > 0


def test_agentic_rm_scored_world_on_the_cpu(tmp_path):
    """The multi-turn agent, a trained reward model as the graph's
    ``reward_inf`` node and the actor under ``dots_attn``, through
    ``python -m areal_tpu_torch.apps.main async-ppo`` on the CPU."""
    overrides = [o for o in _world_overrides(tmp_path, "agentic")
                 if not o.startswith(("gconfig=", "control.total_train"))]
    rc, out = _run_world(tmp_path, overrides + [
        "gen.device=cpu", "control.total_train_steps=1",
        f"reward={json.dumps({'arch': TINY_ARCH})}",
        "rollout.agent=math-multi-turn",
        'rollout.agent_args={"max_turns": 2, "turn_discount": 0.9, '
        '"feedback_token_ids": [3, 4, 5]}',
        'actor.overrides={"remat_policy": "dots_attn"}',
        'gconfig={"n": 1, "max_new_tokens": 8}',
    ])
    assert rc == 0, out[-4000:]
    assert "NotImplementedError" not in out
    logs = tmp_path / "root" / "logs" / "agentic" / "t0"
    lines = [json.loads(l) for l in open(logs / "metrics.jsonl")]
    assert len(lines) == 1
    for k in ("ppo/actor_loss", "ppo/grad_norm", "ppo/n_tokens"):
        assert np.isfinite(lines[0][k]), k


def test_a_card_designated_server_without_a_gpu_fails_the_world(tmp_path):
    rc, out = _run_world(tmp_path, _world_overrides(tmp_path, "nogpu")
                         + ["gen.device="])
    assert rc != 0
    assert "no CUDA device is available" in out


# --------------------------------------------------------------------------- #
# worker plumbing copied from the reference: held against it
# --------------------------------------------------------------------------- #


def test_seeding_flops_and_finetune_spec_match_the_reference():
    import random

    from areal_tpu.api.model import FinetuneSpec as JaxSpec
    from areal_tpu.base import flops as jax_flops
    from areal_tpu.base import seeding as jax_seeding
    from areal_tpu.models.config import ModelConfig as JaxConfig
    from areal_tpu_torch.api.model import FinetuneSpec
    from areal_tpu_torch.base import flops, seeding
    from areal_tpu_torch.models.config import ModelConfig

    jax_seeding.set_random_seed(3, "worker")
    want = (random.random(), np.random.random())
    seeding.set_random_seed(3, "worker")
    assert (random.random(), np.random.random()) == want
    g1, g2 = seeding.torch_generator("a"), seeding.torch_generator("a")
    assert torch.equal(torch.rand(4, generator=g1), torch.rand(4, generator=g2))
    assert not torch.equal(torch.rand(4, generator=seeding.torch_generator("b")),
                           torch.rand(4, generator=seeding.torch_generator("a")))
    for kw in (TINY_ARCH, dict(TINY_ARCH, tied_embedding=True),
               dict(TINY_ARCH, is_critic=True)):
        j, p = JaxConfig(**kw), ModelConfig(**kw)
        assert flops.param_count(p) == jax_flops.param_count(j)
        for lens in ([7, 9, 30], None):
            assert flops.train_flops(p, 46, lens) == jax_flops.train_flops(
                j, 46, lens)
            assert flops.forward_flops(p, 46, lens) == jax_flops.forward_flops(
                j, 46, lens)
    for args in ((2, 100, 32), (1, 10, 32)):
        a, b = FinetuneSpec(*args), JaxSpec(*args)
        assert (a.steps_per_epoch, a.total_train_steps) == (
            b.steps_per_epoch, b.total_train_steps)


def test_metric_logger_writes_the_reference_layout(tmp_path):
    from areal_tpu.base.metrics import MetricLogger as JaxLogger
    from areal_tpu_torch.base.metrics import MetricLogger

    for cls, d in ((JaxLogger, tmp_path / "jax"), (MetricLogger, tmp_path / "pt")):
        log = cls(str(d), backends=("jsonl",))
        log.log({"actor_loss": 0.5, "grad_norm": 2.0}, 3, prefix="ppo",
                wall_time=123.0)
        log.log({"x": 1.0}, 4)
        log.close()
        log.close()
    want = (tmp_path / "jax" / "metrics.jsonl").read_text().splitlines()
    got = (tmp_path / "pt" / "metrics.jsonl").read_text().splitlines()
    assert got[0] == want[0]
    assert [json.loads(l)["x"] for l in got[1:]] == [1.0]


def test_hbm_monitor_has_no_gauges_on_the_cpu():
    from areal_tpu_torch.base import hbm

    mon = hbm.HBMMonitor(device="cpu", tag="t")
    assert mon.check() == {} and mon.check(kill=False) == {}
    assert hbm.device_memory_stats("cpu") is None


def test_name_resolve_reconfigure_switches_backends(tmp_path):
    from areal_tpu_torch.base import name_resolve

    saved = name_resolve.default_repository()
    try:
        name_resolve.reconfigure(name_resolve.NameResolveConfig(
            type="file", root=str(tmp_path)))
        name_resolve.add("a/b", "1")
        assert (tmp_path / "a" / "b" / "__value__").read_text() == "1"
        name_resolve.reconfigure(name_resolve.NameResolveConfig(type="memory"))
        with pytest.raises(name_resolve.NameEntryNotFoundError):
            name_resolve.get("a/b")
        # the TCP backend: a client of the port's server
        from areal_tpu_torch.base import name_resolve_server

        srv = name_resolve_server.NameResolveServer("127.0.0.1", 0)
        addr = srv.start()
        try:
            name_resolve.reconfigure(name_resolve.NameResolveConfig(
                type="rpc", root=addr))
            name_resolve.add("a/b", "2")
            assert name_resolve.get("a/b") == "2"
            name_resolve.default_repository().close()
        finally:
            srv.stop()
        with pytest.raises(ValueError, match="host:port"):
            name_resolve.RpcNameRecordRepository("no-port")
        with pytest.raises(ValueError, match="Unknown"):
            name_resolve.make_repository(name_resolve.NameResolveConfig(
                type="zk"))
    finally:
        name_resolve.set_repository(saved)
