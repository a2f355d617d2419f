"""Local multiprocess launcher and the worker entry functions of the
async-PPO world, and the in-process recipes (sync PPO, SFT, paired
reward-model training): the counterpart of ``areal_tpu/apps/launcher.py``.

Each worker role runs as a spawned process: the generation servers, the
gserver manager, the rollout workers and the trainer. They rendezvous
through the file-backed name_resolve under the experiment's file root.
The launcher owns the experiment's lifecycle record (running / stopped),
watches its children and, on a failure with ``recover_mode=auto``, stops
the world and restarts it (restart-the-world recovery, resuming from the
last committed recover checkpoint).

When the trainer has finished, the launcher waits (bounded) until the
manager has moved the fleet to the trainer's last announced version
before it stops the world, so a run ends with its final weights served
and the superseded snapshots pruned; the reference stops at once.

Devices: a server or trainer whose device is ``""`` runs on the card
(``base/device.py::resolve_device``, which raises where there is none);
``"cpu"`` runs it on the CPU. The manager and the rollout workers are
host code and are started with ``CUDA_VISIBLE_DEVICES`` empty, so they
never create a CUDA context. On one card the servers and the trainer are
separate CUDA processes that time-slice it.

``run_sync_ppo``, ``run_sft`` and ``run_rw`` run in the calling process
on ``trainer_device``: generation on the trainer's own params
(``train/generation.py``), no fleet, no weight publish.

Not ported yet, and raising ``NotImplementedError``: the serving gateway
and the evaluator roles, a trained reward model as a node of the PPO
graph, tensor-parallel or speculative-decoding servers, the TCP
name-resolve backend and the elastic trainer world (``ROADMAP.md``).
"""

import asyncio
import contextlib
import dataclasses
import logging
import multiprocessing as mp
import os
import sys
import time
from typing import Dict

logger = logging.getLogger("areal_tpu_torch.launcher")


def _device_arg(device: str):
    """``""`` -> None (the card, through ``resolve_device``), else the
    device named."""
    return device or None


def _setup_worker_env(cfg, device: str = ""):
    """Common per-process setup: logging, file root, name_resolve, names,
    seeding."""
    logging.basicConfig(
        level=logging.INFO,
        format=f"%(asctime)s {mp.current_process().name} %(name)s "
               "%(levelname)s: %(message)s",
    )
    from areal_tpu_torch.base import constants, name_resolve, seeding

    if cfg.fileroot:
        os.environ["AREAL_FILEROOT"] = cfg.fileroot
    os.environ.setdefault(
        "AREAL_NAME_RESOLVE_ROOT",
        os.path.join(cfg.fileroot or constants.default_root(), "name_resolve"),
    )
    if os.environ.get("AREAL_NAME_RESOLVE_RPC"):
        raise NotImplementedError(
            "the TCP name-resolve backend (AREAL_NAME_RESOLVE_RPC) is not "
            "ported yet (ROADMAP.md)")
    name_resolve.reconfigure(
        name_resolve.NameResolveConfig(
            type="file", root=constants.name_resolve_root()
        )
    )
    constants.set_experiment_trial_names(cfg.experiment_name, cfg.trial_name)
    if cfg.fileroot:
        constants.set_fileroot(cfg.fileroot)
    seeding.set_random_seed(cfg.seed, "worker")


def _load_engine(spec, is_critic=False, with_optimizer=True, total_steps=100,
                 device: str = ""):
    from areal_tpu_torch.train.engine import TrainEngine

    cfg = spec.model_config(is_critic=is_critic)
    eng = TrainEngine(
        cfg,
        spec.parallel_config(),
        spec.optimizer if with_optimizer else None,
        param_dtype=getattr(spec, "param_dtype", "float32"),
        device=_device_arg(device),
    )
    if spec.path:
        eng.load_hf(spec.path, init_critic_head=is_critic)
    else:
        eng.init_random(0)
    if with_optimizer:
        eng.setup_optimizer(total_steps)
    return eng


def _check_ported(cfg):
    """Raise before anything starts for options whose workers are not
    ported yet."""
    if cfg.gateway.enabled:
        raise NotImplementedError(
            "the serving gateway (gateway_main) is not ported yet "
            "(ROADMAP.md)")
    if cfg.evaluator.enabled:
        raise NotImplementedError(
            "the evaluator (evaluator_main) is not ported yet (ROADMAP.md)")
    if cfg.reward is not None:
        raise NotImplementedError(
            "a trained reward model as a node of the PPO graph is not ported "
            "yet (ROADMAP.md)")
    _check_gen_ported(cfg.gen)


def _check_gen_ported(gen):
    if gen.tp_size > 1:
        raise NotImplementedError(
            f"gen.tp_size={gen.tp_size}: tensor-parallel servers are not "
            "ported yet (ROADMAP.md)")
    if gen.spec_decode or gen.spec_k or gen.spec_draft_model:
        raise NotImplementedError(
            "speculative decoding and draft models are not ported yet "
            "(ROADMAP.md)")


# --------------------------------------------------------------------------- #
# worker mains (multiprocessing spawn targets)
# --------------------------------------------------------------------------- #


def gen_server_main(cfg, server_idx: int):
    _check_gen_ported(cfg.gen)
    _setup_worker_env(cfg, cfg.gen.device)
    from areal_tpu_torch.base import constants, name_resolve, names
    from areal_tpu_torch.base.device import resolve_device, torch_dtype
    from areal_tpu_torch.gen.engine import GenerationEngine
    from areal_tpu_torch.gen.server import serve
    from areal_tpu_torch.models import hf as hf_conv
    from areal_tpu_torch.models import transformer as tfm
    from areal_tpu_torch.system.worker_base import (
        ExperimentStatusWatch,
        Heartbeat,
    )

    device = resolve_device(_device_arg(cfg.gen.device))
    mcfg = cfg.actor.model_config()
    if cfg.actor.path:
        _, host_params = hf_conv.load_hf_checkpoint(cfg.actor.path)
        params = tfm.params_from_numpy(host_params, device=device,
                                       dtype=mcfg.dtype)
    else:
        # the trainer's own init (TrainEngine.init_random(0)); the engine
        # casts it to the serving dtype
        params = tfm.init_params(mcfg, seed=0, device=device,
                                 dtype=torch_dtype(cfg.actor.param_dtype))
    engine = GenerationEngine(
        mcfg,
        params,
        max_slots=cfg.gen.max_slots,
        max_seqlen=cfg.gen.max_seqlen,
        max_new_tokens_cap=cfg.gen.max_new_tokens_cap,
        stop_token_ids=cfg.gen.stop_token_ids,
        seed=cfg.seed + server_idx,
        page_size=cfg.gen.page_size,
        n_pages=cfg.gen.n_pages,
        kv_dtype=cfg.gen.kv_dtype,
        device=device,
    )
    del params
    if device.type == "cuda":
        import torch

        torch.cuda.empty_cache()
    host = "127.0.0.1"
    srv = serve(
        engine, host, 0, decode_steps=cfg.gen.decode_steps_per_chunk,
        metrics_dump_path=os.path.join(
            constants.get_log_root(), f"gen_server_{server_idx}.json"
        ),
    )
    name_resolve.add(
        names.gen_server(cfg.experiment_name, cfg.trial_name, server_idx),
        f"http://{host}:{srv.port}",
        replace=True,
    )
    # orphan protection: exit when the experiment dies
    watch = ExperimentStatusWatch(cfg.experiment_name, cfg.trial_name)
    hb = Heartbeat(
        cfg.experiment_name, cfg.trial_name, f"gen_server/{server_idx}"
    ).start()
    try:
        while watch.alive():
            time.sleep(1.0)
    finally:
        hb.stop()
        srv.stop()


def gserver_manager_config(cfg):
    """The manager's config as the reference's launcher builds it. Its
    ``train_batch_size`` is in SEQUENCES (groups x ``gconfig.n``), while
    the trainer bumps ``training_samples`` by groups and the manager counts
    running rollouts per group: in the launcher's world the staleness gate
    is ``gconfig.n`` x looser than a window of ``train_batch_size`` groups
    (the reference's own behaviour, kept as it is)."""
    from areal_tpu_torch.system.gserver_manager import GserverManagerConfig

    gconfig_n = (cfg.gconfig.n if not isinstance(cfg.gconfig, dict)
                 else cfg.gconfig.get("n", 1))
    return GserverManagerConfig(
        experiment_name=cfg.experiment_name,
        trial_name=cfg.trial_name,
        model_name="actor",
        train_batch_size=cfg.train_batch_size * gconfig_n,
        max_head_offpolicyness=cfg.manager.max_head_offpolicyness,
        max_concurrent_rollouts=cfg.manager.max_concurrent_rollouts,
        schedule_policy=cfg.manager.schedule_policy,
    )


def gserver_manager_main(cfg):
    _setup_worker_env(cfg, "cpu")
    from areal_tpu_torch.base import name_resolve, names
    from areal_tpu_torch.system.gserver_manager import (
        GserverManager,
        serve_manager,
    )
    from areal_tpu_torch.system.worker_base import (
        ExperimentStatusWatch,
        Heartbeat,
    )

    manager = GserverManager(gserver_manager_config(cfg))
    for i in range(cfg.gen.n_servers):
        name_resolve.wait(
            names.gen_server(cfg.experiment_name, cfg.trial_name, i),
            timeout=300,
        )
    manager.discover_servers()
    serve_manager(manager, "127.0.0.1", 0)
    watch = ExperimentStatusWatch(cfg.experiment_name, cfg.trial_name)
    hb = Heartbeat(cfg.experiment_name, cfg.trial_name,
                   "gserver_manager").start()
    try:
        while watch.alive():
            time.sleep(1.0)
    finally:
        hb.stop()
        manager.stop()


def rollout_worker_main(cfg, worker_idx: int):
    _setup_worker_env(cfg, "cpu")
    from areal_tpu_torch.api.agent import make_agent
    from areal_tpu_torch.api.dataset import DatasetUtility, make_dataset
    from areal_tpu_torch.api.env import make_env
    from areal_tpu_torch.api.model import GenerationHyperparameters
    from areal_tpu_torch.base import http
    from areal_tpu_torch.system import worker_base
    from areal_tpu_torch.system.rollout_worker import RolloutWorker
    from areal_tpu_torch.system.worker_base import (
        ExperimentStatusWatch,
        Heartbeat,
    )

    util = DatasetUtility(
        seed=cfg.dataset.seed,
        dp_rank=worker_idx,
        world_size=cfg.rollout.n_workers,
    )
    dataset = make_dataset(
        cfg.dataset.name, util, path=cfg.dataset.path,
        max_length=cfg.dataset.max_length,
    )
    env_args = dict(cfg.rollout.env_args)
    if hasattr(dataset, "load_metadata") and "dataset_metadata" not in env_args:
        env_args["dataset_metadata"] = dataset.load_metadata()
    env = make_env(cfg.rollout.env, **env_args)
    gconfig = cfg.gconfig
    if isinstance(gconfig, dict):
        gconfig = GenerationHyperparameters(**gconfig)
    agent = make_agent(cfg.rollout.agent, gconfig=gconfig,
                       **dict(cfg.rollout.agent_args))
    worker = RolloutWorker(
        experiment_name=cfg.experiment_name,
        trial_name=cfg.trial_name,
        worker_index=worker_idx,
        n_workers=cfg.rollout.n_workers,
        n_pullers=1,
        agent=agent,
        env=env,
        dataset=dataset,
        new_tokens_per_chunk=cfg.rollout.new_tokens_per_chunk,
        max_concurrent_tasks=cfg.rollout.max_concurrent_tasks,
    )
    watch = ExperimentStatusWatch(cfg.experiment_name, cfg.trial_name)
    hb = Heartbeat(
        cfg.experiment_name, cfg.trial_name, f"rollout_worker/{worker_idx}"
    ).start()
    try:
        asyncio.run(worker.run_async(should_stop=lambda: not watch.alive()))
    except http.ClientConnectionError:
        # the manager exits at teardown before this worker's next poll
        # of the status sees it: not a failure once the run is over
        if not worker_base.experiment_stopped(cfg.experiment_name,
                                              cfg.trial_name):
            raise
        logger.info("manager gone at teardown; rollout worker stops")
    finally:
        hb.stop()


def _load_ppo_engines(cfg, total_steps):
    """actor / optional ref / optional critic from an experiment config:
    ONE place for the gating rules."""
    dev = cfg.trainer_device
    actor = _load_engine(cfg.actor, total_steps=total_steps, device=dev)
    ref = None
    if cfg.use_ref_model and (cfg.ppo.kl_ctl != 0 or cfg.ema_ref_eta is not None):
        ref = _load_engine(cfg.actor, with_optimizer=False, device=dev)
    critic = None
    if cfg.critic is not None and not cfg.ppo.disable_value:
        critic = _load_engine(cfg.critic, is_critic=True,
                              total_steps=total_steps, device=dev)
    return actor, ref, critic


def trainer_main(cfg):
    _setup_worker_env(cfg, cfg.trainer_device)
    from areal_tpu_torch.base import constants
    from areal_tpu_torch.base.metrics import MetricLogger
    from areal_tpu_torch.system import worker_base
    from areal_tpu_torch.system.stream_dataset import PullerStreamDataset
    from areal_tpu_torch.system.trainer_worker import (
        AsyncPPOTrainerWorker,
        TrainerControl,
    )

    # SIGTERM / SIGINT flips a flag the train loop polls; the worker then
    # commits a recover checkpoint within the deadline and we exit
    # EXIT_PREEMPTED, which run_async_ppo maps to "restart the world"
    shutdown = worker_base.GracefulShutdown.from_env()
    total = cfg.control.total_train_steps
    # bind the puller first so rollout workers can rendezvous while the
    # engines load
    stream = PullerStreamDataset(
        cfg.experiment_name, cfg.trial_name, 0, offline_dataset_size=10_000
    )
    actor, ref, critic = _load_ppo_engines(cfg, total)
    worker = AsyncPPOTrainerWorker(
        experiment_name=cfg.experiment_name,
        trial_name=cfg.trial_name,
        actor_engine=actor,
        stream=stream,
        hp=cfg.ppo,
        control=TrainerControl(
            total_train_steps=total,
            save_freq_steps=cfg.control.save_freq_steps,
            ckpt_freq_steps=cfg.control.ckpt_freq_steps,
            ckpt_freq_secs=cfg.control.ckpt_freq_secs,
            weight_sync_freq_steps=cfg.control.weight_sync_freq_steps,
            watchdog_timeout_secs=worker_base.watchdog_timeout_from_env(),
        ),
        train_batch_size=cfg.train_batch_size,
        mb_spec=cfg.mb_spec,
        ref_engine=ref,
        critic_engine=critic,
        hf_family=cfg.hf_family,
        metric_logger=MetricLogger(constants.get_log_root()),
        ema_ref_eta=cfg.ema_ref_eta,
        max_head_offpolicyness=cfg.manager.max_head_offpolicyness,
    )
    recovered = False
    if cfg.recover_mode in ("auto", "resume"):
        # a successful recover republishes model_version and
        # training_samples itself
        recovered = worker.load_recover_checkpoint()
    if not recovered:
        # v0: the fleet starts from the trainer's init
        worker.publish_weights()
    try:
        worker.run(shutdown=shutdown)
    finally:
        stream.close()
        if worker.metrics is not None:
            worker.metrics.close()
    if worker.preempted:
        sys.exit(worker_base.EXIT_PREEMPTED)


# --------------------------------------------------------------------------- #
# orchestration
# --------------------------------------------------------------------------- #


@contextlib.contextmanager
def _cpu_child_env(force_cpu: bool):
    """Spawned children inherit the parent's environment at exec: for a
    CPU-designated worker, hide every CUDA device around
    ``Process.start()`` so it never creates a CUDA context on the card."""
    if not force_cpu:
        yield
        return
    old = os.environ.get("CUDA_VISIBLE_DEVICES")
    os.environ["CUDA_VISIBLE_DEVICES"] = ""
    try:
        yield
    finally:
        if old is None:
            os.environ.pop("CUDA_VISIBLE_DEVICES", None)
        else:
            os.environ["CUDA_VISIBLE_DEVICES"] = old


def _spawn_all(cfg) -> Dict[str, mp.Process]:
    ctx = mp.get_context("spawn")
    procs: Dict[str, mp.Process] = {}

    def start(name, p, force_cpu):
        with _cpu_child_env(force_cpu):
            p.start()
        procs[name] = p
        logger.info("started %s (pid %d)", name, p.pid)

    gen_cpu = cfg.gen.device == "cpu"
    for i in range(cfg.gen.n_servers):
        start(
            f"gen_server/{i}",
            ctx.Process(target=gen_server_main, args=(cfg, i), daemon=True),
            gen_cpu,
        )
    start(
        "gserver_manager",
        ctx.Process(target=gserver_manager_main, args=(cfg,), daemon=True),
        True,
    )
    for i in range(cfg.rollout.n_workers):
        start(
            f"rollout_worker/{i}",
            ctx.Process(target=rollout_worker_main, args=(cfg, i), daemon=True),
            True,
        )
    start(
        "trainer",
        ctx.Process(target=trainer_main, args=(cfg,), daemon=True),
        cfg.trainer_device == "cpu",
    )
    return procs


def _wait_fleet_version(cfg, procs: Dict[str, mp.Process],
                        timeout: float = 300.0) -> bool:
    """Wait until the manager reports the version the trainer announced
    last (its ``/metrics_json``), or the manager dies, or ``timeout``."""
    import json
    import urllib.request

    from areal_tpu_torch.base import name_resolve, names

    try:
        raw = name_resolve.get(
            names.model_version(cfg.experiment_name, cfg.trial_name, "actor"))
        url = name_resolve.get(
            names.gserver_manager(cfg.experiment_name, cfg.trial_name))
    except name_resolve.NameEntryNotFoundError:
        return False
    want = int(raw.partition(":")[0])
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if not procs["gserver_manager"].is_alive():
            return False
        try:
            with urllib.request.urlopen(f"{url}/metrics_json",
                                        timeout=5) as r:
                if json.load(r)["version"] >= want:
                    return True
        except (OSError, ValueError, KeyError):
            pass
        time.sleep(0.2)
    logger.warning("the fleet did not reach v%d within %.0fs", want, timeout)
    return False


def _stop_all(cfg, procs: Dict[str, mp.Process]):
    """Graceful first: flip the status so watchers exit on their own, then
    terminate stragglers, then kill what survives (the trainer turns
    SIGTERM into a preemption save; the commit protocol makes a hard kill
    mid-save safe)."""
    from areal_tpu_torch.system import worker_base

    worker_base.mark_experiment_stopped(cfg.experiment_name, cfg.trial_name)
    deadline = time.time() + 5
    for p in procs.values():
        p.join(timeout=max(0.1, deadline - time.time()))
    for p in procs.values():
        if p.is_alive():
            p.terminate()
    for p in procs.values():
        p.join(timeout=10)
    for name, p in procs.items():
        if p.is_alive():
            logger.warning("%s survived terminate(); escalating to kill", name)
            p.kill()
            p.join(timeout=10)


def run_async_ppo(cfg) -> int:
    """Launch the full async-PPO world; restart on failure per
    ``recover_mode``. Returns the trainer's exit code of the final
    attempt (non-zero when a sibling crashed)."""
    _check_ported(cfg)
    attempts = 1 + (cfg.recover_retries if cfg.recover_mode == "auto" else 0)
    # the launcher owns the experiment lifecycle record: workers poll it and
    # stop when it goes away
    _setup_worker_env(cfg, "")
    from areal_tpu_torch.system import worker_base

    trainer, failed = None, False
    for attempt in range(attempts):
        if attempt > 0:
            logger.warning("recover attempt %d/%d", attempt, attempts - 1)
            cfg = dataclasses.replace(cfg, recover_mode="resume")
        worker_base.mark_experiment_running(cfg.experiment_name, cfg.trial_name)
        procs = _spawn_all(cfg)
        trainer = procs["trainer"]
        failed = False
        try:
            while trainer.is_alive():
                trainer.join(timeout=1)
                for name, p in procs.items():
                    if name != "trainer" and not p.is_alive():
                        logger.error("%s died (exit %s)", name, p.exitcode)
                        failed = True
                        break
                if failed:
                    break
            if trainer.exitcode == 0 and not failed:
                _wait_fleet_version(cfg, procs)
        finally:
            _stop_all(cfg, procs)
        if trainer.exitcode == 0 and not failed:
            return 0
        if trainer.exitcode == worker_base.EXIT_PREEMPTED and not failed:
            logger.warning(
                "trainer preempted (exit %d): recover checkpoint committed; "
                "restart-the-world", worker_base.EXIT_PREEMPTED,
            )
        if cfg.recover_mode != "auto":
            break
    rc = trainer.exitcode if trainer.exitcode is not None else 1
    if failed and rc in (0, worker_base.EXIT_PREEMPTED):
        # a sibling's crash triggered the teardown: the trainer's own code
        # would hide it
        rc = 1
    return rc


# --------------------------------------------------------------------------- #
# in-process recipes
# --------------------------------------------------------------------------- #


def _tokenizer(cfg):
    if not cfg.tokenizer_path:
        return None
    import transformers

    return transformers.AutoTokenizer.from_pretrained(cfg.tokenizer_path)


def run_sync_ppo(cfg) -> int:
    """Sync PPO runs in-process: generation happens on the trainer's own
    params on ``trainer_device`` (no fleet, no weight publish)."""
    if cfg.evaluator.enabled:
        raise NotImplementedError(
            "the evaluator (evaluator_main) is not ported yet (ROADMAP.md)")
    _setup_worker_env(cfg, cfg.trainer_device)
    from areal_tpu_torch.api.dataset import DatasetUtility, make_dataset
    from areal_tpu_torch.base import constants
    from areal_tpu_torch.base.metrics import MetricLogger
    from areal_tpu_torch.system import worker_base
    from areal_tpu_torch.system.sync_trainer import SyncPPOTrainerWorker
    from areal_tpu_torch.system.trainer_worker import TrainerControl

    worker_base.mark_experiment_running(cfg.experiment_name, cfg.trial_name)
    tokenizer = _tokenizer(cfg)
    util = DatasetUtility(
        seed=cfg.dataset.seed, dp_rank=0, world_size=1, tokenizer=tokenizer
    )
    dataset = make_dataset(
        cfg.dataset.name, util, path=cfg.dataset.path,
        max_length=cfg.dataset.max_length,
    )
    total = cfg.control.total_train_steps
    actor, ref, critic = _load_ppo_engines(cfg, total)
    decode_fn = None
    if tokenizer is not None:
        def decode_fn(ids):
            return tokenizer.decode(ids, skip_special_tokens=True)
    metrics = MetricLogger(constants.get_log_root())
    worker = SyncPPOTrainerWorker(
        experiment_name=cfg.experiment_name,
        trial_name=cfg.trial_name,
        actor_engine=actor,
        dataset=dataset,
        hp=cfg.ppo,
        ghp=cfg.gconfig,
        control=TrainerControl(
            total_train_steps=total,
            save_freq_steps=cfg.control.save_freq_steps,
        ),
        batch_size=cfg.batch_size,
        mb_spec=cfg.mb_spec,
        ref_engine=ref,
        critic_engine=critic,
        ema_ref_eta=cfg.ema_ref_eta,
        decode_fn=decode_fn,
        hf_family=cfg.hf_family,
        metric_logger=metrics,
        seed=cfg.seed,
    )
    try:
        worker.run()
    finally:
        metrics.close()
        worker_base.mark_experiment_stopped(cfg.experiment_name, cfg.trial_name)
    return 0


def _run_supervised(cfg, *, is_critic: bool, interface_name: str,
                    dataset_kwargs=None, interface_kwargs=None) -> int:
    """Shared body of the in-process supervised recipes (SFT / paired RW):
    one trainer, no fleet; only the objective differs."""
    _setup_worker_env(cfg, cfg.trainer_device)
    from areal_tpu_torch.api.data import MicroBatchSpec
    from areal_tpu_torch.api.dataset import DatasetUtility, make_dataset
    from areal_tpu_torch.base import constants
    from areal_tpu_torch.base.metrics import MetricLogger
    from areal_tpu_torch.system.trainer_worker import (
        SFTTrainerWorker,
        TrainerControl,
    )

    dataset_kwargs = dataset_kwargs or {}
    util = DatasetUtility(
        seed=cfg.dataset.seed, dp_rank=0, world_size=1,
        tokenizer=_tokenizer(cfg),
    )
    dataset = make_dataset(
        cfg.dataset.name, util, path=cfg.dataset.path,
        max_length=cfg.dataset.max_length, **dataset_kwargs,
    )
    eval_ds = None
    if cfg.eval_dataset is not None:
        eval_ds = make_dataset(
            cfg.eval_dataset.name, util, path=cfg.eval_dataset.path,
            max_length=cfg.eval_dataset.max_length, **dataset_kwargs,
        )
    engine = _load_engine(
        cfg.model, is_critic=is_critic,
        total_steps=cfg.control.total_train_steps, device=cfg.trainer_device,
    )
    metrics = MetricLogger(constants.get_log_root())
    worker = SFTTrainerWorker(
        experiment_name=cfg.experiment_name,
        trial_name=cfg.trial_name,
        engine=engine,
        dataset=dataset,
        eval_dataset=eval_ds,
        control=TrainerControl(
            total_train_steps=cfg.control.total_train_steps,
            save_freq_steps=cfg.control.save_freq_steps,
        ),
        batch_size=cfg.batch_size,
        mb_spec=MicroBatchSpec(max_tokens_per_mb=cfg.max_tokens_per_mb),
        hf_family=cfg.hf_family,
        metric_logger=metrics,
        interface_name=interface_name,
        interface_kwargs=interface_kwargs,
    )
    try:
        worker.run()
    finally:
        metrics.close()
    return 0


def run_rw(cfg) -> int:
    """Paired reward-model training: a critic-architecture model and the
    Bradley-Terry pairwise loss over ``rw_paired`` data; its HF exports
    keep the trained value head."""
    return _run_supervised(
        cfg,
        is_critic=True,
        interface_name="reward",
        dataset_kwargs={"max_pairs_per_prompt": cfg.max_pairs_per_prompt},
        interface_kwargs={"max_pairs_per_prompt": cfg.max_pairs_per_prompt},
    )


def run_sft(cfg) -> int:
    """SFT runs in-process: one trainer, no fleet."""
    return _run_supervised(cfg, is_critic=False, interface_name="sft")
