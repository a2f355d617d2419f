"""Local multiprocess launcher and the worker entry functions of the
async-PPO world, and the in-process recipes (sync PPO, SFT, paired
reward-model training): the counterpart of ``areal_tpu/apps/launcher.py``.

Each worker role runs as a spawned process: the generation servers, the
gserver manager, the serving gateway (``gateway.enabled``), the rollout
workers and the trainer. They rendezvous through the file-backed
name_resolve under the experiment's file root.
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

A ``reward`` model spec puts a trained reward model into the async
trainer's PPO graph (``reward_inf``); ``run_sync_ppo`` ignores it, as the
reference does.

Every spawned worker installs a flight recorder (``<fileroot>/flight/``
on a crash, preemption, watchdog trip or guard rollback), starts a span
flusher when ``AREAL_TRACE_FLUSH_S`` asks for one and, with
``AREAL_TELEMETRY_EXPORT`` on, a telemetry exporter for its role (gen
server, manager, rollout worker, trainer). With ``AREAL_NAME_RESOLVE_RPC
=host:port`` the workers rendezvous through the TCP name-resolve server
(``base/name_resolve_server.py``) instead of the file root.

Not ported yet, and raising ``NotImplementedError``: the evaluator role,
tensor-parallel servers and the elastic trainer world (``ROADMAP.md``).
"""

import asyncio
import contextlib
import dataclasses
import functools
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
    # cross-process rendezvous: the TCP server when one is advertised
    # (several hosts, no shared filesystem), else the file root
    rpc_addr = constants.name_resolve_rpc()
    if rpc_addr:
        name_resolve.reconfigure(
            name_resolve.NameResolveConfig(type="rpc", root=rpc_addr))
    else:
        name_resolve.reconfigure(
            name_resolve.NameResolveConfig(
                type="file", root=constants.name_resolve_root()
            )
        )
    constants.set_experiment_trial_names(cfg.experiment_name, cfg.trial_name)
    if cfg.fileroot:
        constants.set_fileroot(cfg.fileroot)
    seeding.set_random_seed(cfg.seed, "worker")


@contextlib.contextmanager
def _worker_observability(worker_name: str):
    """A spawned worker's black box and span flushing: a flight recorder
    installed for the process (dumped on an exception that ends the worker:
    multiprocessing reports those itself, so ``sys.excepthook`` never
    sees them) and a span flusher when ``AREAL_TRACE_FLUSH_S`` > 0."""
    from areal_tpu_torch.base import tracing
    from areal_tpu_torch.system import worker_base

    recorder = worker_base.FlightRecorder(worker_name).install()
    flusher = tracing.SpanFlusher.maybe_start(worker_name)
    try:
        yield
    except Exception as e:
        recorder.dump("crash", {"exc": type(e).__name__, "msg": str(e)})
        raise
    finally:
        if flusher is not None:
            flusher.stop()
        recorder.uninstall()


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
    if cfg.evaluator.enabled:
        raise NotImplementedError(
            "the evaluator (evaluator_main) is not ported yet (ROADMAP.md)")
    _check_gen_ported(cfg.gen)


def _check_gen_ported(gen):
    if gen.tp_size > 1:
        raise NotImplementedError(
            f"gen.tp_size={gen.tp_size}: tensor-parallel servers are not "
            "ported yet (ROADMAP.md)")


def _gen_drafter(gen):
    """The draft MODEL for spec decode: ``gen.spec_draft_model`` beats the
    env knob (None lets the engine fall through to ``AREAL_SPEC_DRAFT_
    MODEL``, then the n-gram self-drafter). Loaded only when spec decode is
    on: the engine keeps an explicit drafter regardless of the flag, so
    loading one for a spec-disabled fleet would make every server pay a
    draft pool and a per-step sweep while never speculating."""
    from areal_tpu_torch.base import constants

    spec_on = (gen.spec_decode if gen.spec_decode is not None
               else constants.spec_decode_enabled())
    if gen.spec_draft_model and spec_on:
        from areal_tpu_torch.gen.drafter import TransformerDrafter

        return TransformerDrafter.from_hf(gen.spec_draft_model,
                                          kv_dtype=gen.spec_draft_kv_dtype)
    if gen.spec_draft_model:
        logger.warning(
            "gen.spec_draft_model is set but spec decode is disabled for "
            "the gen fleet; not loading the draft model (set "
            "gen.spec_decode=true or %s to serve it)",
            constants.SPEC_DECODE_ENV,
        )
    return None


# --------------------------------------------------------------------------- #
# worker mains (multiprocessing spawn targets)
# --------------------------------------------------------------------------- #


def gen_engine(cfg, server_idx: int):
    """The generation engine of server ``server_idx``: the actor's weights
    (its checkpoint, else the trainer's seed-0 init) in the serving dtype
    on ``gen.device``, with the fleet's pool, sampling and spec-decode
    options."""
    from areal_tpu_torch.base.device import resolve_device, torch_dtype
    from areal_tpu_torch.gen.engine import GenerationEngine
    from areal_tpu_torch.models import hf as hf_conv
    from areal_tpu_torch.models import transformer as tfm

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
        spec_decode=cfg.gen.spec_decode,
        spec_k=cfg.gen.spec_k,
        drafter=_gen_drafter(cfg.gen),
        device=device,
    )
    del params
    if device.type == "cuda":
        import torch

        torch.cuda.empty_cache()
    return engine


def gen_server_main(cfg, server_idx: int):
    _check_gen_ported(cfg.gen)
    _setup_worker_env(cfg, cfg.gen.device)
    with _worker_observability(f"gen_server/{server_idx}"):
        _gen_server(cfg, server_idx)


def _gen_server(cfg, server_idx: int):
    from areal_tpu_torch.base import constants, name_resolve, names
    from areal_tpu_torch.gen.server import serve
    from areal_tpu_torch.system.worker_base import (
        ExperimentStatusWatch,
        Heartbeat,
        TelemetryExporter,
    )

    engine = gen_engine(cfg, server_idx)
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
    tele = TelemetryExporter(
        cfg.experiment_name, cfg.trial_name,
        f"gen_server/{server_idx}", "gen_server",
        step_fn=lambda: max(engine.version, 0),
        gauges_fn=lambda: {
            "gen_running": float(engine.n_running()),
            "gen_pending": float(engine.n_pending()),
            # the device-memory headroom gauges the fleet view sums
            "kv_pool_bytes": float(engine.kv_pool_bytes()),
            "kv_pool_occupancy": engine.kv_pool_occupancy(),
            "kv_pool_demand_occupancy": engine.kv_pool_demand_occupancy(),
            "n_pages_free": float(engine.pool.n_free),
            "draft_kv_pool_bytes": float(engine.draft_kv_pool_bytes()),
            "draft_version": float(engine.draft_version),
        },
    ).maybe_start()
    try:
        while watch.alive():
            time.sleep(1.0)
    finally:
        hb.stop()
        srv.stop()
        # after the server: the final snapshot holds every answer served
        tele.stop()


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
    with _worker_observability("gserver_manager"):
        _gserver_manager(cfg)


def _gserver_manager(cfg):
    from areal_tpu_torch.base import name_resolve, names
    from areal_tpu_torch.system.gserver_manager import (
        GserverManager,
        serve_manager,
    )
    from areal_tpu_torch.system.worker_base import (
        ExperimentStatusWatch,
        Heartbeat,
        TelemetryExporter,
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
    tele = TelemetryExporter(
        cfg.experiment_name, cfg.trial_name, "gserver_manager", "manager",
        step_fn=lambda: max(manager.version, 0),
        gauges_fn=lambda: {
            "rollouts_running": float(manager.rollout_stat.running),
            "rollouts_submitted": float(manager.rollout_stat.submitted),
            "rollouts_accepted": float(manager.rollout_stat.accepted),
        },
        # per-server breaker states: the fleet view's servers_* tallies
        server_states_fn=manager.server_states,
    ).maybe_start()
    try:
        while watch.alive():
            time.sleep(1.0)
    finally:
        hb.stop()
        manager.stop()
        tele.stop()


def gateway_main(cfg):
    """Serving-gateway worker: the OpenAI-compatible API and the
    continuous-batching scheduler over the discovered gen servers, with an
    optional autoscaler resizing the ROUTED subset live (and mirroring
    every add/remove to the gserver manager so RL sticky routing follows)
    and an optional brownout ladder. The scheduler runs on this process's
    event loop; the HTTP frontend answers on threads of its own."""
    _setup_worker_env(cfg, "cpu")
    with _worker_observability("gateway"):
        asyncio.run(_gateway(cfg))


async def _gateway(cfg):
    from areal_tpu_torch.base import constants, name_resolve, names, network
    from areal_tpu_torch.gateway.api import (
        ByteFallbackCodec,
        GatewayConfig,
        GatewayServer,
        HFTokenizerCodec,
        serve_gateway,
    )
    from areal_tpu_torch.gateway.autoscaler import (
        Autoscaler,
        AutoscalerConfig,
        ScaleSignals,
    )
    from areal_tpu_torch.gateway.qos import TenantSpec
    from areal_tpu_torch.gateway.scheduler import ContinuousBatchScheduler
    from areal_tpu_torch.system import telemetry
    from areal_tpu_torch.system.worker_base import (
        ExperimentStatusWatch,
        Heartbeat,
        TelemetryExporter,
    )

    gspec = cfg.gateway
    # discovered fleet = scale-out ceiling; routed set starts full
    all_urls = []
    for i in range(cfg.gen.n_servers):
        key = names.gen_server(cfg.experiment_name, cfg.trial_name, i)
        name_resolve.wait(key, timeout=300)
        all_urls.append(name_resolve.get(key))
    # spec value 0 defers to the env knobs — for NAMED tenants too, or
    # listing a tenant in tenant_weights would silently strip its rate
    # limit while the anonymous tenant kept one
    rate = gspec.rate_tokens_per_s or constants.gateway_rate_tps()
    burst = gspec.burst_tokens or constants.gateway_burst()
    tenants = {
        name: TenantSpec(
            name=name, weight=w,
            rate_tokens_per_s=rate, burst_tokens=burst,
            default_deadline_s=gspec.default_deadline_s,
        )
        for name, w in gspec.tenant_weights.items()
    }
    scheduler = ContinuousBatchScheduler(
        list(all_urls),
        tenants,
        default_tenant=TenantSpec(
            name=gspec.default_tenant,
            rate_tokens_per_s=rate,
            burst_tokens=burst,
            default_deadline_s=gspec.default_deadline_s,
        ),
        max_queue=gspec.max_queue if gspec.max_queue >= 0 else None,
        admit_occupancy=(
            gspec.admit_occupancy if gspec.admit_occupancy >= 0 else None
        ),
        hedge_enabled=gspec.hedge,
    )
    await scheduler.start()
    tok_path = cfg.tokenizer_path or cfg.actor.path
    codec = (
        HFTokenizerCodec(tok_path) if tok_path
        else ByteFallbackCodec(cfg.actor.model_config().vocab_size)
    )
    gw = GatewayServer(
        scheduler, codec,
        GatewayConfig(
            model_id=cfg.experiment_name,
            default_tenant=gspec.default_tenant,
            api_keys=dict(gspec.api_keys),
            require_api_key=gspec.require_api_key,
            max_tokens_cap=cfg.gen.max_new_tokens_cap,
        ),
    )
    port = gspec.port or constants.gateway_port() or network.find_free_port()
    runner = await serve_gateway(gw, "127.0.0.1", port)
    name_resolve.add(
        names.gateway(cfg.experiment_name, cfg.trial_name),
        f"http://127.0.0.1:{port}",
        replace=True,
    )
    loop = asyncio.get_running_loop()
    bg_tasks: set = set()
    autoscaler_task = None
    if gspec.autoscale:
        # the manager's address before the first routed-set edit: the
        # reference looks it up at each edit and drops an edit made before
        # the manager has published it, so the manager would go on routing
        # to a server the gateway removed
        mgr_url = await loop.run_in_executor(None, functools.partial(
            name_resolve.wait,
            names.gserver_manager(cfg.experiment_name, cfg.trial_name),
            timeout=300))

        async def sync_manager(url: str, add: bool):
            from areal_tpu_torch.gen.client import GenAPIClient

            try:
                async with GenAPIClient(timeout=10.0) as c:
                    await c.post_json(
                        mgr_url,
                        "/add_server" if add else "/remove_server",
                        {"url": url}, op="autoscale",
                    )
            except Exception:
                logger.exception("manager routed-set sync failed")

        def mirror(urls, add: bool):
            for u in urls:
                t = loop.create_task(sync_manager(u, add=add))
                bg_tasks.add(t)
                t.add_done_callback(bg_tasks.discard)

        def fetch_signals():
            scalars = telemetry.collect_fleet_scalars(
                cfg.experiment_name, cfg.trial_name) or {}
            routed = scheduler.server_urls()
            # occupancy averages over the ROUTED set: idle unrouted
            # servers report ~0 and would dilute routed-pool saturation
            # below the grow threshold
            sig = ScaleSignals.from_fleet_scalars(
                scalars, routed=len(routed),
                n_gen_servers=max(len(routed), 1),
            )
            # the gateway's own queue is live, not telemetry-lagged
            sig.queue_depth = float(scheduler.queue_depth())
            return sig

        def grow(n: int) -> int:
            routed = scheduler.server_urls()
            spare = [u for u in all_urls if u not in routed][:n]
            if spare:
                scheduler.set_servers(routed + spare)
                mirror(spare, add=True)
            return len(spare)

        def shrink(n: int) -> int:
            routed = scheduler.server_urls()
            n = min(n, max(len(routed) - gspec.min_servers, 0))
            victims = routed[len(routed) - n:] if n else []
            if victims:
                scheduler.set_servers(
                    [u for u in routed if u not in victims])
                mirror(victims, add=False)
            return len(victims)

        autoscaler = Autoscaler(
            AutoscalerConfig(
                min_servers=gspec.min_servers,
                max_servers=cfg.gen.n_servers,
                interval_s=gspec.autoscale_interval_s,
                cooldown_s=gspec.autoscale_cooldown_s,
            ),
            fetch_signals, grow, shrink,
        )
        autoscaler_task = loop.create_task(autoscaler.run())

    brownout_task = None
    if gspec.brownout:
        from areal_tpu_torch.gateway.brownout import (
            BrownoutConfig,
            wire_brownout,
        )

        controller = wire_brownout(
            BrownoutConfig(
                interval_s=gspec.brownout_interval_s,
                min_hold_s=gspec.brownout_min_hold_s,
                clamp_max_tokens=gspec.brownout_clamp_max_tokens,
                weight_floor=gspec.brownout_weight_floor,
            ),
            scheduler, gw.config, scheduler._client,
        )
        brownout_task = loop.create_task(controller.run())

    watch = ExperimentStatusWatch(cfg.experiment_name, cfg.trial_name)
    hb = Heartbeat(cfg.experiment_name, cfg.trial_name, "gateway").start()
    tele = TelemetryExporter(
        cfg.experiment_name, cfg.trial_name, "gateway", "gateway",
        gauges_fn=lambda: {
            "gw_queue_depth": float(scheduler.queue_depth()),
            "gw_inflight": float(scheduler.inflight()),
            "gw_routed_servers": float(len(scheduler.server_urls())),
        },
    ).maybe_start()
    try:
        while watch.alive():
            await asyncio.sleep(1.0)
    finally:
        tele.stop()
        hb.stop()
        for t in (autoscaler_task, brownout_task):
            if t is not None:
                t.cancel()
        await asyncio.gather(
            *[t for t in (autoscaler_task, brownout_task) if t is not None],
            *bg_tasks, return_exceptions=True)
        await scheduler.stop()
        await runner.cleanup()


def rollout_worker_main(cfg, worker_idx: int):
    _setup_worker_env(cfg, "cpu")
    with _worker_observability(f"rollout_worker/{worker_idx}"):
        _rollout_worker(cfg, worker_idx)


def _rollout_worker(cfg, worker_idx: int):
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
        TelemetryExporter,
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
    tele = TelemetryExporter(
        cfg.experiment_name, cfg.trial_name,
        f"rollout_worker/{worker_idx}", "rollout",
        step_fn=lambda: worker.push_cnt,
        gauges_fn=lambda: {
            "rollout_tasks_running": float(worker.n_tasks()),
            "rollout_requeued": float(worker.requeued_cnt),
            "rollout_dropped": float(worker.dropped_cnt),
        },
    ).maybe_start()
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
        tele.stop()


def _load_ppo_engines(cfg, total_steps):
    """actor / optional ref / optional critic / optional reward model from
    an experiment config: ONE place for the gating rules. The reward model
    is a critic-architecture engine without an optimizer; only the async
    trainer takes it (``run_sync_ppo`` drops it, as the reference does)."""
    dev = cfg.trainer_device
    actor = _load_engine(cfg.actor, total_steps=total_steps, device=dev)
    ref = None
    if cfg.use_ref_model and (cfg.ppo.kl_ctl != 0 or cfg.ema_ref_eta is not None):
        ref = _load_engine(cfg.actor, with_optimizer=False, device=dev)
    critic = None
    if cfg.critic is not None and not cfg.ppo.disable_value:
        critic = _load_engine(cfg.critic, is_critic=True,
                              total_steps=total_steps, device=dev)
    reward = None
    if getattr(cfg, "reward", None) is not None:
        reward = _load_engine(cfg.reward, is_critic=True,
                              with_optimizer=False, device=dev)
    return actor, ref, critic, reward


def trainer_main(cfg):
    _setup_worker_env(cfg, cfg.trainer_device)
    with _worker_observability("trainer"):
        _trainer(cfg)


def _trainer(cfg):
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
    actor, ref, critic, reward = _load_ppo_engines(cfg, total)
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
        reward_engine=reward,
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
    tele = worker_base.TelemetryExporter(
        cfg.experiment_name, cfg.trial_name, "trainer", "trainer",
        step_fn=lambda: worker.step,
        gauges_fn=worker.telemetry_gauges,
    ).maybe_start()
    try:
        worker.run(shutdown=shutdown)
    finally:
        tele.stop()
        stream.close()
        if worker.metrics is not None:
            worker.metrics.close()
    if worker.preempted:
        sys.exit(worker_base.EXIT_PREEMPTED)


# the worker role mains by role name (the reference's ``ROLE_MAINS``, less
# the evaluator, which is not ported)
ROLE_MAINS = {
    "gen_server": gen_server_main,
    "gserver_manager": gserver_manager_main,
    "gateway": gateway_main,
    "rollout_worker": rollout_worker_main,
    "trainer": trainer_main,
}


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
    if cfg.gateway.enabled:
        start(
            "gateway",
            ctx.Process(target=gateway_main, args=(cfg,), daemon=True),
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
    actor, ref, critic, _ = _load_ppo_engines(cfg, total)
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
