"""The trainer workers (the counterpart of
``areal_tpu/system/trainer_worker.py``): ``AsyncPPOTrainerWorker``
consumes the rollout stream and runs one traversal of the declared MFC
graph per step; ``SFTTrainerWorker`` is the synchronous supervised loop
(SFT, or the paired reward model's Bradley-Terry objective).

    rollout stream -> staleness-ordered buffer -> [ref_inf, critic_inf,
    actor_inf] -> [actor_train, critic_train] -> training_samples ->
    HF export -> model_version

What is kept from the reference: epoch / step accounting and the
save / checkpoint cadence (``EpochStepTimeFreqCtl``); the weight-sync
channel (a committed HF export written in a background thread, then a
``name_resolve`` version bump); the ``training_samples`` counter that
feeds the manager's staleness gate, bumped by groups; loud intake
validation; the guardrail plane (``guard/step_ok`` accounting at stats
flush time, and a rollback to the last committed recover checkpoint
after ``guard_rollback_steps`` anomalous steps in a row); graceful
preemption and the hang watchdog; committed recover checkpoints with
``RecoverInfo``.

The port runs one process on one card, so the reference's multihost
collectives are local identities here (every host decision is this
process's). The elastic world path, the fleet telemetry merge and the
process-global counters wait for their twins (``ROADMAP.md``). The port's
``PPOActorInterface.train_step`` pulls its stats to the host once per
call, so ``flush_stats`` keeps the reference's logging cadence
(``stats_log_freq_steps`` under ``AREAL_TRAIN_PREFETCH``) and its guard
accounting without a second device pull.
"""

import dataclasses
import logging
import os
import time
from typing import Dict, List, Optional

import numpy as np

from areal_tpu_torch.api.data import MicroBatchSpec, SequenceSample
from areal_tpu_torch.api.model import PPOHyperparameters, make_interface
from areal_tpu_torch.base import constants, hbm, name_resolve, names, recover
from areal_tpu_torch.base import flops as flops_mod
from areal_tpu_torch.base.metrics import MetricLogger
from areal_tpu_torch.base.timeutil import EpochStepTimeFreqCtl
from areal_tpu_torch.experiments import graphs
from areal_tpu_torch.ops import cuda as cuda_ops
from areal_tpu_torch.system import worker_base
from areal_tpu_torch.system.buffer import SequenceBuffer, record_batch_consumption
from areal_tpu_torch.system.function_executor import FunctionExecutor
from areal_tpu_torch.train.engine import TrainEngine

logger = logging.getLogger("areal_tpu_torch.trainer_worker")


@dataclasses.dataclass
class TrainerControl:
    """Save / checkpoint / weight-sync cadence."""

    total_train_steps: int = 100
    save_freq_steps: Optional[int] = None        # HF export for the user
    ckpt_freq_steps: Optional[int] = 50          # recover checkpoint
    ckpt_freq_secs: Optional[float] = 600.0
    weight_sync_freq_steps: int = 1              # fleet weight push cadence
    # stats are logged once per this many steps (the reference's deferred
    # device pull); every step when AREAL_TRAIN_PREFETCH is off
    stats_log_freq_steps: int = 8
    # after this many CONSECUTIVE anomalous steps (each one's update was
    # already skipped by the engine's guard), roll back to the last
    # committed recover checkpoint. 0 disables.
    guard_rollback_steps: int = 3
    # hang watchdog threshold for the train loop (None/0 = disabled)
    watchdog_timeout_secs: Optional[float] = None


class AsyncPPOTrainerWorker:
    """Consumes the rollout stream, runs the PPO MFC graph per step."""

    def __init__(
        self,
        experiment_name: str,
        trial_name: str,
        actor_engine: TrainEngine,
        stream,                              # PullerStreamDataset-like
        hp: PPOHyperparameters,
        control: TrainerControl,
        train_batch_size: int = 32,          # groups per step
        mb_spec: Optional[MicroBatchSpec] = None,
        ref_engine: Optional[TrainEngine] = None,
        critic_engine: Optional[TrainEngine] = None,
        reward_engine: Optional[TrainEngine] = None,
        hf_family: str = "qwen2",
        metric_logger: Optional[MetricLogger] = None,
        ema_ref_eta: Optional[float] = None,
        graph=None,
        interfaces=None,
        max_head_offpolicyness: Optional[int] = None,
        buffer_capacity: int = 16384,
    ):
        self.experiment_name = experiment_name
        self.trial_name = trial_name
        self.actor_engine = actor_engine
        self.ref_engine = ref_engine
        self.critic_engine = critic_engine
        self.stream = stream
        self.hp = hp
        self.control = control
        self.train_batch_size = train_batch_size
        self.mb_spec = mb_spec or MicroBatchSpec(max_tokens_per_mb=16384)
        self.hf_family = hf_family
        self.metrics = metric_logger
        # per-step device-memory gauges + warn/kill thresholds
        self._hbm = hbm.HBMMonitor(device=actor_engine.device, tag="trainer")

        if graph is None:
            graph, interfaces = graphs.build_ppo_graph(
                hp,
                use_ref=ref_engine is not None,
                use_critic=critic_engine is not None,
                ema_ref_eta=ema_ref_eta,
                mb_spec=self.mb_spec,
                hf_family=hf_family,
                use_reward_model=reward_engine is not None,
            )
        engines = {"actor": actor_engine}
        if ref_engine is not None:
            engines["ref"] = ref_engine
        if critic_engine is not None:
            engines["critic"] = critic_engine
        self.executor = FunctionExecutor(
            graph, engines, interfaces, default_mb_spec=self.mb_spec
        )
        self.actor_if = self.executor.interfaces.get("actor_train")
        self.step = 0
        self.samples_consumed = 0
        # keys the graph needs from the rollout stream (everything else the
        # MFCs produce themselves): loud intake validation
        self._required_keys = {
            k
            for m in self.executor.graph.mfcs
            for k in m.input_keys
            if k not in self.executor.graph.producers
        }
        # staleness-ordered intake; over-stale samples never reach the
        # optimizer
        self._buffer = SequenceBuffer(
            capacity=buffer_capacity, max_version_lag=max_head_offpolicyness
        )
        self._ckpt_ctl = EpochStepTimeFreqCtl(
            freq_step=control.ckpt_freq_steps, freq_sec=control.ckpt_freq_secs
        )
        # (step, wall time, stats) triples awaiting the next flush
        self._pending_stats: List = []
        self._last_batch_groups = 0
        self._consec_anomalies = 0
        self._publish_thread = None
        self.preempted = False
        self._watchdog = None  # set by run() while its loop is live

    def _bump_watchdog(self):
        if self._watchdog is not None:
            self._watchdog.bump()

    # ------------------------------------------------------------------ #
    # weight sync + counters
    # ------------------------------------------------------------------ #

    def publish_weights(self) -> str:
        """Export the actor's weights as ``v<version>`` under the
        weight-sync root and announce ``<version>:<path>`` once the export
        is committed. The params are copied to the host before this
        returns; the file write and the announce run in a background
        thread, joined (and its failure raised) before the next publish."""
        version = self.actor_engine.version
        path = os.path.join(constants.get_param_sync_root(), f"v{version}")
        # join (and surface any failure of) the previous publish first, so
        # versions announce in order and a full disk stops the world
        self._join_publish()

        def announce():
            name_resolve.add(
                names.model_version(
                    self.experiment_name, self.trial_name, "actor"
                ),
                f"{version}:{path}",
                replace=True,
            )
            logger.info("published weights v%d -> %s", version, path)

        self._publish_thread = self.actor_engine.save_hf(
            path, self.hf_family, async_write=True, post_write=announce
        )
        return path

    def _join_publish(self):
        t = self._publish_thread
        if t is not None:
            t.join()
            self._publish_thread = None
            if t._areal_exc is not None:
                # a failed export means the fleet would keep serving a
                # version the trainer believes it published
                raise RuntimeError(
                    "background weight publish failed"
                ) from t._areal_exc

    def _bump_training_samples(self, n: int):
        """``n`` groups consumed: the staleness gate's unit (the manager
        counts running rollouts per task, i.e. per prompt group)."""
        self.samples_consumed += int(n)
        name_resolve.add(
            names.training_samples(self.experiment_name, self.trial_name),
            str(self.samples_consumed),
            replace=True,
        )

    # ------------------------------------------------------------------ #
    # data intake
    # ------------------------------------------------------------------ #

    def _intake(self, samples: List[SequenceSample]):
        """Validate and buffer arrivals. A trajectory missing a key the
        graph needs is dropped with an ERROR: intersecting keys across the
        batch would strip (e.g.) ref logprobs from everyone without a
        trace."""
        version = self.actor_engine.version
        for s in samples:
            missing = self._required_keys - set(s.keys)
            if missing:
                logger.error(
                    "malformed rollout %s: missing required keys %s "
                    "(has %s); dropped",
                    s.ids, sorted(missing), sorted(s.keys),
                )
                continue
            self._buffer.put(s, current_version=version)

    def _collect_batch(self, timeout: float = 600.0) -> Optional[SequenceSample]:
        """``train_batch_size`` groups from the buffer, oldest version
        first, refilled from the stream; None when the stream stays empty
        past ``timeout``."""
        t0 = time.time()
        while True:
            while len(self._buffer) < self.train_batch_size:
                self._intake(
                    self.stream.get_batch(
                        self.train_batch_size - len(self._buffer), timeout=0.2
                    )
                )
                if time.time() - t0 > timeout:
                    break
            if not len(self._buffer):
                return None
            batch = self._buffer.pop_batch(
                self.train_batch_size, current_version=self.actor_engine.version
            )
            if batch:
                self._last_batch_groups = len(batch)
                break
            # everything queued was over-stale: refill
            if time.time() - t0 > timeout:
                return None
        record_batch_consumption(batch, self.actor_engine.version)
        # only the keys the train MFCs consume: agent extras stay out of
        # the device batch
        return SequenceSample.gather(batch, keys=self._required_keys)

    # ------------------------------------------------------------------ #
    # one training step = one MFC-graph traversal
    # ------------------------------------------------------------------ #

    def train_step(self, sample: SequenceSample) -> Dict[str, float]:
        return self.executor.run(sample)

    def run_step(self) -> Optional[Dict[str, float]]:
        sample = self._collect_batch()
        if sample is None:
            return None
        launches0 = cuda_ops.launch_counts()
        t0 = time.perf_counter()
        stats = self.train_step(sample)
        stats["timeperf/e2e"] = time.perf_counter() - t0
        if "flops" in stats:  # per-step throughput line
            stats["tflops_per_sec"] = (
                stats.pop("flops") / max(stats["timeperf/e2e"], 1e-9) / 1e12
            )
        main = sample.main_key()
        stats["n_tokens"] = sum(sum(inner) for inner in sample.seqlens[main])
        stats["n_seqs_consumed"] = sum(
            len(inner) for inner in sample.seqlens[main]
        )
        stats.update(self._hbm.check())
        # this step's kernel launches, by wrapper (the reference logs its
        # pipeline counters' deltas here)
        stats.update({
            f"kernel/{k}_launches": v - launches0[k]
            for k, v in cuda_ops.launch_counts().items()
        })
        self._bump_training_samples(self._last_batch_groups)
        self.step += 1

        if self.step % self.control.weight_sync_freq_steps == 0:
            self.publish_weights()
        if (
            self.control.save_freq_steps
            and self.step % self.control.save_freq_steps == 0
        ):
            save_dir = os.path.join(constants.get_save_root(), f"step{self.step}")
            if self.actor_if is not None:
                self.actor_if.save(self.actor_engine, save_dir)
            else:  # custom graph without an "actor_train" node
                self.actor_engine.save_hf(save_dir, self.hf_family)
            self._bump_watchdog()  # a slow HF export is not a hang
        if self._ckpt_ctl.check(steps=1):
            self.save_recover_checkpoint()
            self._bump_watchdog()  # a slow committed save is not a hang
        self._pending_stats.append((self.step, time.time(), stats))
        flush_every = (
            max(self.control.stats_log_freq_steps, 1)
            if constants.train_prefetch_enabled()
            else 1
        )
        if len(self._pending_stats) >= flush_every:
            self.flush_stats()
        return stats

    def flush_stats(self):
        """Log every pending step with its own wall time, and run the
        guardrail accounting: ``guard/step_ok`` < 1 means at least one
        minibatch's update was skipped; ``guard_rollback_steps`` such steps
        in a row roll the engines back to the last committed checkpoint."""
        if not self._pending_stats:
            return
        pending, self._pending_stats = self._pending_stats, []
        for step, wall, stats in pending:
            ok = float(stats.get("guard/step_ok", 1.0))
            if ok < 1.0:
                self._consec_anomalies += 1
                logger.warning(
                    "step %d: non-finite loss/grad_norm (step_ok=%.2f); "
                    "optimizer update was skipped "
                    "(%d consecutive anomalous steps)",
                    step, ok, self._consec_anomalies,
                )
            else:
                self._consec_anomalies = 0
            if self.metrics is not None:
                self.metrics.log(
                    {k: float(v) for k, v in stats.items() if np.isscalar(v)},
                    step, prefix="ppo", wall_time=wall,
                )
        k = self.control.guard_rollback_steps
        if k and self._consec_anomalies >= k:
            self._rollback_to_committed()

    def telemetry_gauges(self) -> Dict[str, float]:
        """Instantaneous trainer gauges: intake queue depths plus the
        device-memory gauges (a read never kills the worker)."""
        g: Dict[str, float] = {
            "buffer_depth": float(len(self._buffer)),
            "buffer_dropped_stale": float(self._buffer.n_dropped_stale),
            "buffer_dropped_capacity": float(self._buffer.n_dropped_capacity),
            "samples_consumed": float(self.samples_consumed),
        }
        if hasattr(self.stream, "qsize"):
            try:
                g["stream_qsize"] = float(self.stream.qsize())
            except Exception:
                pass
        try:
            g.update({k: float(v) for k, v in self._hbm.check(kill=False).items()})
        except Exception:
            pass
        return g

    def _rollback_to_committed(self) -> bool:
        """K consecutive anomalous steps: restore the engines from the
        last COMMITTED recover checkpoint and republish the restored
        weights under a NEW version (the manager ignores a version <= its
        own)."""
        root = os.path.join(constants.get_recover_root(), "trainer")
        actor_path = os.path.join(root, "actor")
        critic_path = os.path.join(root, "critic")
        # validate every engine's checkpoint before touching any
        try:
            self.actor_engine.validate_checkpoint(actor_path)
            if self.critic_engine is not None:
                self.critic_engine.validate_checkpoint(critic_path)
        except (FileNotFoundError, ValueError) as e:
            logger.error(
                "anomaly rollback wanted but not every engine has a "
                "restorable committed recover checkpoint (%s); continuing "
                "with current params", e,
            )
            self._consec_anomalies = 0
            return False
        live_version = self.actor_engine.version
        self.actor_engine.load_checkpoint(actor_path)
        if self.critic_engine is not None:
            self.critic_engine.load_checkpoint(critic_path)
        restored_version = self.actor_engine.version
        self.actor_engine.version = max(live_version, restored_version) + 1
        self._consec_anomalies = 0
        logger.warning(
            "rolled back to committed checkpoint (engine step %d, restored "
            "v%d, republishing as v%d; live v%d) after %d consecutive "
            "anomalous steps",
            self.actor_engine._step, restored_version,
            self.actor_engine.version, live_version,
            self.control.guard_rollback_steps,
        )
        # trajectories buffered or in flight came from the suspect policy
        stale = self._buffer.clear()
        if hasattr(self.stream, "clear"):
            stale += self.stream.clear()
        if stale:
            logger.warning(
                "dropped %d suspect buffered/in-flight trajectories on "
                "rollback", stale,
            )
        self.publish_weights()
        return True

    def run(self, shutdown=None, elastic=None, engine_factory=None):
        """Main loop. ``shutdown`` (a :class:`worker_base.GracefulShutdown`)
        makes SIGTERM / SIGINT end the loop through
        :meth:`_handle_preemption`: commit a recover checkpoint, republish
        ``model_version``, set ``self.preempted`` so the caller exits with
        the preemption code."""
        if elastic is not None or engine_factory is not None:
            raise NotImplementedError(
                "the elastic trainer world is not ported yet (ROADMAP.md)")
        watchdog = None
        if self.control.watchdog_timeout_secs:
            watchdog = worker_base.HangWatchdog(
                "trainer", timeout_s=self.control.watchdog_timeout_secs
            ).start()
        self._watchdog = watchdog
        try:
            while self.step < self.control.total_train_steps:
                if shutdown is not None and shutdown.should_stop():
                    # the preemption save is a legitimate long stall
                    if watchdog is not None:
                        watchdog.stop()
                    self._handle_preemption(shutdown)
                    break
                if watchdog is not None:
                    watchdog.bump()
                if self.run_step() is None:
                    logger.warning("no data from rollout stream; stopping")
                    break
        finally:
            if watchdog is not None:
                watchdog.stop()
            self._watchdog = None
            # trailing stats land before exit; a failure here must not mask
            # the original exception. Then the final version lands, and a
            # crashed step does not leave the writer to die mid-file.
            try:
                self.flush_stats()
            except Exception:
                logger.exception("stats flush failed at exit")
            finally:
                self._join_publish()
        return self.step

    def _handle_preemption(self, shutdown):
        """Inside the deadline: commit a recover checkpoint and republish
        ``model_version`` so the restarted world converges on the
        committed state."""
        self.preempted = True
        shutdown.request()
        t0 = time.monotonic()
        logger.warning(
            "preemption: saving recover checkpoint at step %d "
            "(%.0fs deadline)", self.step, shutdown.remaining(),
        )
        try:
            self.flush_stats()
        except Exception:
            logger.exception("stats flush failed during preemption")
        self.save_recover_checkpoint()
        self.publish_weights()
        self._join_publish()
        took = time.monotonic() - t0
        if shutdown.remaining() <= 0:
            logger.error(
                "preemption save took %.1fs and overran the %.0fs deadline; "
                "the checkpoint is committed, but raise %s if the scheduler "
                "hard-killed us first",
                took, shutdown.deadline_s, constants.PREEMPT_DEADLINE_ENV,
            )
        else:
            logger.info(
                "preemption save committed in %.1fs (%.0fs to spare)",
                took, shutdown.remaining(),
            )

    # ------------------------------------------------------------------ #
    # recovery
    # ------------------------------------------------------------------ #

    def save_recover_checkpoint(self):
        root = os.path.join(constants.get_recover_root(), "trainer")
        self.actor_engine.save_checkpoint(os.path.join(root, "actor"))
        if self.critic_engine is not None:
            self.critic_engine.save_checkpoint(os.path.join(root, "critic"))
        step_info = recover.StepInfo(
            epoch=0, epoch_step=self.step, global_step=self.step
        )
        recover.dump(recover.RecoverInfo(
            recover_start=step_info,
            last_step_info=step_info,
            ckpt_ctl_states={"trainer": self._ckpt_ctl.state_dict()},
            samples_consumed=self.samples_consumed,
            model_version=self.actor_engine.version,
        ))

    def load_recover_checkpoint(self, publish: bool = True) -> bool:
        """Restart-the-world resume: restore engine state and step
        counters, republish ``model_version`` and ``training_samples`` so
        the manager and the fleet converge on the RESTORED version, and
        drop in-flight trajectories (generated against pre-crash weights).
        Returns False (a fresh start) when no committed checkpoint can be
        restored."""
        root = os.path.join(constants.get_recover_root(), "trainer")
        info = recover.load()
        if info is None:
            return False
        actor_path = os.path.join(root, "actor")
        critic_path = os.path.join(root, "critic")
        load_critic = self.critic_engine is not None and os.path.exists(
            critic_path
        )
        try:
            # validate EVERY engine before restoring ANY: a raise after the
            # actor's restore would pair it with a live critic
            self.actor_engine.validate_checkpoint(actor_path)
            if load_critic:
                self.critic_engine.validate_checkpoint(critic_path)
            self.actor_engine.load_checkpoint(actor_path)
            if load_critic:
                self.critic_engine.load_checkpoint(critic_path)
        except (FileNotFoundError, ValueError) as e:
            logger.error(
                "recover checkpoint not restorable (%s); starting fresh", e
            )
            return False
        self.step = info.recover_start.global_step
        self.samples_consumed = info.samples_consumed
        # the ENGINE checkpoint's version is authoritative; RecoverInfo's
        # copy is for cross-checking only and a stale one must never win
        if info.model_version != self.actor_engine.version:
            logger.warning(
                "RecoverInfo model_version %d != engine checkpoint version "
                "%d; republishing the engine's",
                info.model_version, self.actor_engine.version,
            )
        ctl_state = info.ckpt_ctl_states.get("trainer")
        if ctl_state:
            self._ckpt_ctl.load_state_dict(ctl_state)
        stale = self.stream.clear() if hasattr(self.stream, "clear") else 0
        if stale:
            logger.warning(
                "dropped %d stale in-flight trajectories on recover", stale
            )
        name_resolve.add(
            names.training_samples(self.experiment_name, self.trial_name),
            str(self.samples_consumed),
            replace=True,
        )
        if publish:
            self.publish_weights()
            self._join_publish()
        logger.info(
            "recovered trainer at step %d (v%d, %d samples consumed)",
            self.step, self.actor_engine.version, self.samples_consumed,
        )
        return True


class SFTTrainerWorker:
    """Sync supervised loop (the reference's ``main_sft.py`` path; BASELINE
    config #1). ``interface_name`` selects the training objective: "sft"
    (next-token) or "reward" (Bradley-Terry paired RM, the reference's rw
    experiment)."""

    def __init__(
        self,
        experiment_name: str,
        trial_name: str,
        engine: TrainEngine,
        dataset,
        control: TrainerControl,
        batch_size: int = 32,
        mb_spec: Optional[MicroBatchSpec] = None,
        eval_dataset=None,
        hf_family: str = "qwen2",
        metric_logger: Optional[MetricLogger] = None,
        shuffle_seed: int = 1,
        interface_name: str = "sft",
        interface_kwargs: Optional[Dict] = None,
    ):
        self.experiment_name = experiment_name
        self.trial_name = trial_name
        self.engine = engine
        self.dataset = dataset
        self.eval_dataset = eval_dataset
        self.control = control
        self.batch_size = batch_size
        self.mb_spec = mb_spec or MicroBatchSpec(max_tokens_per_mb=16384)
        self.hf_family = hf_family
        self.metrics = metric_logger
        self.interface = make_interface(interface_name, **(interface_kwargs or {}))
        self._log_prefix = interface_name
        self._hbm = hbm.HBMMonitor(device=engine.device, tag=interface_name)
        self.step = 0
        self.epoch = 0
        self._shuffle_seed = shuffle_seed

    def _batches(self, dataset, order):
        """Batch-sized gathered chunks of ``dataset`` in the given index
        order (each chunk is packed into micro-batches by the engine)."""
        for lo in range(0, len(order), self.batch_size):
            items = [dataset[i] for i in order[lo : lo + self.batch_size]]
            if items:
                yield SequenceSample.gather(items)

    def _epoch_batches(self):
        idx = np.random.RandomState(self._shuffle_seed + self.epoch).permutation(
            len(self.dataset)
        )
        yield from self._batches(self.dataset, list(idx))

    def _eval_batches(self):
        yield from self._batches(self.eval_dataset, range(len(self.eval_dataset)))

    def run(self):
        if len(self.dataset) == 0:
            logger.warning("empty SFT dataset; nothing to train")
            return 0
        while self.step < self.control.total_train_steps:
            for batch in self._epoch_batches():
                t0 = time.perf_counter()
                stats = self.interface.train_step(self.engine, batch, self.mb_spec)
                dt = time.perf_counter() - t0
                lens = [
                    int(n)
                    for inner in batch.seqlens[batch.main_key()]
                    for n in inner
                ]
                stats["tflops_per_sec"] = (
                    flops_mod.train_flops(self.engine.cfg, sum(lens), lens)
                    / max(dt, 1e-9) / 1e12
                )
                stats.update(self._hbm.check())
                self.step += 1
                if self.metrics is not None:
                    self.metrics.log(stats, self.step, prefix=self._log_prefix)
                if (
                    self.control.save_freq_steps
                    and self.step % self.control.save_freq_steps == 0
                ):
                    self.engine.save_hf(
                        os.path.join(constants.get_save_root(), f"step{self.step}"),
                        self.hf_family,
                    )
                if self.step >= self.control.total_train_steps:
                    break
            self.epoch += 1
            if self.eval_dataset is not None:
                ev = self.interface.evaluate(self.engine, list(self._eval_batches()))
                logger.info("epoch %d eval: %s", self.epoch, ev)
                if self.metrics is not None:
                    self.metrics.log(ev, self.step, prefix=f"{self._log_prefix}_eval")
        return self.step
