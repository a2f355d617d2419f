"""Rollout worker: async trajectory collection (the counterpart of
``areal_tpu/system/rollout_worker.py``). It loads prompts, gates each
rollout through the gserver manager (capacity + staleness), runs
``agent.collect_trajectory`` tasks against the chunked-generation client,
pushes accepted trajectories as JSON to the trainer-side puller and
reports completion.

Manager calls go over ``base/http.py`` (asyncio connections) where the
reference holds an aiohttp session, so the methods take no session. The
reference's tracing spans, its ``rollout.push`` fault-injection point and
its process-global counters are not ported; the worker's own counts
(``push_cnt``, ``accepted_cnt``, ``requeued_cnt``, ``dropped_cnt``,
``denied_cnt``) stay.
"""

import asyncio
import logging
import re
import time
from collections import deque
from typing import Deque, Dict, Optional

from areal_tpu_torch.api.agent import Agent
from areal_tpu_torch.api.data import SequenceSample
from areal_tpu_torch.api.env import EnvironmentService
from areal_tpu_torch.base import http, name_resolve, names
from areal_tpu_torch.system.partial_rollout import PartialRolloutManager
from areal_tpu_torch.system.push_pull_stream import NameResolvingJsonPusher

logger = logging.getLogger("areal_tpu_torch.rollout_worker")

MANAGER_TIMEOUT_S = 300.0


class RolloutWorker:
    def __init__(
        self,
        experiment_name: str,
        trial_name: str,
        worker_index: int,
        n_workers: int,
        n_pullers: int,
        agent: Agent,
        env: EnvironmentService,
        dataset,
        new_tokens_per_chunk: int = 256,
        max_concurrent_tasks: int = 16,
        pusher: Optional[object] = None,
        manager_url: Optional[str] = None,
        max_rollout_attempts: int = 3,
    ):
        self.experiment_name = experiment_name
        self.trial_name = trial_name
        self.worker_index = worker_index
        self.agent = agent
        self.env = env
        self.dataset = dataset
        self.max_concurrent_tasks = max_concurrent_tasks
        self.pusher = pusher or NameResolvingJsonPusher(
            experiment_name, trial_name, worker_index, n_workers, n_pullers
        )
        self.manager_url = manager_url or name_resolve.wait(
            names.gserver_manager(experiment_name, trial_name), timeout=300
        )
        self.obs_queue: asyncio.Queue = asyncio.Queue()
        self._act_queues: Dict[str, asyncio.Queue] = {}
        self.prm = PartialRolloutManager(
            request_queue=self.obs_queue,
            reply_queue=asyncio.Queue(),
            gserver_manager_url=self.manager_url,
            new_tokens_per_chunk=new_tokens_per_chunk,
        )
        self._tasks: Dict[str, asyncio.Task] = {}
        self._data_iter_idx = 0
        self._epoch = 0
        self.push_cnt = 0
        self.accepted_cnt = 0
        self.denied_cnt = 0
        self._used_qids: set = set()  # skip ids already consumed this epoch
        # requeue plane: a failed rollout goes back into this queue for up
        # to max_rollout_attempts tries (the manager released its sticky
        # mapping at finish_rollout, so the retry may route elsewhere)
        self.max_rollout_attempts = max_rollout_attempts
        self._requeue: Deque[SequenceSample] = deque()
        self._attempts: Dict[str, int] = {}
        self.requeued_cnt = 0
        self.dropped_cnt = 0

    # ------------------------------------------------------------------ #

    def load_next_data(self) -> Optional[SequenceSample]:
        """Round-robin over the dataset; the epoch wraps."""
        if len(self.dataset) == 0:
            return None
        for _ in range(len(self.dataset)):
            if self._data_iter_idx >= len(self.dataset):
                self._data_iter_idx = 0
                self._epoch += 1
                self._used_qids.clear()  # entries are per-epoch
            sample = self.dataset[self._data_iter_idx]
            self._data_iter_idx += 1
            qid = sample.ids[0]
            if f"{qid}@{self._epoch}" not in self._used_qids:
                return sample
        return None

    async def allocate_new_rollout(self, qid) -> bool:
        d = await http.request_json(
            "POST", f"{self.manager_url}/allocate_rollout", {"qid": str(qid)},
            timeout=MANAGER_TIMEOUT_S)
        return bool(d["success"])

    async def finish_rollout(self, qid, accepted: bool):
        await http.request_json(
            "POST", f"{self.manager_url}/finish_rollout",
            {"qid": str(qid), "accepted": accepted},
            timeout=MANAGER_TIMEOUT_S)

    async def _rollout_task(self, prompt: SequenceSample):
        qid = str(prompt.ids[0])
        try:
            try:
                trajs = await self.agent.collect_trajectory(
                    prompt, self.env, self.obs_queue, self._route_queue(qid)
                )
            except asyncio.CancelledError:
                raise
            except Exception as e:
                self._handle_rollout_failure(qid, prompt, e)
                trajs, accepted, round_failed = [], False, True
            else:
                accepted = len(trajs) > 0
                round_failed = False
            n_pushed = 0
            try:
                for t in trajs:
                    # lifecycle stamp: entering the rollout -> trainer stream
                    t.metadata["enqueue_time"] = [time.time()] * len(t.ids)
                    if self.pusher.push(t.as_json_compatible()):
                        n_pushed += 1
                        self.push_cnt += 1
                if accepted:
                    self.accepted_cnt += 1
            except asyncio.CancelledError:
                raise
            except Exception as e:
                # a push-path crash must not skip finish_rollout below (the
                # manager's slot would leak). Requeue only when nothing was
                # delivered: after a partial push a retry would duplicate
                if n_pushed == 0:
                    self._handle_rollout_failure(qid, prompt, e)
                    accepted = False
                    round_failed = True
                else:
                    logger.warning(
                        "rollout %s push path failed after %d trajectories "
                        "were delivered; not requeueing", qid, n_pushed,
                        exc_info=True,
                    )
                    if accepted:
                        self.accepted_cnt += 1
            if not round_failed:
                # the retry counter resets only after the whole round
                # (collect + deliver) succeeded
                self._attempts.pop(qid, None)
            try:
                # release the manager's slot in every outcome; a requeued
                # sample re-allocates and re-enters the staleness gate
                await self.finish_rollout(qid, accepted)
            except Exception:
                # never requeue on a finish failure: the trajectories may
                # already be pushed and a retry would duplicate them
                logger.warning("finish_rollout(%s) failed", qid, exc_info=True)
        finally:
            self._tasks.pop(qid, None)
            self._act_queues.pop(qid, None)

    def _handle_rollout_failure(self, qid: str, prompt: SequenceSample, e):
        """Requeue a failed sample (bounded attempts) instead of finishing
        it as rejected."""
        attempts = self._attempts.get(qid, 0) + 1
        self._attempts[qid] = attempts
        if attempts < self.max_rollout_attempts:
            self.requeued_cnt += 1
            logger.warning("rollout %s failed (attempt %d/%d): %r — requeued",
                           qid, attempts, self.max_rollout_attempts, e)
            self._requeue.append(prompt)
        else:
            self.dropped_cnt += 1
            logger.error("rollout %s failed %d times (%r); dropping sample",
                         qid, attempts, e)
            self._attempts.pop(qid, None)

    def _route_queue(self, qid: str) -> asyncio.Queue:
        q = self._act_queues.get(qid)
        if q is None:
            q = asyncio.Queue()
            self._act_queues[qid] = q
        return q

    async def _dispatch_replies(self):
        """Route bundles from the partial-rollout manager back to the agent
        that asked (multi-turn agents suffix their qids with "-tK")."""
        while True:
            bundle = await self.prm.reply_queue.get()
            qid = str(bundle.qid)
            q = self._act_queues.get(qid)
            if q is None:
                q = self._act_queues.get(re.sub(r"-t\d+$", "", qid))
            if q is None:
                logger.warning("no consumer for bundle %s", bundle.qid)
                continue
            await q.put(bundle)

    async def run_async(self, max_steps: Optional[int] = None, should_stop=None):
        """Main poll loop; ``should_stop`` is polled each iteration."""
        dispatch = asyncio.get_running_loop().create_task(
            self._dispatch_replies())
        steps = 0
        carry: Optional[SequenceSample] = None  # denied sample, retried first
        try:
            while max_steps is None or steps < max_steps:
                if should_stop is not None and should_stop():
                    break
                steps += 1
                if len(self._tasks) < self.max_concurrent_tasks:
                    # requeued (failed) samples retry before new data
                    from_requeue = False
                    if carry is not None:
                        prompt = carry
                    elif self._requeue:
                        prompt = self._requeue.popleft()
                        from_requeue = True
                    else:
                        prompt = self.load_next_data()
                    carry = None
                    if prompt is not None:
                        qid = str(prompt.ids[0])
                        if qid in self._tasks:
                            if from_requeue:
                                # the failed task is still unwinding; retry
                                # the requeue next tick
                                self._requeue.append(prompt)
                        elif await self.allocate_new_rollout(qid):
                            # the manager slot is held from here on: hand it
                            # to the task (whose every exit reaches
                            # finish_rollout) before any other bookkeeping
                            self._tasks[qid] = asyncio.get_running_loop(
                            ).create_task(self._rollout_task(prompt))
                            self._used_qids.add(f"{qid}@{self._epoch}")
                            self._route_queue(qid)
                        else:
                            # gate closed (capacity/staleness): keep this
                            # sample and back off
                            self.denied_cnt += 1
                            carry = prompt
                            await asyncio.sleep(0.05)
                await self.prm.run_step()
        finally:
            dispatch.cancel()

    def n_tasks(self) -> int:
        return len(self._tasks)

    async def _pump(self):
        while True:
            await self.prm.run_step()

    async def drain(self, timeout: float = 300.0):
        """Wait for all in-flight rollout tasks; tasks that miss the
        deadline are cancelled (and awaited) and their manager slots
        released. The reply dispatcher and the partial-rollout pump run
        while it waits, so it also drains after ``run_async`` returned."""
        if not self._tasks:
            return
        items = list(self._tasks.items())  # _tasks mutates as tasks finish
        loop = asyncio.get_running_loop()
        helpers = [loop.create_task(self._dispatch_replies()),
                   loop.create_task(self._pump())]
        try:
            _, pending = await asyncio.wait([t for _, t in items],
                                            timeout=timeout)
        finally:
            for t in helpers:
                t.cancel()
            await asyncio.gather(*helpers, return_exceptions=True)
        if not pending:
            return
        abandoned = sorted(qid for qid, t in items if t in pending)
        for t in pending:
            t.cancel()
        await asyncio.gather(*pending, return_exceptions=True)
        logger.warning("drain timed out after %.0fs; cancelled %d rollout "
                       "tasks (qids: %s)", timeout, len(abandoned),
                       ", ".join(abandoned))
        # best-effort slot release for the cancelled qids
        for qid in abandoned:
            try:
                await self.finish_rollout(qid, False)
            except Exception:
                logger.warning("could not release slot for abandoned %s", qid)
