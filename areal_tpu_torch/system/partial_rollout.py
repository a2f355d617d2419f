"""Chunked (interruptible) generation client (the counterpart of
``areal_tpu/system/partial_rollout.py``).

Each request asks for at most ``new_tokens_per_chunk`` tokens, so a weight
update only ever interrupts one chunk. An unfinished sequence is
re-scheduled through the manager with ``prompt + accumulated tokens``
under a fresh rid; each sample carries ``version_start`` (the weight
version of its first chunk) and ``version_end`` (of its last), so a
sequence whose tokens span a weight update says so. The n samples of one
qid come back as one ``BundledGenerationOutputs``.

HTTP goes through ``base/http.py`` (asyncio connections, no threads).
Each group runs in a ``rollout/group`` span; where the rollout worker
registered the trajectory's trace context for the qid
(``trace_parents``), the group joins that trace (the reference's group
roots a trace of its own), so one qid's hops from the worker through the
manager to the server form one trace. Chunk routing is a
``rollout/schedule`` span whose context rides the manager call.
"""

import asyncio
import logging
import re
import time
import uuid
from typing import Dict, List, Optional

from areal_tpu_torch.api.agent import BundledGenerationOutputs, GenerationFailedError
from areal_tpu_torch.api.model import GenerationHyperparameters
from areal_tpu_torch.base import http, tracing
from areal_tpu_torch.base import metrics as metrics_mod
from areal_tpu_torch.gen.client import ClientError, ClientResponseError, GenAPIClient

logger = logging.getLogger("areal_tpu_torch.partial_rollout")


class PartialRolloutManager:
    def __init__(
        self,
        request_queue: asyncio.Queue,
        reply_queue: asyncio.Queue,
        gserver_manager_url: str,
        new_tokens_per_chunk: int = 256,
        timeout: float = 300.0,
        max_server_failures: int = 6,
    ):
        self.request_queue = request_queue
        self.reply_queue = reply_queue
        self.manager_url = gserver_manager_url
        self.new_tokens_per_chunk = new_tokens_per_chunk
        self.timeout = timeout
        # generate failures tolerated per group member before the group is
        # surfaced as failed (each is reported to the manager's health
        # plane and the chunk re-scheduled)
        self.max_server_failures = max_server_failures
        self._tasks: Dict[str, asyncio.Task] = {}
        # the generation client of every group (its retry count is the
        # worker's), and what the chunks did: one count per chunk answered,
        # by finish reason, and generate failures
        self.client = GenAPIClient(timeout=timeout)
        self.stats: Dict[str, int] = {"chunks": 0, "server_failures": 0}
        # qid -> the trajectory's wire trace context (set by the rollout
        # worker around its agent task; multi-turn "<qid>-tK" groups look
        # up their base qid)
        self.trace_parents: Dict[str, dict] = {}

    async def _schedule(self, qid: str, prompt_len: int, group_size: int,
                        budget: int, prev_url: Optional[str],
                        prev_version: Optional[int]):
        with tracing.span("rollout/schedule", qid=qid):
            body = {
                "qid": qid,
                "prompt_len": prompt_len,
                "group_size": group_size,
                "new_token_budget": budget,
                "previous_server_url": prev_url,
                "previous_version": prev_version,
            }
            trace = tracing.wire_context(qid=qid)
            if trace is not None:
                # the hop's trace context: the manager activates it, so its
                # routing span joins this tree
                body["trace"] = trace
            d = await http.request_json(
                "POST", f"{self.manager_url}/schedule_request", body,
                timeout=self.timeout)
        return d["url"], d["version"]

    async def _report_failure(self, url: str, qid: str, reason: str):
        """Passive health observation: tell the manager this server failed
        a generate so its circuit breaker counts it (best-effort)."""
        try:
            await http.request_json(
                "POST", f"{self.manager_url}/report_failure",
                {"url": url, "qid": qid, "reason": reason},
                timeout=self.timeout)
        except (ClientError, ConnectionError, asyncio.TimeoutError):
            logger.warning("could not report failure of %s to manager", url)

    async def _gen_one(self, qid: str, prompt_ids: List[int],
                       gconfig: GenerationHyperparameters):
        """Generate one group member with chunked re-scheduling."""
        acc_out: List[int] = []
        acc_lp: List[float] = []
        version_start = -1
        version_end = -1
        prev_url = None
        prev_version = None
        no_eos = True
        server_failures = 0
        first_chunk_time = 0.0  # lifecycle stamp: first chunk back
        while len(acc_out) < gconfig.max_new_tokens:
            url, version = await self._schedule(
                qid, len(prompt_ids), gconfig.n, gconfig.max_new_tokens,
                prev_url, prev_version,
            )
            prev_url, prev_version = url, version
            chunk = min(self.new_tokens_per_chunk,
                        gconfig.max_new_tokens - len(acc_out))
            try:
                res = await self.client.generate(
                    url,
                    rid=f"{qid}-{uuid.uuid4().hex[:8]}",
                    input_ids=prompt_ids + acc_out,
                    sampling_params={
                        "max_new_tokens": chunk,
                        "min_new_tokens": max(
                            0, gconfig.min_new_tokens - len(acc_out)),
                        "temperature": gconfig.temperature,
                        "top_p": gconfig.top_p,
                        "top_k": gconfig.top_k,
                        "greedy": gconfig.greedy,
                        "stop_token_ids": list(gconfig.stop_token_ids),
                    },
                )
            except (ClientError, ConnectionError, asyncio.TimeoutError) as e:
                if isinstance(e, ClientResponseError):
                    if e.status == 400:
                        # the sequence hit the server's context capacity:
                        # a length truncation
                        logger.warning("generate rejected for %s: %s", qid, e)
                        break
                    if e.status < 500:
                        # a deterministic rejection of THIS request: not a
                        # server-health signal
                        raise
                # the server died mid-chunk or is erroring: report it and
                # re-schedule this chunk (the accumulated tokens are kept)
                server_failures += 1
                self.stats["server_failures"] += 1
                metrics_mod.counters.add(metrics_mod.FT_GEN_SERVER_FAILURES)
                await self._report_failure(url, qid, repr(e))
                if server_failures >= self.max_server_failures:
                    raise GenerationFailedError(
                        f"{qid}: {server_failures} generate failures, "
                        f"last on {url}: {e!r}"
                    ) from e
                prev_url = prev_version = None  # drop the sticky hint
                continue
            self.stats["chunks"] += 1
            self.stats[f"chunks_{res.finish_reason}"] = self.stats.get(
                f"chunks_{res.finish_reason}", 0) + 1
            acc_out.extend(res.output_ids)
            acc_lp.extend(res.output_logprobs)
            if not first_chunk_time:
                first_chunk_time = time.time()
            if version_start < 0:
                version_start = res.version
            version_end = res.version
            if res.finish_reason == "stop":
                no_eos = False
                break
            if res.finish_reason == "length" and len(res.output_ids) < chunk:
                # fewer tokens than the chunk budget: the server capped the
                # sequence at its KV capacity; do not resubmit
                break
            # "length" (chunk exhausted) or "interrupted": re-schedule with
            # the accumulated tokens
        return (acc_out, acc_lp, no_eos, version_start, version_end,
                first_chunk_time)

    async def _handle_group(self, qid: str, prompt_ids: List[int],
                            gconfig: GenerationHyperparameters):
        # always deliver a bundle and release the task slot: a stuck agent
        # would strand a manager capacity slot and wedge the staleness gate
        error = None
        submit_time = time.time()  # lifecycle stamp: group submitted
        try:
            # run_step spawns this task outside any rollout context, so the
            # group activates its trajectory's context (or roots a trace of
            # its own) with the qid riding it
            parent = self.trace_parents.get(qid) or self.trace_parents.get(
                re.sub(r"-t\d+$", "", qid))
            with tracing.activate(parent, qid=qid), tracing.span(
                    "rollout/group", qid=qid, group_size=gconfig.n):
                results = await asyncio.gather(
                    *(self._gen_one(qid, prompt_ids, gconfig)
                      for _ in range(gconfig.n)),
                    return_exceptions=True,
                )
            for r in results:
                # one failed member fails the group: a partial group would
                # bias the grouped-advantage baseline
                if isinstance(r, BaseException):
                    raise r
        except Exception as e:
            logger.exception("generation for qid %s failed", qid)
            error = repr(e)
            results = [([], [], True, -1, -1, 0.0) for _ in range(gconfig.n)]
        finally:
            self._tasks.pop(qid, None)
        chunk_times = [r[5] for r in results if r[5]]
        bundle = BundledGenerationOutputs(
            qid=qid,
            prompt_ids=list(prompt_ids),
            output_ids=[r[0] for r in results],
            logprobs=[r[1] for r in results],
            no_eos=[r[2] for r in results],
            version_start=[r[3] for r in results],
            version_end=[r[4] for r in results],
            error=error,
            submit_time=submit_time,
            first_chunk_time=min(chunk_times) if chunk_times else 0.0,
        )
        await self.reply_queue.put(bundle)

    async def run_step(self):
        """Drain pending observations and spawn generation tasks."""
        while not self.request_queue.empty():
            qid, prompt_ids, gconfig = self.request_queue.get_nowait()
            assert qid not in self._tasks, f"duplicate qid {qid}"
            self._tasks[qid] = asyncio.get_running_loop().create_task(
                self._handle_group(str(qid), list(prompt_ids), gconfig)
            )
        await asyncio.sleep(0.002)

    @property
    def n_running(self) -> int:
        return len(self._tasks)
