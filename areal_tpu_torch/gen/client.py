"""Async HTTP client for the generation fleet (the counterpart of
``areal_tpu/gen/client.py``): ``generate``, ``generate_stream`` and the
weight-update call with the reference's retry and timeout posture, on the
standard library
(``base/http.py``: one connection per call over ``asyncio.open_connection``,
so the number of calls in flight is bounded by nothing but the callers).

- Capped exponential backoff with jitter from a seeded ``random.Random``.
  ``generate`` and weight updates retry on connection errors only: a
  timeout proves the client gave up, not that the peer never saw the
  request, and a fan-out must not multiply a black-holing server's
  timeout budget. Control-plane calls also retry 502/503/504.
- Per-call timeouts (``request_timeout``, for health and metrics) apart
  from the long ``timeout`` that bounds a generate.
- A 4xx/5xx answer raises ``ClientResponseError`` carrying ``status``, as
  ``aiohttp.ClientResponseError`` does in the reference.
- Named fault-injection points (``gen.http`` before every attempt,
  ``gen.weight_update`` before a weight update; ``base/faults.py``) let
  tests script failures; retries count in ``ft/client_retries``.
- ``generate`` runs in a ``gen_client/generate`` span, and both generate
  calls carry the caller's trace context in the body's ``trace`` field,
  so the server's spans join the caller's trace.
"""

import asyncio
import dataclasses
import json
import random
import time
from typing import Dict, List, Optional

from areal_tpu_torch.base import faults, http, tracing
from areal_tpu_torch.base import metrics as metrics_mod
from areal_tpu_torch.base.http import (  # noqa: F401  (re-exported)
    ClientConnectionError,
    ClientError,
    ClientResponseError,
)


class DeadlineExceeded(asyncio.TimeoutError):
    """The request's overall deadline expired before it was answered; never
    retried."""


# the request never completed: safe to retry even non-idempotent calls
# (ConnectionError includes faults.FaultInjected)
CONNECTION_ERRORS = (ClientConnectionError, ConnectionError, asyncio.TimeoutError)
# 5xx the fleet emits while pausing/restarting: transient by contract
RETRYABLE_STATUS = (502, 503, 504)


@dataclasses.dataclass
class RetryPolicy:
    """Capped exponential backoff with full jitter."""

    max_attempts: int = 3
    backoff_base_s: float = 0.05
    backoff_cap_s: float = 2.0
    jitter: float = 0.5  # each delay is scaled by U[1-jitter, 1]

    def delay(self, attempt: int, rng: random.Random) -> float:
        d = min(self.backoff_cap_s, self.backoff_base_s * (2 ** attempt))
        return d * (1.0 - self.jitter * rng.random())


@dataclasses.dataclass
class APIGenerateResult:
    rid: str
    output_ids: List[int]
    output_logprobs: List[float]
    finish_reason: str
    version: int


class GenAPIClient:
    def __init__(
        self,
        timeout: float = 300.0,
        request_timeout: Optional[float] = None,
        retry: Optional[RetryPolicy] = None,
        seed: Optional[int] = None,
    ):
        """``timeout`` bounds the longest call (a generate);
        ``request_timeout`` bounds one control-plane call (health/metrics),
        by default min(10 s, timeout)."""
        self.timeout = timeout
        self.request_timeout = (min(10.0, timeout) if request_timeout is None
                                else request_timeout)
        self.retry = retry or RetryPolicy()
        self.retries = 0
        self._rng = random.Random(seed)

    async def __aenter__(self):
        return self

    async def __aexit__(self, *exc):
        return None

    async def _request_json(
        self,
        method: str,
        server_url: str,
        endpoint: str,
        op: str,
        json_body: Optional[Dict] = None,
        timeout: Optional[float] = None,
        retry_connection_only: bool = False,
    ) -> Dict:
        """One logical call = up to ``retry.max_attempts`` HTTP attempts.
        ``retry_connection_only`` retries only errors where the request
        provably never completed (a generate re-sent while the server runs
        it would double-bill its rid)."""
        attempt = 0
        while True:
            try:
                await faults.maybe_fail_async(
                    "gen.http", url=server_url, op=op)
                return await http.request_json(
                    method, f"{server_url}{endpoint}", json_body,
                    timeout=self.timeout if timeout is None else timeout)
            except Exception as e:
                if retry_connection_only:
                    retryable = isinstance(
                        e, CONNECTION_ERRORS
                    ) and not isinstance(e, asyncio.TimeoutError)
                else:
                    retryable = isinstance(e, CONNECTION_ERRORS) or (
                        isinstance(e, ClientResponseError)
                        and e.status in RETRYABLE_STATUS
                    )
                attempt += 1
                if not retryable or attempt >= self.retry.max_attempts:
                    raise
                self.retries += 1
                metrics_mod.counters.add(metrics_mod.FT_CLIENT_RETRIES)
                await asyncio.sleep(self.retry.delay(attempt - 1, self._rng))

    async def generate(
        self,
        server_url: str,
        rid: str,
        input_ids: List[int],
        sampling_params: Dict,
    ) -> APIGenerateResult:
        with tracing.span("gen_client/generate", rid=rid):
            body = {"rid": rid, "input_ids": input_ids,
                    "sampling_params": sampling_params}
            trace = tracing.wire_context()
            if trace is not None:
                # the hop's trace context: the server activates it, so its
                # spans join this one as children
                body["trace"] = trace
            d = await self._request_json(
                "POST", server_url, "/generate", op="generate",
                json_body=body, retry_connection_only=True,
            )
        return APIGenerateResult(
            rid=d["rid"],
            output_ids=d["output_ids"],
            output_logprobs=d["output_logprobs"],
            finish_reason=d["finish_reason"],
            version=d["version"],
        )

    async def generate_stream(
        self,
        server_url: str,
        rid: str,
        input_ids: List[int],
        sampling_params: Dict,
        deadline_s: Optional[float] = None,
    ):
        """Async iterator over ``/generate_stream``: one dict per SSE frame
        (``token_ids`` / ``logprobs`` deltas; the final frame carries
        ``finish_reason`` and ``version``), ending at ``data: [DONE]``.

        The retry policy applies only to opening the stream (a refused
        connection never reached the engine). Once it is open, a drop
        before ``[DONE]`` raises ``ClientConnectionError``: the server may
        have generated, and its cancel path owns the slot, so re-sending
        would double-bill the rid (as ``generate``).

        ``deadline_s`` is the request's remaining budget in seconds: the
        backoff never sleeps past it (``DeadlineExceeded`` instead), and it
        is forwarded in the body, so the server ends the stream with a
        ``"deadline"`` frame and frees the slot when it runs out."""
        body = {"rid": rid, "input_ids": input_ids,
                "sampling_params": sampling_params}
        trace = tracing.wire_context()
        if trace is not None:
            body["trace"] = trace
        t_deadline = None
        if deadline_s is not None and deadline_s > 0:
            body["deadline_s"] = float(deadline_s)
            t_deadline = time.monotonic() + deadline_s
        url = f"{server_url}/generate_stream"
        attempt = 0
        while True:
            if t_deadline is not None and time.monotonic() >= t_deadline:
                raise DeadlineExceeded(
                    f"deadline expired before the stream for {rid} opened")
            try:
                await faults.maybe_fail_async(
                    "gen.http", url=server_url, op="generate_stream")
                stream = await http.open_stream("POST", url, body,
                                                timeout=self.timeout)
                break
            except Exception as e:
                retryable = isinstance(
                    e, CONNECTION_ERRORS
                ) and not isinstance(e, asyncio.TimeoutError)
                attempt += 1
                if not retryable or attempt >= self.retry.max_attempts:
                    raise
                delay = self.retry.delay(attempt - 1, self._rng)
                if (t_deadline is not None
                        and time.monotonic() + delay >= t_deadline):
                    raise DeadlineExceeded(
                        f"deadline expired during connect backoff for {rid}"
                    ) from e
                self.retries += 1
                metrics_mod.counters.add(metrics_mod.FT_CLIENT_RETRIES)
                await asyncio.sleep(delay)
        try:
            while True:
                line = await asyncio.wait_for(stream.readline(), self.timeout)
                if not line:
                    raise ClientConnectionError(
                        f"{url}: the stream for {rid} ended before [DONE]")
                line = line.strip()
                if not line.startswith(b"data:"):
                    continue          # blank separators, SSE comments
                payload = line[len(b"data:"):].strip()
                if payload == b"[DONE]":
                    return
                yield json.loads(payload)
        finally:
            stream.close()

    async def update_weights_from_disk(
        self,
        server_url: str,
        model_path: str,
        version: Optional[int] = None,
        allow_interrupt: bool = True,
    ) -> Dict:
        await faults.maybe_fail_async("gen.weight_update", url=server_url)
        # connection-only retries: a refused connection fails in
        # milliseconds, but a black-holing server burns the timeout at most
        # once (the manager's fan-out awaits the slowest server)
        return await self._request_json(
            "POST", server_url, "/update_weights_from_disk",
            op="update_weights",
            json_body={"model_path": model_path, "version": version,
                       "allow_interrupt": allow_interrupt},
            retry_connection_only=True,
        )

    async def set_spec_decode(self, server_url: str, enabled: bool) -> Dict:
        """Toggle speculative decoding on a server (it takes effect at the
        server's next chunk dispatch). Control-plane call: short per-call
        timeout, idempotent, so the full retry policy applies."""
        return await self._request_json(
            "POST", server_url, "/spec_decode", op="spec_decode",
            json_body={"enabled": bool(enabled)},
            timeout=self.request_timeout,
        )

    async def post_json(self, server_url: str, endpoint: str,
                        json_body: Dict, op: str = "control") -> Dict:
        """Idempotent control-plane POST (manager ``/add_server``, ...):
        short per-call timeout, full retry policy."""
        return await self._request_json(
            "POST", server_url, endpoint, op=op, json_body=json_body,
            timeout=self.request_timeout,
        )

    async def metrics(self, server_url: str) -> Dict:
        return await self._request_json(
            "GET", server_url, "/metrics_json", op="metrics",
            timeout=self.request_timeout,
        )

    async def health(self, server_url: str) -> bool:
        """One probe with the short per-call timeout, never retried (the
        breaker's half-open logic supplies the retry cadence)."""
        try:
            await faults.maybe_fail_async(
                "gen.http", url=server_url, op="health")
            await http.request_json("GET", f"{server_url}/health",
                                    timeout=self.request_timeout)
            return True
        except (ClientError, ConnectionError, asyncio.TimeoutError):
            return False
