"""Remote reward-sandbox client: batched async fan-out with a concurrency
cap, retries and timeout semantics (the counterpart of
``areal_tpu/rewards/remote.py``, itself after the reference's
``functioncall/base/call.py``).

- payload checks: an empty payload or empty code fails without a call;
- exponential back-off with jitter between attempts; an HTTP error, a body
  that is not JSON and a ``SystemError`` result (a sandbox fault, not a
  graded failure) are retried;
- a timeout returns a structured failure at once (the sandbox budget is
  spent; re-running a slow case would bill it twice), as does a payload
  whose retries ran out: the caller always gets one result dict per
  payload, never an exception;
- a semaphore caps the calls in flight (``default_concurrency``: a shared
  budget of 5000 split across data-parallel callers,
  ``AREAL_FUNCTIONCALL_CONCURRENCY`` overrides);
- p50/p90/p99 latency of each batch is logged.

Enabled by ``AREAL_ENABLE_FUNCTION_CALL=1`` with
``AREAL_FUNCTIONCALL_SERVICE_DOMAIN``. The reference speaks aiohttp; the
port's calls go through ``base/http.py::request``, one connection per
call on the standard library.
"""

import asyncio
import json
import logging
import random
import time
from statistics import median
from typing import Any, Dict, List, Optional

from areal_tpu_torch.base import constants, http

logger = logging.getLogger("areal_tpu_torch.rewards.remote")


def enabled() -> bool:
    """Whether math/code grading goes to the remote sandbox: the switch
    is on and a service domain is set."""
    return constants.function_call_enabled() and bool(service_domain())


def service_domain() -> str:
    return constants.functioncall_service_domain()


def _failure(uid: str, reason: str) -> Dict[str, Any]:
    """The structured failure shape: callers always see a result dict per
    payload, never an exception."""
    return {
        "uid": uid,
        "success": False,
        "results": [
            {"success": False, "reason": reason, "errorType": "UnknownError"}
        ],
    }


def check_payload(payload: Optional[Dict[str, Any]]) -> Optional[Dict[str, Any]]:
    """None = valid; otherwise the failure result to return without a
    call."""
    if not payload:
        return _failure("", "Empty payload")
    if "code" in payload and not payload["code"]:
        return _failure(payload.get("uid", ""), "Empty code")
    return None


def has_system_error(response_json: Dict[str, Any]) -> bool:
    """A ``SystemError`` in any per-testcase result: a sandbox-side fault
    worth a retry, not a graded failure."""
    return any(
        r.get("errorType") == "SystemError"
        for r in response_json.get("results", [])
    )


def default_concurrency() -> int:
    """Per-process cap: a shared sandbox budget split across data-parallel
    callers, overridable via ``AREAL_FUNCTIONCALL_CONCURRENCY``."""
    override = constants.functioncall_concurrency_override()
    if override is not None:
        return override
    budget = 5000
    return max(budget // max(constants.functioncall_dp(), 1), 1)


async def async_invoke(
    url: str,
    payload: Dict[str, Any],
    timeout: float,
    max_retries: int = 2,
    initial_retry_interval: float = 0.5,
    max_retry_interval: float = 10.0,
) -> Dict[str, Any]:
    """One payload: an HTTP error, a body that is not JSON or a
    ``SystemError`` result retries after an exponential back-off with
    jitter; a timeout returns a failure at once; retries exhausted ->
    failure result."""
    uid = payload.get("uid", "")
    for attempt in range(max_retries):
        try:
            status, _, body = await http.request("POST", url, payload,
                                                 timeout=timeout)
            if status != 200:
                raise RuntimeError(
                    f"HTTP {status}: "
                    f"{body.decode('utf-8', 'replace')[:200]}")
            try:
                rj = json.loads(body)
            except ValueError as e:
                raise RuntimeError("invalid JSON response") from e
            if has_system_error(rj):
                raise RuntimeError(f"SystemError in sandbox, uid={uid}")
            return rj
        except asyncio.TimeoutError:
            logger.warning("function call timed out, uid=%s url=%s", uid, url)
            return _failure(uid, "Function call timed out.")
        except Exception as e:  # noqa: BLE001 - retried with back-off
            logger.warning(
                "function call attempt %d failed: %r, uid=%s", attempt + 1, e, uid
            )
        if attempt + 1 >= max_retries:
            break
        await asyncio.sleep(
            min(
                initial_retry_interval * (2 ** (attempt + 1))
                + random.uniform(0, 1),
                max_retry_interval,
            )
        )
    return _failure(uid, "Function call exceed max retries.")


async def batch_function_call_async(
    payloads: List[Dict[str, Any]],
    url: str,
    timeout: float = 100.0,
    concurrency: Optional[int] = None,
    max_retries: int = 2,
    initial_retry_interval: float = 0.5,
) -> List[Dict[str, Any]]:
    """Order-preserving batch fan-out under a semaphore cap; every payload
    yields a result dict (the failure shape included): the training loop
    never crashes on a sandbox hiccup."""
    concurrency = concurrency or default_concurrency()
    sem = asyncio.Semaphore(concurrency)
    elapsed: List[float] = []

    async def one(payload):
        bad = check_payload(payload)
        if bad is not None:
            return bad
        async with sem:
            t0 = time.monotonic()
            r = await async_invoke(
                url, payload, timeout, max_retries=max_retries,
                initial_retry_interval=initial_retry_interval,
            )
            elapsed.append(time.monotonic() - t0)
            return r

    # return_exceptions: one crashed invocation must not abort the batch;
    # the contract is one result dict per payload
    raw = await asyncio.gather(*(one(p) for p in payloads),
                               return_exceptions=True)
    results = [
        r if not isinstance(r, BaseException) else _failure(
            p.get("uid", "") if isinstance(p, dict) else "",
            f"{type(r).__name__}: {r}",
        )
        for p, r in zip(payloads, raw)
    ]
    if elapsed:
        s = sorted(elapsed)

        def pct(p):
            return s[min(int(len(s) * p / 100), len(s) - 1)]

        logger.info(
            "batch function call: n=%d concurrency=%d p50=%.3fs p90=%.3fs "
            "p99=%.3fs max=%.3fs",
            len(payloads), concurrency, median(s), pct(90), pct(99), s[-1],
        )
    return results


async def batch_function_call(
    payloads: List[Dict[str, Any]],
    task_type: str,
    timeout: float = 100.0,
    concurrency: Optional[int] = None,
    **kw,
) -> List[Dict[str, Any]]:
    """POST each payload to ``{domain}/{task_type}_verify``."""
    url = f"{service_domain()}/{task_type}_verify"
    return await batch_function_call_async(
        payloads, url, timeout=timeout, concurrency=concurrency, **kw
    )


async def math_verify_remote(
    answers: List[str], solutions: List[List[str]], qids: List[str]
) -> List[bool]:
    payloads = [
        {"answer": a, "solutions": s, "qid": q, "uid": q}
        for a, s, q in zip(answers, solutions, qids)
    ]
    results = await batch_function_call(payloads, "math")
    return [bool(r and r.get("success")) for r in results]


async def code_verify_remote(
    codes: List[str], qids: List[str]
) -> List[bool]:
    payloads = [
        {"code": c, "qid": q, "uid": q} for c, q in zip(codes, qids)
    ]
    results = await batch_function_call(payloads, "code")
    return [bool(r and r.get("success")) for r in results]
