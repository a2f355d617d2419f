"""OpenAI-compatible HTTP frontend for the gen fleet (the counterpart of
``areal_tpu/gateway/api.py``), served by ``base/http.py``:

- ``POST /v1/completions`` — prompt as a string (via the configured
  tokenizer codec) or a raw token-id array (the OpenAI token-array form;
  what the tests and RL-side tooling use), SSE streaming or buffered.
- ``POST /v1/chat/completions`` — messages rendered through a minimal
  chat template, same streaming surface (``chat.completion.chunk``).
- ``GET /v1/models``, ``GET /health``, ``GET /metrics_json``.

Validation is answered with OpenAI-style 4xx error bodies
(``{"error": {"message", "type", "code"}}``) before anything reaches the
scheduler; rate-limit and queue-full answers are 429 with a
``Retry-After`` hint, every backend breaker open is 503, a request whose
deadline passes before its first token is 504. Tenancy comes from the
``Authorization: Bearer`` key (mapped through the configured key table)
or an ``X-Tenant`` header, defaulting to the anonymous tenant.

Threads and the loop. ``base/http.py`` answers each request on a thread
of its own, while every piece of scheduler state (the fair queue, the
buckets, the server slots) lives on ONE event loop: the loop
``serve_gateway`` is awaited on, which the scheduler was started on. A
handler thread validates the body, hands the admission to that loop
(``asyncio.run_coroutine_threadsafe``) and waits on futures for the
request's events; it touches no scheduler state itself. A streamed answer
is a ``Stream`` whose frames pull events from the loop, and whose
``on_close`` cancels the request on the loop, so a client that hangs up
early gets its tenant's charge refunded and frees the gen server's slot.
A handler that waits for an event polls ``client_gone()`` every 0.5 s, as
the reference polls its transport, so a client that leaves while its
request is still queued releases the queue entry at once.

Token<->text conversion goes through a :class:`TokenCodec`. Production
wires an HF tokenizer (``HFTokenizerCodec``); the fallback
:class:`ByteFallbackCodec` keeps the surface usable against random-weight
models (tests, the chip smoke) where text is meaningless anyway.
"""

import asyncio
import concurrent.futures
import contextlib
import dataclasses
import json
import threading
import time
from typing import Dict, List, Optional, Tuple

from areal_tpu_torch.base import http, logging, tracing
from areal_tpu_torch.base import metrics as metrics_mod
from areal_tpu_torch.gateway.scheduler import (
    ContinuousBatchScheduler,
    GatewayRequest,
    RateLimited,
    ServiceUnavailable,
)

logger = logging.getLogger("areal_tpu_torch.gateway.api")

# how often a handler waiting for its request's next event checks that the
# client is still connected
CLIENT_POLL_S = 0.5


# --------------------------------------------------------------------- #
# token <-> text codecs
# --------------------------------------------------------------------- #


class TokenCodec:
    """encode/decode between user-facing text and engine token ids."""

    def encode(self, text: str) -> List[int]:
        raise NotImplementedError

    def decode(self, ids: List[int]) -> str:
        raise NotImplementedError


class ByteFallbackCodec(TokenCodec):
    """UTF-8 bytes clamped into the model vocab. Deterministic and
    reversible for ids < 256 — a placeholder codec for random-weight
    serving, NOT a tokenizer."""

    def __init__(self, vocab_size: int):
        self.vocab_size = vocab_size

    def encode(self, text: str) -> List[int]:
        return [b % self.vocab_size for b in text.encode("utf-8")]

    def decode(self, ids: List[int]) -> str:
        return bytes(int(t) % 256 for t in ids).decode(
            "latin-1", errors="replace"
        )


class HFTokenizerCodec(TokenCodec):
    """Wraps a HuggingFace tokenizer (lazy transformers import)."""

    def __init__(self, path: str):
        import transformers

        self.tok = transformers.AutoTokenizer.from_pretrained(path)

    def encode(self, text: str) -> List[int]:
        return list(self.tok.encode(text, add_special_tokens=False))

    def decode(self, ids: List[int]) -> str:
        return self.tok.decode(ids)


# --------------------------------------------------------------------- #
# config + validation
# --------------------------------------------------------------------- #


@dataclasses.dataclass
class GatewayConfig:
    model_id: str = "areal-tpu"
    default_tenant: str = "anonymous"
    # API key -> tenant name; empty + require_api_key=False means every
    # unauthenticated request rides the default (anonymous) tenant
    api_keys: Dict[str, str] = dataclasses.field(default_factory=dict)
    require_api_key: bool = False
    max_tokens_cap: int = 2048
    default_max_tokens: int = 256
    # brownout level >= 1 (gateway/brownout.py): a live clamp applied on
    # top of the validated request — None when the ladder is at level 0
    brownout_max_tokens: Optional[int] = None


class BadRequest(Exception):
    def __init__(self, message: str, status: int = 400, code: str = ""):
        super().__init__(message)
        self.status = status
        self.code = code or "invalid_request_error"


class ClientGone(ConnectionResetError):
    """The client closed its connection while its request waited."""


def _error_response(message: str, status: int, code: str, **headers):
    if status == 429:
        metrics_mod.counters.add(metrics_mod.GW_REJECTED_429)
    elif status < 500:
        metrics_mod.counters.add(metrics_mod.GW_REJECTED_4XX)
    return (
        status,
        {
            "error": {
                "message": message,
                "type": "invalid_request_error" if status < 500 else
                "server_error",
                "code": code,
            }
        },
        {k.replace("_", "-"): str(v) for k, v in headers.items()},
    )


def _require(cond: bool, message: str):
    if not cond:
        raise BadRequest(message)


def parse_sampling(d: dict, cfg: GatewayConfig) -> Tuple[Dict, bool]:
    """Shared OpenAI sampling-surface validation -> (engine
    sampling_params, stream flag)."""
    try:
        max_tokens = int(d.get("max_tokens", cfg.default_max_tokens))
        temperature = float(d.get("temperature", 1.0))
        top_p = float(d.get("top_p", 1.0))
        n = int(d.get("n", 1))
        stream = bool(d.get("stream", False))
    except (TypeError, ValueError) as e:
        raise BadRequest(f"malformed sampling parameter: {e}")
    _require(1 <= max_tokens <= cfg.max_tokens_cap,
             f"max_tokens must be in [1, {cfg.max_tokens_cap}]")
    _require(temperature >= 0.0, "temperature must be >= 0")
    _require(0.0 < top_p <= 1.0, "top_p must be in (0, 1]")
    _require(n == 1, "n > 1 is not supported")
    if cfg.brownout_max_tokens is not None:
        # degraded-but-correct: shorter answers for everyone beats 429s
        # for some (the clamp is removed when the ladder steps back down)
        max_tokens = min(max_tokens, max(int(cfg.brownout_max_tokens), 1))
    sp = {
        "max_new_tokens": max_tokens,
        "temperature": temperature,
        "top_p": top_p,
        "greedy": temperature == 0.0,
    }
    return sp, stream


def parse_deadline(d: dict, request: http.Request) -> float:
    """Per-request deadline intake: the body's ``timeout`` field (seconds,
    OpenAI-client idiom) wins over an ``X-Request-Deadline`` header
    (relative seconds); 0 = none (the tenant/fleet default applies)."""
    raw = d.get("timeout")
    if raw is None:
        raw = request.header("X-Request-Deadline")
    if raw is None:
        return 0.0
    try:
        deadline = float(raw)
    except (TypeError, ValueError):
        raise BadRequest("'timeout' must be a number of seconds")
    _require(
        deadline > 0 and deadline == deadline and deadline != float("inf"),
        "'timeout' must be a positive finite number of seconds",
    )
    return deadline


def encode_stop(stop, codec: TokenCodec) -> List[int]:
    """OpenAI ``stop`` strings -> engine stop token ids. Only stops that
    encode to exactly one token are expressible at the engine level; a
    multi-token stop is a clear 400, not a silent ignore."""
    if stop is None:
        return []
    if isinstance(stop, str):
        stop = [stop]
    _require(isinstance(stop, list) and len(stop) <= 4,
             "stop must be a string or a list of up to 4 strings")
    out = []
    for s in stop:
        if isinstance(s, int):
            out.append(s)
            continue
        _require(isinstance(s, str), "stop entries must be strings")
        ids = codec.encode(s)
        _require(
            len(ids) == 1,
            f"stop sequence {s!r} does not map to a single token; pass "
            "stop token ids directly via 'stop_token_ids'",
        )
        out.append(ids[0])
    return out


def _sse(obj) -> bytes:
    return b"data: " + json.dumps(obj).encode() + b"\n\n"


# --------------------------------------------------------------------- #
# server
# --------------------------------------------------------------------- #


class GatewayServer:
    def __init__(
        self,
        scheduler: ContinuousBatchScheduler,
        codec: TokenCodec,
        config: Optional[GatewayConfig] = None,
    ):
        self.scheduler = scheduler
        self.codec = codec
        self.config = config or GatewayConfig()
        # tenants that may be named via the UNAUTHENTICATED X-Tenant
        # header: the INITIAL configured set MINUS key-mapped tenants —
        # an arbitrary header must neither mint a fresh full token bucket
        # per unseen name (rate-limit bypass + unbounded state) nor
        # impersonate a tenant whose identity is an API key (draining its
        # budget/weight would be a cross-tenant denial of service)
        self._known_tenants = set(scheduler.tenants) - set(
            self.config.api_keys.values()
        )
        self._start_t = time.time()
        # the scheduler's loop (``serve_gateway`` binds it) and the flag
        # that releases handlers still waiting when the gateway stops
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._stopping = threading.Event()

    def routes(self):
        """The route table in one place (the reference's)."""
        return {
            ("POST", "/v1/completions"): self._completions,
            ("POST", "/v1/chat/completions"): self._chat_completions,
            ("GET", "/v1/models"): self._models,
            ("GET", "/health"): self._health,
            ("GET", "/metrics_json"): self._metrics,
        }

    # ------------------------- the loop's side ------------------------ #

    def _on_loop(self, coro):
        """Run ``coro`` on the scheduler's loop; its result (or raise)."""
        return asyncio.run_coroutine_threadsafe(coro, self._loop).result()

    async def _admit(self, req: GatewayRequest) -> None:
        self._check_capacity(req.input_ids, req.sampling_params)
        self.scheduler.submit(req)

    def _cancel(self, req: GatewayRequest) -> None:
        try:
            self._loop.call_soon_threadsafe(self.scheduler.cancel, req)
        except RuntimeError:
            pass  # the loop has closed: nothing is left to release

    def _next_event(self, request: http.Request, req: GatewayRequest):
        """Next scheduler event, polling the connection while waiting: a
        client that hangs up while its request is still QUEUED must
        release the queue slot + token-bucket charge now, not after the
        request ran to completion against a dead socket."""
        fut = asyncio.run_coroutine_threadsafe(req.events.get(), self._loop)
        while True:
            try:
                return fut.result(timeout=CLIENT_POLL_S)
            except concurrent.futures.TimeoutError:
                if request.client_gone() or self._stopping.is_set():
                    fut.cancel()
                    raise ClientGone("client went away")

    # ---------------------------- tenancy ----------------------------- #

    def _tenant_of(self, request: http.Request) -> str:
        auth = request.header("Authorization", "")
        key = auth[7:].strip() if auth.startswith("Bearer ") else ""
        if key:
            tenant = self.config.api_keys.get(key)
            if tenant is None and self.config.require_api_key:
                raise BadRequest("invalid API key", status=401,
                                 code="invalid_api_key")
            if tenant is not None:
                return tenant
        if self.config.require_api_key:
            raise BadRequest("missing API key", status=401,
                             code="invalid_api_key")
        header = request.header("X-Tenant", "")
        if header and header in self._known_tenants:
            return header
        # unknown names collapse into the default tenant (shared bucket
        # and fair-queue lane) instead of minting unbounded tenant state
        return self.config.default_tenant

    # --------------------------- handlers ----------------------------- #

    def _json_body(self, request: http.Request) -> dict:
        try:
            d = json.loads(request.body)
        except (ValueError, TypeError):
            raise BadRequest("body is not valid JSON")
        _require(isinstance(d, dict), "body must be a JSON object")
        return d

    def _prompt_ids(self, prompt) -> List[int]:
        if isinstance(prompt, str):
            _require(len(prompt) > 0, "prompt must be non-empty")
            return self.codec.encode(prompt)
        if isinstance(prompt, list) and prompt and all(
            isinstance(t, int) and not isinstance(t, bool) for t in prompt
        ):
            return list(prompt)
        raise BadRequest(
            "prompt must be a non-empty string or a non-empty array of "
            "token ids"
        )

    def _check_capacity(self, input_ids: List[int], sp: Dict) -> None:
        """Reject prompts the backend engines cannot hold — a 400 HERE,
        not a 502 when the dispatch hits the gen server's validator (the
        request would also have burned queue + rate budget). Runs on the
        loop: it reads the scheduler's capacity view."""
        cap = self.scheduler.min_slot_capacity()
        if cap and len(input_ids) - 1 + sp["max_new_tokens"] > cap:
            raise BadRequest(
                f"prompt ({len(input_ids)} tokens) + max_tokens "
                f"({sp['max_new_tokens']}) exceeds the backend per-slot "
                f"capacity {cap}"
            )

    def _intake(self, request: http.Request, endpoint: str, parse):
        """One completion request from intake to answer. Trace intake:
        honor an inbound W3C ``traceparent`` header (an external caller
        continuing its own trace), else root a fresh trace here — the
        gateway is the serving plane's trace origin. The ``gw/request``
        span stays open until the answer has gone out: for a stream,
        until the stream closes."""
        spans = contextlib.ExitStack()
        spans.enter_context(tracing.activate(request.header("traceparent")))
        span_attrs = spans.enter_context(
            tracing.span("gw/request", endpoint=endpoint))
        try:
            answer = self._answer(request, span_attrs, parse)
        except BaseException:
            spans.close()
            raise
        if not isinstance(answer[1], http.Stream):
            spans.close()
            return answer
        release = answer[1].on_close

        def on_close():
            try:
                release()
            finally:
                spans.close()

        answer[1].on_close = on_close
        return answer

    def _answer(self, request: http.Request, span_attrs: Dict, parse):
        try:
            tenant = self._tenant_of(request)
            d = self._json_body(request)
            input_ids, sp, stream, chat = parse(d)
            req = GatewayRequest.build(
                tenant, input_ids, sp,
                deadline_s=parse_deadline(d, request),
            )
            span_attrs["rid"] = req.rid
            span_attrs["tenant"] = tenant
            self._on_loop(self._admit(req))
        except BadRequest as e:
            return _error_response(str(e), e.status, e.code)
        except RateLimited as e:
            if e.permanent:  # can never be admitted: a client error
                return _error_response(str(e), 400, "invalid_request_error")
            return _error_response(
                str(e), 429, "rate_limit_exceeded",
                Retry_After=max(1, int(e.retry_after_s + 0.999)),
            )
        except ServiceUnavailable as e:
            return _error_response(
                str(e), 503, "service_unavailable",
                Retry_After=max(1, int(e.retry_after_s + 0.999)),
            )
        if not stream:
            return self._buffered_out(request, req, chat=chat)
        if chat:
            object_name = "chat.completion.chunk"

            def make_delta(text, first):
                return {"delta": ({"role": "assistant", "content": text}
                                  if first else {"content": text})}
        else:
            object_name = "text_completion"

            def make_delta(text, first):
                return {"text": text}
        done = []

        def on_close():
            if not done:  # closed before the final frame: release it
                self._cancel(req)

        return 200, http.Stream(
            self._stream_frames(request, req, object_name, make_delta, done),
            on_close=on_close,
        )

    @http.with_request
    def _completions(self, request: http.Request):
        return self._intake(request, "/v1/completions",
                            self._parse_completion)

    def _parse_completion(self, d: dict):
        _require("prompt" in d, "missing required field 'prompt'")
        input_ids = self._prompt_ids(d["prompt"])
        sp, stream = parse_sampling(d, self.config)
        stops = encode_stop(d.get("stop"), self.codec)
        extra = d.get("stop_token_ids", [])
        _require(
            isinstance(extra, list)
            and all(isinstance(t, int) for t in extra),
            "stop_token_ids must be a list of integers",
        )
        stops.extend(extra)
        if stops:
            sp["stop_token_ids"] = stops
        return input_ids, sp, stream, False

    @http.with_request
    def _chat_completions(self, request: http.Request):
        return self._intake(request, "/v1/chat/completions",
                            self._parse_chat)

    def _parse_chat(self, d: dict):
        msgs = d.get("messages")
        _require(
            isinstance(msgs, list) and len(msgs) > 0,
            "messages must be a non-empty list",
        )
        for m in msgs:
            _require(
                isinstance(m, dict)
                and isinstance(m.get("role"), str)
                and isinstance(m.get("content"), str),
                "each message needs string 'role' and 'content'",
            )
        input_ids = self.codec.encode(render_chat(msgs))
        _require(len(input_ids) > 0, "messages rendered to an empty prompt")
        sp, stream = parse_sampling(d, self.config)
        stops = encode_stop(d.get("stop"), self.codec)
        if stops:
            sp["stop_token_ids"] = stops
        return input_ids, sp, stream, True

    # ------------------------- output shaping ------------------------- #

    def _envelope(self, req: GatewayRequest, object_name: str) -> dict:
        return {
            "id": f"cmpl-{req.rid}",
            "object": object_name,
            "created": int(self._start_t),
            "model": self.config.model_id,
        }

    @staticmethod
    def _finish(reason: Optional[str]) -> str:
        # "deadline" passes through so streaming clients can tell a
        # budget-truncated answer from a natural stop
        if reason in ("length", "deadline"):
            return reason
        return "stop"

    def _stream_frames(self, request, req, object_name, make_delta, done):
        """The SSE frames, one per scheduler event, then ``[DONE]``;
        ``done`` gets an entry once the final event has arrived."""
        first = True
        # incremental detokenization: decode the FULL accumulated ids and
        # emit the text suffix — per-chunk decode garbles graphemes whose
        # tokens straddle a chunk boundary under a real (BPE) codec
        all_ids: List[int] = []
        emitted = 0
        while True:
            ev = self._next_event(request, req)
            if "error" in ev:
                done.append(True)
                yield _sse({
                    **self._envelope(req, object_name),
                    "choices": [],
                    "error": {"message": ev["error"],
                              "type": "server_error"},
                })
                break
            all_ids.extend(ev.get("token_ids", []))
            full = self.codec.decode(all_ids)
            text, emitted = full[emitted:], len(full)
            reason = ev.get("finish_reason")
            if reason:
                done.append(True)
            choice = {
                "index": 0,
                "finish_reason": self._finish(reason) if reason else None,
                **make_delta(text, first),
            }
            first = False
            yield _sse({**self._envelope(req, object_name),
                        "choices": [choice]})
            if reason:
                break
        yield b"data: [DONE]\n\n"

    def _buffered_out(self, request: http.Request, req: GatewayRequest,
                      chat: bool):
        tokens: List[int] = []
        reason = None
        try:
            while reason is None:
                ev = self._next_event(request, req)
                if "error" in ev:
                    if ev.get("finish_reason") == "deadline":
                        return _error_response(
                            ev["error"], 504, "deadline_exceeded"
                        )
                    return 502, {"error": {"message": ev["error"],
                                           "type": "server_error"}}
                tokens.extend(ev.get("token_ids", []))
                reason = ev.get("finish_reason")
        except ClientGone:
            self._cancel(req)
            raise
        if reason == "deadline" and not tokens:
            # expired before the first token: nothing useful to return
            return _error_response(
                "request deadline exceeded", 504, "deadline_exceeded"
            )
        text = self.codec.decode(tokens)
        if chat:
            choice = {
                "index": 0,
                "message": {"role": "assistant", "content": text},
                "finish_reason": self._finish(reason),
            }
            obj = "chat.completion"
        else:
            choice = {
                "index": 0,
                "text": text,
                "logprobs": None,
                "finish_reason": self._finish(reason),
            }
            obj = "text_completion"
        return 200, {
            **self._envelope(req, obj),
            "object": obj,
            "choices": [choice],
            "usage": {
                "prompt_tokens": len(req.input_ids),
                "completion_tokens": len(tokens),
                "total_tokens": len(req.input_ids) + len(tokens),
            },
        }

    # ------------------------- control plane -------------------------- #

    def _models(self, body: bytes):
        return 200, {
            "object": "list",
            "data": [
                {
                    "id": self.config.model_id,
                    "object": "model",
                    "created": int(self._start_t),
                    "owned_by": "areal_tpu",
                }
            ],
        }

    def _health(self, body: bytes):
        return 200, {"status": "ok"}

    async def _metrics_dict(self) -> Dict:
        return self.scheduler.metrics_dict()

    def _metrics(self, body: bytes):
        return 200, {
            "uptime_s": round(time.time() - self._start_t, 3),
            **self._on_loop(self._metrics_dict()),
        }


def render_chat(messages: List[dict]) -> str:
    """Minimal chat template (an HF codec could template instead; this
    keeps the wire format stable across codecs)."""
    parts = [f"{m['role']}: {m['content']}" for m in messages]
    return "\n".join(parts) + "\nassistant:"


class GatewayRunner:
    """A serving gateway's HTTP side: ``port``; ``close()`` stops the
    server and releases every handler still waiting (``await cleanup()``
    does so from a coroutine on the scheduler's loop without blocking
    it)."""

    def __init__(self, server: GatewayServer, httpd, thread):
        self.server = server
        self._httpd = httpd
        self._thread = thread
        self.port = httpd.server_address[1]

    def close(self) -> None:
        self.server._stopping.set()
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout=10)

    async def cleanup(self) -> None:
        await asyncio.get_running_loop().run_in_executor(None, self.close)


async def serve_gateway(
    server: GatewayServer, host: str, port: int
) -> GatewayRunner:
    """Serve ``server`` on ``host:port`` (0 = a free port). Await it on
    the loop the scheduler runs on: every handler hands its work to that
    loop."""
    server._loop = asyncio.get_running_loop()
    httpd, thread = http.start_server(server.routes(), host, port,
                                      "gateway-http")
    runner = GatewayRunner(server, httpd, thread)
    logger.info("serving gateway on %s:%d", host, runner.port)
    return runner
