"""Generation HTTP server (counterpart of ``areal_tpu/gen/server.py``),
built on the standard library: a ``ThreadingHTTPServer`` answers each
request on its own thread, and one engine thread drives admission and
decode continuously.

Routes (the reference's route table):

- ``POST /generate``: submit a request, wait for completion (or
  interruption); answers ``rid``, ``output_ids``, ``output_logprobs``,
  ``finish_reason`` and ``version``.
- ``POST /generate_stream``: the same request as server-sent events: a
  ``token_ids`` / ``logprobs`` delta per harvested chunk (one
  ``partial_outputs`` pull serves every live stream; a chunk with nothing
  new for a stream writes an SSE comment), a final frame with
  ``finish_reason`` and ``version``, then ``data: [DONE]``. An optional
  top-level ``deadline_s`` ends the stream with a ``finish_reason:
  "deadline"`` frame and cancels the request; a client that goes away
  cancels it too, freeing its slot (the server notices at the next frame
  it would write, at most a chunk or 0.5 s later).
- ``POST /pause_generation`` / ``POST /continue_generation``.
- ``POST /spec_decode`` with ``{"enabled": bool}``: toggle speculative
  decoding from the next chunk on; answers ``spec_decode`` and
  ``spec_k`` (400 without ``enabled``).
- ``POST /update_weights_from_disk``: reload the weights from an HF
  checkpoint directory (the trainer's committed export): ``model_path``,
  ``version``, ``allow_interrupt`` (pause and return running requests as
  partial outputs, or drain them with admission closed) and
  ``overlap_load`` (read and stage the weights on the device before taking
  the lock); ``draft_model_path`` reloads the draft model's weights in the
  same window (its architecture must be the serving draft's). A failed
  load leaves the engine untouched and answers ``success: false``.
- ``GET /health``, ``GET /metrics_json`` (with the device-memory
  gauges of ``base/hbm.py``).

With ``metrics_dump_path`` the ``/metrics_json`` body is also written to
that file every 10 s and at stop, so the serving side's accounting
outlives the process.

A malformed ``/generate`` body is answered 400 with the reference's error
texts. If the engine fails, every waiting and later request is answered
500 with the error; the server does not carry on without its engine.
"""

import concurrent.futures
import contextlib
import dataclasses
import functools
import json
import logging
import os
import queue
import threading
import time
from typing import Dict, Optional

from areal_tpu_torch.base import constants, faults, hbm, http, tracing
from areal_tpu_torch.base import metrics as metrics_mod
from areal_tpu_torch.gen.engine import GenerationEngine, GenOutput, GenRequest
from areal_tpu_torch.models import hf as hf_conv
from areal_tpu_torch.models import transformer as tfm
from areal_tpu_torch.ops import cuda as cuda_ops

logger = logging.getLogger("areal_tpu_torch.gen.server")


class RequestValidationError(ValueError):
    """Malformed /generate payload: answered 400, never a 500 from deep
    inside the engine."""


def parse_generate_request(
    d: dict, vocab_size: int, max_capacity: int, max_new_cap: int = 1 << 30
) -> GenRequest:
    """Validate a /generate JSON body into a GenRequest. Every reachable
    malformation is rejected here with a message naming the field."""
    if not isinstance(d, dict):
        raise RequestValidationError("body must be a JSON object")
    if "rid" not in d:
        raise RequestValidationError("missing required field 'rid'")
    ids = d.get("input_ids")
    if not isinstance(ids, (list, tuple)) or not ids:
        raise RequestValidationError(
            "'input_ids' must be a non-empty list of token ids"
        )
    try:
        ids = [int(t) for t in ids]
    except (TypeError, ValueError):
        raise RequestValidationError("'input_ids' must all be integers")
    bad = [t for t in ids if t < 0 or t >= vocab_size]
    if bad:
        raise RequestValidationError(
            f"input token {bad[0]} outside vocab [0, {vocab_size})"
        )
    sp = d.get("sampling_params", {})
    if not isinstance(sp, dict):
        raise RequestValidationError("'sampling_params' must be an object")
    try:
        max_new = int(sp.get("max_new_tokens", 256))
        min_new = int(sp.get("min_new_tokens", 0))
        temperature = float(sp.get("temperature", 1.0))
        top_p = float(sp.get("top_p", 1.0))
        top_k = int(sp.get("top_k", 1 << 30))
        greedy = bool(sp.get("greedy", False))
        stop_ids = [int(t) for t in sp.get("stop_token_ids", [])]
    except (TypeError, ValueError) as e:
        raise RequestValidationError(f"malformed sampling_params: {e}")
    if max_new < 1:
        raise RequestValidationError("max_new_tokens must be >= 1")
    if min_new < 0 or min_new > max_new:
        raise RequestValidationError(
            "min_new_tokens must be in [0, max_new_tokens]"
        )
    if temperature < 0.0:
        raise RequestValidationError("temperature must be >= 0")
    if not 0.0 < top_p <= 1.0:
        raise RequestValidationError("top_p must be in (0, 1]")
    if top_k < 1:
        raise RequestValidationError("top_k must be >= 1")
    # mirror engine.submit's admissibility check
    if len(ids) - 1 + min(max_new, max_new_cap) > max_capacity:
        raise RequestValidationError(
            f"prompt {len(ids)} + max_new_tokens {max_new} exceeds "
            f"per-slot capacity {max_capacity}"
        )
    return GenRequest(
        rid=str(d["rid"]),
        input_ids=ids,
        max_new_tokens=max_new,
        min_new_tokens=min_new,
        temperature=temperature,
        top_p=top_p,
        top_k=top_k,
        greedy=greedy,
        stop_token_ids=stop_ids,
    )


@dataclasses.dataclass
class _StreamSub:
    """One ``/generate_stream`` request: the frames' queue (filled by the
    engine thread, drained by the request's handler thread), the tokens
    already sent, and whether its final frame was taken."""

    queue: "queue.Queue"
    sent: int = 0
    finished: bool = False


# queued to every stream when the engine fails or the server stops: the
# stream ends without [DONE], and the client raises
_STREAM_FAILED = object()


def _sse(event: dict) -> bytes:
    return b"data: " + json.dumps(event).encode() + b"\n\n"


class GenerationHTTPServer:
    """``start()`` binds and starts the HTTP and engine threads and
    returns the port; ``stop()`` ends both."""

    def __init__(self, engine: GenerationEngine, decode_steps: int = 16,
                 metrics_dump_path: Optional[str] = None):
        self.engine = engine
        self.decode_steps = decode_steps
        self.metrics_dump_path = metrics_dump_path
        self._hbm = hbm.HBMMonitor(device=engine.device, tag="gen-server")
        self._futures: Dict[str, concurrent.futures.Future] = {}
        self._futures_lock = threading.Lock()
        # /generate_stream subscriptions by rid (the route registers and
        # removes them; the engine thread and pause fill their queues)
        self._streams: Dict[str, _StreamSub] = {}
        self._streams_lock = threading.Lock()
        # serializes engine.step against pause (the engine's own lock
        # would let a pause land between two halves of a serving round)
        self._step_lock = threading.Lock()
        # handlers waiting for _step_lock: the engine loop re-takes its
        # lock right after each step and a plain Lock hands over to no one
        # in particular, so a handler could wait out a whole generation;
        # the loop stands back while this is non-zero
        self._lock_waiters = 0
        self._waiters_lock = threading.Lock()
        self._stop = threading.Event()
        self._error: Optional[BaseException] = None
        self._served = 0
        self._gen_tokens = 0
        self._n_interrupted = 0
        self._n_weight_updates = 0
        self._t_step_busy = 0.0
        self._t_weight = 0.0        # inside the lock: pause/drain + swap
        self._t_weight_load = 0.0   # overlapped loads, outside the lock
        self._start = time.time()
        self._httpd = None
        self._threads = []
        self.port: Optional[int] = None

    # ------------------------------------------------------------------ #
    # lifecycle
    # ------------------------------------------------------------------ #

    def start(self, host: str = "127.0.0.1", port: int = 0) -> int:
        self._httpd, http_thread = http.start_server(
            self.routes(), host, port, "gen-http")
        engine_thread = threading.Thread(target=self._run, name="gen-engine",
                                         daemon=True)
        engine_thread.start()
        self._threads = [http_thread, engine_thread]
        self.port = self._httpd.server_address[1]
        logger.info("generation server on %s:%d", host, self.port)
        return self.port

    def stop(self):
        self._stop.set()
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
        for t in self._threads:
            t.join()
        self._fail_all(RuntimeError("server stopped"))
        if self.metrics_dump_path:
            self._dump_metrics()

    def _dump_metrics(self):
        """Write the ``/metrics_json`` body to ``metrics_dump_path``
        (atomically: a reader never sees half a file)."""
        tmp = f"{self.metrics_dump_path}.tmp"
        try:
            with open(tmp, "w") as f:
                json.dump(self.metrics_dict(), f)
            os.replace(tmp, self.metrics_dump_path)
        except OSError:
            logger.exception("could not dump gen-server metrics")

    # ------------------------------------------------------------------ #
    # engine loop
    # ------------------------------------------------------------------ #

    @contextlib.contextmanager
    def _between_steps(self):
        """Hold the step lock from a handler thread: taken after the step
        in flight ends, before the next one starts."""
        with self._waiters_lock:
            self._lock_waiters += 1
        try:
            with self._step_lock:
                yield
        finally:
            with self._waiters_lock:
                self._lock_waiters -= 1

    def _housekeeping(self):
        """The periodic metrics dump and device-memory kill check, run
        from the engine thread between steps."""
        now = time.monotonic()
        if self.metrics_dump_path and now >= self._next_dump:
            self._next_dump = now + 10.0
            self._dump_metrics()
        if now >= self._next_hbm:
            self._next_hbm = now + constants.hbm_check_secs()
            try:
                self._hbm.check()
            except hbm.HBMPressureError:
                logger.critical(
                    "device memory past kill threshold; dying for launcher "
                    "restart", exc_info=True,
                )
                os._exit(1)

    def _run(self):
        eng = self.engine
        self._next_dump = self._next_hbm = time.monotonic()
        while not self._stop.is_set():
            self._housekeeping()
            # a pipelined engine keeps stepping while a chunk is in flight:
            # its finishes are harvested one step late
            if eng.paused or (not eng.n_pending() and eng.n_running() == 0
                              and not eng.has_inflight):
                time.sleep(0.005)
                continue
            if self._lock_waiters:
                time.sleep(0.001)
                continue
            try:
                with self._step_lock:
                    t0 = time.monotonic()
                    outs = eng.step(self.decode_steps)
                    self._t_step_busy += time.monotonic() - t0
            except BaseException as e:  # noqa: BLE001 - reported to callers
                logger.exception("engine step failed; serving stops")
                self._error = e
                self._fail_all(e)
                return
            self._resolve(outs)
            self._emit_stream_partials()

    def _fail_all(self, err: BaseException):
        with self._futures_lock:
            futs, self._futures = list(self._futures.values()), {}
        for f in futs:
            if not f.done():
                f.set_exception(err)
        with self._streams_lock:
            for sub in self._streams.values():
                sub.queue.put(_STREAM_FAILED)

    def _resolve(self, outs):
        for o in outs:
            self._served += 1
            self._gen_tokens += len(o.output_ids)
            with self._futures_lock:
                fut = self._futures.pop(o.rid, None)
            if fut is not None and not fut.done():
                # the telemetry plane's activity counters, counted where
                # the answer is made (so they agree with /metrics_json);
                # a stream counts the tokens it sent when it ends
                metrics_mod.counters.add(metrics_mod.GEN_SERVED)
                metrics_mod.counters.add(metrics_mod.GEN_TOKENS,
                                         len(o.output_ids))
                fut.set_result(o)
            with self._streams_lock:
                sub = self._streams.get(o.rid)
                if sub is not None:
                    sub.queue.put({
                        "rid": o.rid,
                        "token_ids": o.output_ids[sub.sent:],
                        "logprobs": o.output_logprobs[sub.sent:],
                        "finish_reason": o.finish_reason,
                        "version": o.version,
                    })
                    sub.sent = len(o.output_ids)

    def _emit_stream_partials(self):
        """After a harvested chunk: each live stream's new tokens, from ONE
        device pull for all of them, or an SSE comment where there are
        none (a write per chunk is how the handler learns that its client
        went away)."""
        with self._streams_lock:
            if not self._streams:
                return
            rids = [r for r, sub in self._streams.items() if not sub.finished]
            partials = self.engine.partial_outputs(rids)
            for rid in rids:
                sub = self._streams[rid]
                toks, lps = partials.get(rid, ((), ()))
                if len(toks) > sub.sent:
                    sub.queue.put({
                        "rid": rid, "token_ids": toks[sub.sent:],
                        "logprobs": lps[sub.sent:], "finish_reason": None,
                    })
                    sub.sent = len(toks)
                else:
                    sub.queue.put(None)

    # ------------------------------------------------------------------ #
    # handlers: each returns (status, json body)
    # ------------------------------------------------------------------ #

    def _parse_request(self, body: bytes):
        """A generate body as ``(GenRequest, the JSON object)``; raises
        ``RequestValidationError`` naming the field."""
        try:
            d = json.loads(body)
        except (ValueError, TypeError):
            raise RequestValidationError("body is not valid JSON")
        return parse_generate_request(
            d, self.engine.cfg.vocab_size, self.engine.S, self.engine.G
        ), d

    def generate(self, body: bytes):
        if self._error is not None:
            return 500, {"error": f"engine failed: {self._error!r}"}
        try:
            req, d = self._parse_request(body)
        except RequestValidationError as e:
            return 400, {"error": str(e)}
        # join the caller's distributed trace (or root a fresh one): the
        # optional 'trace' body field is the wire context every internal
        # client attaches; this handler thread holds it for the request
        with tracing.activate(d.get("trace")), tracing.span(
                "gen_server/generate", rid=req.rid):
            fut: concurrent.futures.Future = concurrent.futures.Future()
            with self._futures_lock:
                self._futures[req.rid] = fut
            try:
                self.engine.submit(req)
            except ValueError as e:
                with self._futures_lock:
                    self._futures.pop(req.rid, None)
                return 400, {"error": str(e)}
            try:
                out: GenOutput = fut.result()
            except BaseException as e:  # noqa: BLE001 - engine failure -> 500
                return 500, {"error": f"engine failed: {e!r}"}
        return 200, {
            "rid": out.rid,
            "output_ids": out.output_ids,
            "output_logprobs": out.output_logprobs,
            "finish_reason": out.finish_reason,
            "version": out.version,
        }

    def generate_stream(self, body: bytes):
        """``/generate``'s request as an SSE stream (module docstring)."""
        if self._error is not None:
            return 500, {"error": f"engine failed: {self._error!r}"}
        try:
            req, d = self._parse_request(body)
        except RequestValidationError as e:
            return 400, {"error": str(e)}
        try:
            deadline_s = float(d.get("deadline_s", 0.0) or 0.0)
        except (TypeError, ValueError):
            return 400, {"error": "'deadline_s' must be a number"}
        deadline_t = time.monotonic() + deadline_s if deadline_s > 0 else None
        sub = _StreamSub(queue=queue.Queue())
        with self._streams_lock:
            self._streams[req.rid] = sub
        with tracing.activate(d.get("trace")):
            try:
                self.engine.submit(req)
            except ValueError as e:
                with self._streams_lock:
                    self._streams.pop(req.rid, None)
                return 400, {"error": str(e)}
        return 200, http.Stream(
            self._stream_frames(req.rid, sub, deadline_t, d.get("trace")),
            on_close=functools.partial(self._close_stream, req.rid, sub),
        )

    def _stream_frames(self, rid: str, sub: _StreamSub,
                       deadline_t: Optional[float], trace=None):
        """The stream's frames, as the engine thread queues them; a
        keep-alive comment after 0.5 s without any. The whole stream is
        one ``gen_server/generate_stream`` span in the caller's trace."""
        with tracing.activate(trace), tracing.span(
                "gen_server/generate_stream", rid=rid) as attrs:
            attrs["frames"] = attrs["tokens"] = 0
            try:
                yield from self._frames(rid, sub, deadline_t, attrs)
            except GeneratorExit:
                # closed before its end: the client went away (not a
                # server error; the close cancels the slot)
                attrs["disconnected"] = True
            finally:
                metrics_mod.counters.add(metrics_mod.GEN_SERVED)
                metrics_mod.counters.add(metrics_mod.GEN_TOKENS,
                                         attrs["tokens"])

    def _frames(self, rid: str, sub: _StreamSub,
                deadline_t: Optional[float], attrs: dict):
        while True:
            now = time.monotonic()
            if deadline_t is not None and now >= deadline_t:
                yield _sse({"rid": rid, "token_ids": [], "logprobs": [],
                            "finish_reason": "deadline"})
                yield b"data: [DONE]\n\n"
                return
            wait = 0.5 if deadline_t is None else min(0.5, deadline_t - now)
            try:
                ev = sub.queue.get(timeout=wait)
            except queue.Empty:
                yield b": keep-alive\n\n"
                continue
            if ev is _STREAM_FAILED:
                return
            if ev is None:
                yield b": chunk\n\n"
                continue
            try:
                # the serving plane's fault points: a scripted backend
                # death ends the stream without a final frame (the close
                # cancels the slot, as after a real crash mid-stream); a
                # scripted wedge stalls the frame
                faults.maybe_fail("gw.backend_die_midstream", rid=rid)
                faults.maybe_fail("gw.backend_wedge", rid=rid)
            except faults.FaultInjected:
                return
            if ev["finish_reason"]:
                # harvested by the engine: nothing left to cancel
                sub.finished = True
            yield _sse(ev)
            attrs["frames"] += 1
            attrs["tokens"] += len(ev.get("token_ids", ()))
            if sub.finished:
                yield b"data: [DONE]\n\n"
                return

    def _close_stream(self, rid: str, sub: _StreamSub):
        """The stream's end, however it came: drop the subscription and,
        unless the engine finished the request, cancel it (the client went
        away, or its deadline passed)."""
        with self._streams_lock:
            if self._streams.get(rid) is sub:
                del self._streams[rid]
        if not sub.finished:
            # between two steps: the engine thread re-takes its own lock
            # at once, so a bare cancel could wait out many chunks; and no
            # admission is under way, so the request is pending, in a
            # slot, or already finished (then there is nothing to cancel)
            with self._between_steps():
                self.engine.cancel(rid)

    def pause(self, body: bytes):
        with self._between_steps():
            interrupted = self.engine.pause()
            self._n_interrupted += len(interrupted)
            self._resolve(interrupted)
        return 200, {"num_paused_requests": len(interrupted)}

    def resume(self, body: bytes):
        self.engine.resume()
        return 200, {"success": True}

    def update_weights(self, body: bytes):
        try:
            d = json.loads(body)
            path = d["model_path"]
        except (ValueError, TypeError, KeyError) as e:
            return 400, {"error": f"malformed weight update: {e!r}"}
        # the draft rides along: the weight fanout may push refreshed draft
        # weights next to the policy's, both swapped in one pause window
        draft_path = d.get("draft_model_path")
        if draft_path and self.engine._draft is None:
            return 200, {
                "success": False,
                "message": "draft_model_path given but the engine has no "
                           "draft model configured",
                "num_paused_requests": 0,
            }
        allow_interrupt = bool(d.get("allow_interrupt", True))
        overlap_load = bool(d.get("overlap_load", True))
        params = draft_params = None
        if overlap_load:
            # read the checkpoint and stage it on the device while the
            # engine keeps decoding: the lock window then contains only
            # the pointer swap. Costs a transient 2x param residency; a
            # caller without that headroom sends overlap_load=false
            t_load0 = time.monotonic()
            try:
                params = self._load_params(path)
                if draft_path:
                    draft_params = self._load_draft_host_params(draft_path)
            except Exception as e:  # noqa: BLE001 - reported to the caller
                logger.exception("weight load failed (engine untouched)")
                return 200, {
                    "success": False,
                    "message": f"weight update failed: {e!r}",
                    "num_paused_requests": 0,
                }
            self._t_weight_load += time.monotonic() - t_load0
        with self._between_steps():
            # timer starts INSIDE the lock: waiting out an in-flight decode
            # chunk is step_busy time, not weight-swap time
            t_upd0 = time.monotonic()
            if allow_interrupt:
                interrupted = self.engine.pause()
                self._resolve(interrupted)
                num_paused = len(interrupted)
            else:
                # drain: stop admission (new requests queue as pending),
                # decode the running slots to completion
                self.engine.accepting = False
                try:
                    while self.engine.n_running() or self.engine.has_inflight:
                        self._resolve(self.engine.step(self.decode_steps))
                finally:
                    self.engine.accepting = True
                self.engine.paused = True
                num_paused = 0
            try:
                if params is None:
                    params = self._load_params(path)
                if draft_path and draft_params is None:
                    draft_params = self._load_draft_host_params(draft_path)
                self.engine.update_params(params, version=d.get("version"),
                                          draft_params=draft_params)
                ok = True
                msg = f"loaded weights from {path}"
            except Exception as e:  # noqa: BLE001 - reported to the caller
                ok = False
                msg = f"weight update failed: {e!r}"
                logger.exception("weight update failed")
            self.engine.resume()
            self._t_weight += time.monotonic() - t_upd0
        self._n_weight_updates += 1
        self._n_interrupted += num_paused
        return 200, {"success": ok, "message": msg,
                     "num_paused_requests": num_paused}

    def _load_params(self, path: str):
        """The checkpoint at ``path`` as engine params: serving dtype, on
        the engine's device. Its architecture must be the engine's: the KV
        pool and every shape were built from the engine's config."""
        cfg, host_params = hf_conv.load_hf_checkpoint(path)
        ecfg = self.engine.cfg
        for f in ("vocab_size", "n_layers", "n_q_heads", "n_kv_heads",
                  "head_dim", "hidden_dim", "intermediate_dim",
                  "tied_embedding"):
            if getattr(cfg, f) != getattr(ecfg, f):
                raise ValueError(
                    f"checkpoint {f} ({getattr(cfg, f)}) != the serving "
                    f"model's ({getattr(ecfg, f)})"
                )
        params = tfm.params_from_numpy(host_params, device=self.engine.device,
                                       dtype=ecfg.dtype)
        return self.engine.prepare_params(params)

    def _load_draft_host_params(self, path: str):
        """The draft checkpoint at ``path`` as the port's params, on the
        engine's device (the engine casts them under its lock). Its
        architecture must be the serving draft's: the draft pool and every
        program were built from ``draft_cfg``."""
        cfg, host_params = hf_conv.load_hf_checkpoint(path)
        ecfg = self.engine.draft_cfg
        for f in ("vocab_size", "n_layers", "n_q_heads", "n_kv_heads",
                  "head_dim", "hidden_dim", "intermediate_dim"):
            if getattr(cfg, f) != getattr(ecfg, f):
                raise ValueError(
                    f"draft checkpoint {f} ({getattr(cfg, f)}) != serving "
                    f"draft's ({getattr(ecfg, f)}): a draft refresh must "
                    "keep the architecture the engine was built with"
                )
        return tfm.params_from_numpy(host_params, device=self.engine.device,
                                     dtype=ecfg.dtype)

    def spec_decode(self, body: bytes):
        """Toggle speculative decoding: it takes effect at the next chunk
        dispatch (the engine reads the flag under its lock per step); a
        chunk in flight finishes as it was dispatched."""
        try:
            enabled = bool(json.loads(body)["enabled"])
        except (KeyError, TypeError, ValueError) as e:
            return 400, {"error": repr(e)}
        self.engine.spec = enabled
        return 200, {"success": True, "spec_decode": self.engine.spec,
                     "spec_k": self.engine.spec_k}

    def health(self, body: bytes):
        if self._error is not None:
            return 500, {"status": "error", "error": repr(self._error)}
        return 200, {"status": "ok"}

    def metrics_dict(self) -> dict:
        eng = self.engine
        return {
            "running": eng.n_running(),
            "pending": eng.n_pending(),
            "served": self._served,
            "gen_tokens": self._gen_tokens,
            "gen_throughput": self._gen_tokens / max(time.time() - self._start, 1e-6),
            "version": eng.version,
            "max_slots": eng.B,
            # per-slot token capacity: the gateway's prompt-size bound
            "slot_capacity": eng.S,
            "paused": bool(eng.paused),
            "pages_free": eng.pool.n_free,
            "pages_total": eng.n_pages,
            "n_pages_free": eng.pool.n_free,
            "kv_dtype": eng.kv_dtype,
            "kv_pool_bytes": eng.kv_pool_bytes(),
            "kv_pool_occupancy": round(eng.kv_pool_occupancy(), 4),
            "kv_pool_demand_occupancy": round(
                eng.kv_pool_demand_occupancy(), 4
            ),
            "prefix_pages": len(eng.prefix),
            "uptime_s": round(time.time() - self._start, 3),
            "step_busy_s": round(self._t_step_busy, 3),
            "weight_update_s": round(self._t_weight, 3),
            "weight_load_overlapped_s": round(self._t_weight_load, 3),
            "n_weight_updates": self._n_weight_updates,
            "n_interrupted": self._n_interrupted,
            # speculative decoding: config and realized accept rate (the
            # break-even signal a manager would act on via /spec_decode);
            # spec_k_current == spec_k, under the adaptive-K gauge's name
            "spec_decode": bool(eng.spec),
            "spec_k": eng.spec_k,
            "spec_k_adapt": bool(eng.spec_k_adapt),
            "spec_k_current": eng.spec_k,
            "spec_accept_rate": round(
                eng.stats["spec_accepted_tokens"]
                / max(eng.stats["spec_draft_tokens"], 1), 4
            ),
            "spec_accept_len_hist": {
                str(k): v for k, v in sorted(eng.spec_accept_hist.items())},
            "spec_q_accept_prob": (
                eng.stats["spec_q_accept_prob_sum"]
                / max(eng.stats["spec_q_accept_prob_n"], 1)),
            # draft-model spec decode: whether a draft model is configured,
            # its weight generation and its pool (its pages move in
            # lockstep with the target's, so occupancy is shared)
            "spec_draft_model": eng._draft is not None,
            "draft_version": eng.draft_version,
            "draft_kv_dtype": eng.draft_kv_dtype,
            "draft_kv_pool_bytes": eng.draft_kv_pool_bytes(),
            # fused sampling epilogue: streamed LM-head sampling on the
            # decode chunk
            "fused_sample": bool(eng.fused),
            # decode chunks: CUDA graphs captured and replayed (0 on the
            # CPU, where the chunk runs eagerly), harvest-flag fetches and
            # the fetches that had to wait for the chunk
            "pipeline_chunks": bool(eng.pipeline),
            **{k: eng.stats[k] for k in (
                "graph_captures", "graph_replays", "chunk_flag_fetches",
                "chunk_flag_blocked")},
            **{f"engine_{k}": v for k, v in eng.stats.items()},
            **self._hbm.check(kill=False),
            # this process's kernel launches, by wrapper
            "kernel_launches": cuda_ops.launch_counts(),
        }

    def metrics(self, body: bytes):
        return 200, self.metrics_dict()

    def routes(self):
        return {
            ("POST", "/generate"): self.generate,
            ("POST", "/generate_stream"): self.generate_stream,
            ("POST", "/pause_generation"): self.pause,
            ("POST", "/continue_generation"): self.resume,
            ("POST", "/spec_decode"): self.spec_decode,
            ("POST", "/update_weights_from_disk"): self.update_weights,
            ("GET", "/health"): self.health,
            ("GET", "/metrics_json"): self.metrics,
        }


def serve(engine: GenerationEngine, host: str = "127.0.0.1", port: int = 0,
          **kw) -> GenerationHTTPServer:
    """Start serving ``engine``; returns the running server (caller stops
    it). ``server.port`` is the bound port."""
    srv = GenerationHTTPServer(engine, **kw)
    srv.start(host, port)
    return srv
