"""Distributed request tracing and env-gated ``torch.profiler`` traces
(the counterpart of ``areal_tpu/base/tracing.py``).

**Profiler plane**: with ``AREAL_DUMP_TRACE=1`` every block wrapped in
:func:`maybe_trace` writes a Chrome trace (``torch.profiler``, CUDA
activity included when the process uses a card) under
``$AREAL_FILEROOT/traces/<tag>``; :func:`annotate` names a region inside it
(``torch.profiler.record_function``) and costs nothing when tracing is off.

**Span plane** (on unless ``AREAL_TRACE_SPANS=0``): every :func:`span`
carries a W3C-traceparent-style identity,

    ``00-<32-hex trace id>-<16-hex span id>-01``,

carried across processes in one ``trace`` body field on every internal
HTTP hop. Completed spans land in a bounded per-process ring, flushed as
jsonl under ``<fileroot>/trace_spans/`` (``constants.
get_trace_span_root()``); ``system/tracejoin.py`` merges every worker's
flushes into one Chrome ``trace_event`` timeline and ``apps/obs.py --trace
<rid|qid>`` renders one request's span tree. A never-drained tail of the
ring feeds the flight recorder (``system/worker_base.FlightRecorder``).

Context flows through :mod:`contextvars`: each HTTP handler thread, each
asyncio task and the engine thread hold their own trace identity. Spans
are host bookkeeping only: no device read, no synchronisation, and a span
around a CUDA graph replay times the host's dispatch of it.
"""

import collections
import contextlib
import contextvars
import json
import os
import threading
import time
import uuid
from typing import Dict, List, Optional, Tuple

from areal_tpu_torch.base import constants
from areal_tpu_torch.base import metrics as metrics_mod

# Live-span registry: every open tracing.span is visible here, so the hang
# watchdog (system/worker_base.HangWatchdog) can report WHAT a wedged worker
# was doing (e.g. "train_pipe/dispatch open for 1800s") alongside raw thread
# stacks — without any profiler attached.
_live_lock = threading.Lock()
_live: List[dict] = []

# Completed-span ring: bounded (AREAL_TRACE_RING), drained by flush().
_ring_lock = threading.Lock()
_ring: collections.deque = collections.deque()
# Recent span ends for the flight recorder — NEVER drained by flush(), so
# a crash dump still has span evidence right after a telemetry publish.
_RECENT_CAP = 256
_recent: collections.deque = collections.deque(maxlen=_RECENT_CAP)

# The active trace context for this task/thread: (trace_id, span_id).
# span_id may be "" at a fresh root (no span opened yet).
_ctx: contextvars.ContextVar = contextvars.ContextVar(
    "areal_trace_ctx", default=None
)
# The RL query id riding the active context (joins the breaker's
# last_failure_reason qid against trace ids; docs/serving.md).
_qid: contextvars.ContextVar = contextvars.ContextVar(
    "areal_trace_qid", default=None
)

_flush_lock = threading.Lock()


def live_spans() -> List[Dict[str, object]]:
    """Snapshot of currently-open spans: name, seconds open, thread name.
    Oldest first (the outermost wedged span is the interesting one)."""
    now = time.perf_counter()
    with _live_lock:
        return [
            {
                "name": r["name"],
                "elapsed_s": now - r["t0"],
                "thread": r["thread"],
            }
            for r in _live
        ]


def trace_enabled() -> bool:
    return constants.trace_enabled()


def trace_dir(tag: str) -> str:
    return os.path.join(constants.trace_root(), "traces", tag)


_profiling = threading.Event()  # a maybe_trace block is recording


@contextlib.contextmanager
def maybe_trace(tag: str):
    """Record the block with ``torch.profiler`` when ``AREAL_DUMP_TRACE``
    is set and write it as a Chrome trace under ``traces/<tag>``. CUDA
    activity is recorded when this process has initialised a card; the
    card is synchronised before the profiler stops, so the kernels the
    block launched are in the trace. A block nested in another records
    into the outer one. Yields the trace file's path (None when off)."""
    if not trace_enabled() or _profiling.is_set():
        yield None
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    d = trace_dir(tag)
    os.makedirs(d, exist_ok=True)
    cuda = torch.cuda.is_available() and torch.cuda.is_initialized()
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    path = os.path.join(
        d, f"{os.getpid()}.{int(time.time() * 1e3)}.pt.trace.json")
    _profiling.set()
    try:
        with profile(activities=acts) as prof:
            yield path
            if cuda:
                torch.cuda.synchronize()
    finally:
        _profiling.clear()
    prof.export_chrome_trace(path)


def trace_step() -> int:
    """Which training step the trainers trace (tracing every step would
    grow without bound; the reference traces a fixed early step)."""
    return constants.trace_step()


@contextlib.contextmanager
def annotate(name: str):
    """Named region inside an active trace (per-MFC attribution in the
    executor): ``torch.profiler.record_function``; free when no trace is
    being collected."""
    if not trace_enabled():
        yield
        return
    import torch

    with torch.profiler.record_function(name):
        yield


# --------------------------------------------------------------------- #
# Trace identity + context propagation
# --------------------------------------------------------------------- #


def spans_enabled() -> bool:
    return constants.trace_spans_enabled()


def new_trace_id() -> str:
    return uuid.uuid4().hex


def new_span_id() -> str:
    return uuid.uuid4().hex[:16]


def current() -> Optional[Dict[str, str]]:
    """The active context as ``{"trace_id", "span_id"}``, or None."""
    c = _ctx.get()
    if c is None:
        return None
    return {"trace_id": c[0], "span_id": c[1]}


def current_qid() -> Optional[str]:
    """The RL qid riding the active context (None outside RL hops)."""
    return _qid.get()


def traceparent() -> Optional[str]:
    """W3C-style header value for the active context, or None. A root
    context with no span open yet carries the all-zero parent span id —
    the receiving side treats it as "same trace, no parent span"."""
    c = _ctx.get()
    if c is None:
        return None
    return f"00-{c[0]}-{c[1] or '0' * 16}-01"


def parse_traceparent(value) -> Optional[Tuple[str, Optional[str]]]:
    """``(trace_id, parent_span_id)`` from a traceparent string; tolerant
    — anything malformed degrades to None (a trace must never break a
    request). The all-zero span id maps to parent None."""
    if not isinstance(value, str):
        return None
    parts = value.strip().split("-")
    if len(parts) != 4:
        return None
    _ver, tid, sid, _flags = parts
    try:
        int(tid, 16), int(sid, 16)
    except ValueError:
        return None
    if len(tid) != 32 or len(sid) != 16:
        return None
    return tid, (None if sid == "0" * 16 else sid)


def wire_context(qid: Optional[str] = None) -> Optional[dict]:
    """Client side of a hop: the single ``trace`` body field internal
    HTTP clients attach — ``{"traceparent": ..., "qid": ...}`` (qid only
    when one rides the context). None when the span plane is off or no
    context is active, so the field is simply absent from the payload."""
    if not spans_enabled():
        return None
    tp = traceparent()
    q = qid if qid is not None else _qid.get()
    if tp is None and q is None:
        return None
    out: Dict[str, object] = {"traceparent": tp}
    if q is not None:
        out["qid"] = q
    return out


@contextlib.contextmanager
def activate(
    wire=None,
    trace_id: Optional[str] = None,
    parent_span_id: Optional[str] = None,
    qid: Optional[str] = None,
):
    """Activate a trace context for the current task/thread.

    Server side of a hop: pass the request's ``trace`` body field (dict)
    or ``traceparent`` header (str) as ``wire`` — malformed/absent wire
    context degrades to rooting a NEW trace. Root side (gateway intake,
    rollout worker): pass nothing and a fresh trace id is minted. Yields
    the active trace id."""
    if not spans_enabled():
        yield None
        return
    q = qid
    if isinstance(wire, dict):
        parsed = parse_traceparent(wire.get("traceparent"))
        if q is None and wire.get("qid") is not None:
            q = str(wire["qid"])
    else:
        parsed = parse_traceparent(wire)
    if parsed is not None:
        tid, psid = parsed
    else:
        tid, psid = trace_id or new_trace_id(), parent_span_id
    tok = _ctx.set((tid, psid or ""))
    qtok = _qid.set(q) if q is not None else None
    try:
        yield tid
    finally:
        _ctx.reset(tok)
        if qtok is not None:
            _qid.reset(qtok)


# --------------------------------------------------------------------- #
# Spans
# --------------------------------------------------------------------- #


def _record_end(
    rec: dict, wall_end: float, dur: float, exc: Optional[BaseException],
    attrs: Dict[str, object],
) -> None:
    out = {
        "name": rec["name"],
        "trace_id": rec["trace_id"],
        "span_id": rec["span_id"],
        "parent_id": rec["parent_id"],
        "start": wall_end - dur,
        "dur_s": dur,
        "thread": rec["thread"],
        "pid": os.getpid(),
        "error": exc is not None,
    }
    if exc is not None:
        out["exc"] = type(exc).__name__
    if attrs:
        out["attrs"] = attrs
    cap = constants.trace_ring_size()
    with _ring_lock:
        while len(_ring) >= cap:
            _ring.popleft()
            metrics_mod.counters.add(metrics_mod.TRACE_DROPPED)
        _ring.append(out)
    _recent.append(out)
    metrics_mod.counters.add(metrics_mod.TRACE_SPANS)
    if exc is not None:
        metrics_mod.counters.add(metrics_mod.TRACE_SPAN_ERRORS)
    metrics_mod.counters.observe(metrics_mod.TRACE_SPAN_S, dur)


@contextlib.contextmanager
def span(name: str, **attrs):
    """Data-plane span: always accumulates host wall time into
    ``metrics.counters`` under ``<name>_s`` (plus a ``<name>_n`` call
    count), and additionally shows up as a named region when a profiler
    trace is active (a ``time.perf_counter`` pair is ~100 ns — free
    against any stage it wraps).

    With the span plane on (default), the span also joins the active
    distributed trace — child of the context's current span, or the root
    of a fresh trace — and its completion is recorded into the bounded
    ring *including exception exits*: a span whose body raises is
    stamped ``error=True`` with the exception type, never lost. Keyword
    ``attrs`` (plus any riding qid) land in the record for tracejoin /
    obs ``--trace`` to render. Yields the mutable attrs dict so a body
    can add attributes discovered mid-span."""
    enabled = spans_enabled()
    if not enabled and not trace_enabled():
        # counters-only fast path (AREAL_TRACE_SPANS=0, no profiler trace
        # active): a clock read and two counter adds, no live-span
        # registration, no ring record
        t0 = time.perf_counter()
        try:
            yield attrs
        finally:
            dt = time.perf_counter() - t0
            metrics_mod.counters.add(f"{name}_s", dt)
            metrics_mod.counters.add(f"{name}_n", 1.0)
        return
    t0 = time.perf_counter()
    rec = {
        "name": name, "t0": t0, "thread": threading.current_thread().name,
    }
    ctx_tok = None
    if enabled:
        c = _ctx.get()
        rec["trace_id"] = c[0] if c else new_trace_id()
        rec["parent_id"] = (c[1] or None) if c else None
        rec["span_id"] = new_span_id()
        ctx_tok = _ctx.set((rec["trace_id"], rec["span_id"]))
        q = _qid.get()
        if q is not None:
            attrs.setdefault("qid", q)
    with _live_lock:
        _live.append(rec)
    exc: Optional[BaseException] = None
    try:
        with annotate(name):
            yield attrs
    except BaseException as e:  # noqa: BLE001 — stamped + re-raised
        exc = e
        raise
    finally:
        with _live_lock:
            try:
                _live.remove(rec)
            except ValueError:
                pass
        if ctx_tok is not None:
            _ctx.reset(ctx_tok)
        dt = time.perf_counter() - t0
        metrics_mod.counters.add(f"{name}_s", dt)
        metrics_mod.counters.add(f"{name}_n", 1.0)
        if enabled:
            _record_end(rec, time.time(), dt, exc, attrs)


# --------------------------------------------------------------------- #
# Ring drain / fileroot flush
# --------------------------------------------------------------------- #


def drain() -> List[dict]:
    """Take every completed span out of the ring (oldest first)."""
    with _ring_lock:
        out = list(_ring)
        _ring.clear()
    return out


def recent_spans(n: int = _RECENT_CAP) -> List[dict]:
    """The last ``n`` completed spans — survives flushes (the flight
    recorder's span evidence)."""
    return list(_recent)[-n:]


def _flush_path(worker_name: str, root: Optional[str] = None) -> str:
    safe = worker_name.replace("/", "_").replace(os.sep, "_") or "worker"
    return os.path.join(
        root or constants.get_trace_span_root(), f"{safe}.jsonl"
    )


def flush(worker_name: str, root: Optional[str] = None) -> int:
    """Drain the ring and append the spans, stamped with this worker's
    identity, to ``<fileroot>/trace_spans/<worker>.jsonl``. Returns the
    span count written. Rides the telemetry exporter's publish cadence
    (plus worker stop); ``AREAL_TRACE_FLUSH_S`` adds a dedicated thread
    for workers that don't export telemetry."""
    spans = drain()
    if not spans:
        return 0
    path = _flush_path(worker_name, root)
    with _flush_lock:
        with open(path, "a") as f:
            for s in spans:
                f.write(json.dumps({"worker": worker_name, **s}) + "\n")
    metrics_mod.counters.add(metrics_mod.TRACE_FLUSHES)
    metrics_mod.counters.add(metrics_mod.TRACE_FLUSHED_SPANS, len(spans))
    return len(spans)


class SpanFlusher(threading.Thread):
    """Dedicated background flusher for workers without a telemetry
    exporter — started by :meth:`maybe_start` only when
    ``AREAL_TRACE_FLUSH_S`` > 0."""

    def __init__(self, worker_name: str, interval_s: float):
        super().__init__(name=f"span-flush-{worker_name}", daemon=True)
        self.worker_name = worker_name
        self.interval_s = interval_s
        # not named _stop: threading.Thread's join() internals call a
        # private _stop() method that an Event attribute would shadow
        self._stop_ev = threading.Event()

    @classmethod
    def maybe_start(cls, worker_name: str) -> Optional["SpanFlusher"]:
        interval = constants.trace_flush_interval()
        if interval <= 0 or not spans_enabled():
            return None
        t = cls(worker_name, interval)
        t.start()
        return t

    def run(self) -> None:
        while not self._stop_ev.wait(self.interval_s):
            flush(self.worker_name)

    def stop(self) -> None:
        self._stop_ev.set()
        if self.is_alive():
            self.join(timeout=5)
        flush(self.worker_name)  # final drain: no span left behind
