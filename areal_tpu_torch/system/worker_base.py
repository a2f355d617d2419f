"""Worker lifecycle: experiment death watch, heartbeats, graceful
preemption and a hang watchdog (the part of
``areal_tpu/system/worker_base.py`` the trainer and the launcher use).

The launcher owns the lifecycle: it marks the experiment RUNNING at spawn
and STOPPED at teardown (``mark_experiment_running`` / ``_stopped``).
Every long-running worker polls the trial's ``experiment_status`` key
through :class:`ExperimentStatusWatch` and exits when the experiment is no
longer alive, so a crashed launcher never leaves servers or rollout
workers spinning; workers may publish ``worker_status/<name>`` heartbeats.

- :class:`GracefulShutdown` turns SIGTERM / SIGINT into a flag the train
  loop polls; the trainer commits a recover checkpoint within the
  deadline and exits :data:`EXIT_PREEMPTED`, which the launcher maps to
  "preempted, restart the world" rather than a crash.
- :class:`HangWatchdog` is a heartbeat bumped once per step plus a thread
  that, past a threshold, logs every thread's stack (and, with
  ``AREAL_WATCHDOG_ABORT``, exits :data:`EXIT_WATCHDOG`).

- :class:`TelemetryExporter` publishes the worker's counter snapshot
  through name_resolve every ``AREAL_TELEMETRY_EXPORT`` seconds and
  flushes its span ring with each publish (``system/telemetry.py``).
- :class:`FlightRecorder` keeps recent span ends, counter deltas and a
  log tail, and dumps them atomically to ``<fileroot>/flight/`` on a
  watchdog trip, a preemption, a train-guard rollback or an unhandled
  crash (:func:`flight_dump`).
"""

import collections
import json
import logging
import os
import signal as signal_mod
import sys
import threading
import time
import traceback
from typing import Callable, Optional

from areal_tpu_torch.base import constants, faults, name_resolve, names
from areal_tpu_torch.base import logging as port_logging
from areal_tpu_torch.base import metrics as metrics_mod
from areal_tpu_torch.base import tracing

logger = logging.getLogger("areal_tpu_torch.worker_base")

STATUS_RUNNING = "running"
STATUS_STOPPED = "stopped"

# A worker exits when the status key has been absent / not RUNNING for
# this long (grace for launcher start-up races and slow shared filesystems).
DEFAULT_DEATH_TIMEOUT = 300.0

# Distinct trainer exit codes the launcher switches on. 75 = EX_TEMPFAIL:
# a committed recover checkpoint was saved and a restart resumes it. 76:
# the watchdog killed a hung worker. 77: an elastic trainer rank failed
# beyond surgical recovery (the elastic path is not ported yet).
EXIT_PREEMPTED = 75
EXIT_WATCHDOG = 76
EXIT_WORLD_FAILED = 77


def mark_experiment_running(experiment_name: str, trial_name: str):
    name_resolve.add(
        names.experiment_status(experiment_name, trial_name),
        STATUS_RUNNING,
        replace=True,
    )


def mark_experiment_stopped(experiment_name: str, trial_name: str):
    name_resolve.add(
        names.experiment_status(experiment_name, trial_name),
        STATUS_STOPPED,
        replace=True,
    )


def experiment_stopped(experiment_name: str, trial_name: str) -> bool:
    """Whether the launcher has marked the experiment STOPPED (read now,
    not through a watch's poll interval)."""
    try:
        return name_resolve.get(
            names.experiment_status(experiment_name, trial_name)
        ) == STATUS_STOPPED
    except name_resolve.NameEntryNotFoundError:
        return False


class ExperimentStatusWatch:
    """Polls ``experiment_status``; ``alive()`` goes False once the key
    reads STOPPED (at once) or has been missing for ``timeout`` seconds
    (workers that start before the launcher writes the key do not bail)."""

    def __init__(
        self,
        experiment_name: str,
        trial_name: str,
        timeout: float = DEFAULT_DEATH_TIMEOUT,
        poll_interval: float = 2.0,
    ):
        self.key = names.experiment_status(experiment_name, trial_name)
        self.timeout = timeout
        self.poll_interval = poll_interval
        self._last_seen = time.monotonic()
        self._last_poll = 0.0
        self._stopped = False

    def alive(self) -> bool:
        now = time.monotonic()
        if self._stopped:
            return False
        if now - self._last_poll < self.poll_interval:
            return True
        self._last_poll = now
        try:
            status = name_resolve.get(self.key)
        except name_resolve.NameEntryNotFoundError:
            status = None
        if status == STATUS_RUNNING:
            self._last_seen = now
            return True
        if status == STATUS_STOPPED:
            logger.info("experiment marked stopped; shutting down")
            self._stopped = True
            return False
        if now - self._last_seen > self.timeout:
            logger.warning(
                "experiment_status missing for %.0fs (> %.0fs); assuming the "
                "experiment died; shutting down",
                now - self._last_seen, self.timeout,
            )
            self._stopped = True
            return False
        return True


class Heartbeat:
    """Background thread publishing ``worker_status/<name>`` timestamps."""

    def __init__(
        self,
        experiment_name: str,
        trial_name: str,
        worker_name: str,
        interval: float = 30.0,
    ):
        self.key = names.worker_status(experiment_name, trial_name, worker_name)
        self.interval = interval
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def _beat(self):
        while not self._stop.is_set():
            try:
                name_resolve.add(self.key, str(time.time()), replace=True)
            except Exception:
                logger.exception("heartbeat write failed")
            self._stop.wait(self.interval)

    def start(self):
        self._thread = threading.Thread(target=self._beat, daemon=True)
        self._thread.start()
        return self

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)


def last_heartbeat(
    experiment_name: str, trial_name: str, worker_name: str
) -> Optional[float]:
    """Unix time of the worker's last beat, or None if never seen."""
    try:
        return float(
            name_resolve.get(
                names.worker_status(experiment_name, trial_name, worker_name)
            )
        )
    except (name_resolve.NameEntryNotFoundError, ValueError):
        return None


# --------------------------------------------------------------------- #
# telemetry
# --------------------------------------------------------------------- #


class TelemetryExporter:
    """Background thread publishing this worker's full telemetry snapshot
    (counters + histograms + open spans + role gauges) through name_resolve
    next to the heartbeat, every ``interval`` seconds.

    Gated by ``AREAL_TELEMETRY_EXPORT`` (``constants.
    telemetry_export_interval``): when the knob is off (the default),
    :meth:`maybe_start` is a no-op — no thread, no snapshot building, zero
    overhead. ``stop()`` publishes one final snapshot so the last state of
    a cleanly-exiting worker is visible to the aggregator/ops CLI.

    ``step_fn`` reports the worker's notion of progress (train step,
    pushed count, ...); ``gauges_fn`` returns instantaneous role gauges
    (queue depth, running rollouts, HBM bytes); ``server_states_fn``
    (manager only) returns per-gen-server breaker states. All three are
    called on the exporter thread and must be cheap and exception-safe —
    a failing callback degrades to a snapshot without that section.
    """

    def __init__(
        self,
        experiment_name: str,
        trial_name: str,
        worker_name: str,
        role: str,
        interval: Optional[float] = None,
        step_fn: Optional[Callable[[], int]] = None,
        gauges_fn: Optional[Callable[[], dict]] = None,
        server_states_fn: Optional[Callable[[], dict]] = None,
        registry=None,
    ):
        self.experiment_name = experiment_name
        self.trial_name = trial_name
        self.worker_name = worker_name
        self.role = role
        self.interval = (
            interval
            if interval is not None
            else constants.telemetry_export_interval()
        )
        self._step_fn = step_fn
        self._gauges_fn = gauges_fn
        self._server_states_fn = server_states_fn
        self._registry = registry
        self.published = 0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    @property
    def enabled(self) -> bool:
        return self.interval > 0

    def _call(self, fn, default):
        if fn is None:
            return default
        try:
            return fn()
        except Exception:
            logger.warning(
                "telemetry %s callback failed", self.worker_name,
                exc_info=True,
            )
            return default

    def publish_once(self) -> dict:
        from areal_tpu_torch.system import telemetry

        snap = telemetry.build_snapshot(
            self.worker_name,
            self.role,
            step=int(self._call(self._step_fn, 0) or 0),
            registry=self._registry,
            gauges=self._call(self._gauges_fn, {}),
            server_states=self._call(self._server_states_fn, None),
        )
        telemetry.publish_snapshot(
            self.experiment_name, self.trial_name, snap
        )
        self.published += 1
        # The span ring rides the telemetry cadence: each publish also
        # flushes completed distributed-tracing spans through the fileroot
        # (tracejoin merges them across workers). Failure never breaks the
        # snapshot publish.
        if tracing.spans_enabled():
            try:
                tracing.flush(self.worker_name)
            except Exception:
                logger.warning(
                    "span flush %s failed", self.worker_name, exc_info=True
                )
        return snap

    def _loop(self):
        while True:
            try:
                self.publish_once()
            except Exception:
                logger.warning("telemetry publish failed", exc_info=True)
            if self._stop.wait(self.interval):
                return

    def maybe_start(self) -> "TelemetryExporter":
        """Start the export thread iff the knob enables it (no-op
        otherwise) — callers wire it unconditionally next to Heartbeat."""
        if self.enabled and self._thread is None:
            self._thread = threading.Thread(
                target=self._loop,
                name=f"telemetry:{self.worker_name}",
                daemon=True,
            )
            self._thread.start()
        return self

    def stop(self):
        if self._thread is None:
            return
        self._stop.set()
        self._thread.join(timeout=5)
        self._thread = None
        try:
            # final flush: counters bumped since the last tick (e.g. the
            # trainer's last-step histograms) must reach the aggregator
            self.publish_once()
        except Exception:
            logger.warning("final telemetry publish failed", exc_info=True)


# --------------------------------------------------------------------- #
# crash flight recorder
# --------------------------------------------------------------------- #


class _LogTail(logging.Handler):
    """Root-logger handler keeping the last N formatted log lines in a
    bounded deque — the flight recorder's log-tail evidence."""

    def __init__(self, capacity: int):
        super().__init__()
        self.lines: collections.deque = collections.deque(
            maxlen=max(1, capacity)
        )
        self.setFormatter(
            logging.Formatter("%(asctime)s %(levelname)s %(name)s: %(message)s")
        )

    def emit(self, record):
        try:
            self.lines.append(self.format(record))
        except Exception:  # a log record must never crash the worker
            pass


class FlightRecorder:
    """Black box for a dying worker: on watchdog trip, train-guard
    rollback, SIGTERM preemption, or unhandled crash, :meth:`dump` writes
    one atomic JSON file to ``<fileroot>/flight/`` holding

    - the most recent completed span ends (``tracing.recent_spans`` — a
      ring the telemetry flush never drains),
    - the spans still open at death (``tracing.live_spans``),
    - counter deltas since the recorder was installed,
    - the tail of the worker's log (``AREAL_TRACE_LOG_TAIL`` lines).

    :meth:`install` registers the module-level recorder so any layer can
    trigger a dump via :func:`flight_dump` without plumbing, attaches the
    log-tail handler, and chains ``sys.excepthook`` so an unhandled
    exception dumps before the traceback prints. Dumping is best-effort
    and exception-safe — a failing dump logs, never masks the original
    fault.
    """

    def __init__(
        self,
        worker_name: str,
        root: Optional[str] = None,
        span_tail: int = 128,
        log_tail: Optional[int] = None,
        registry=None,
    ):
        self.worker_name = worker_name
        self._root = root
        self.span_tail = span_tail
        self._registry = (
            registry if registry is not None else metrics_mod.counters
        )
        self._counters0 = self._registry.snapshot()
        self._log = _LogTail(
            log_tail if log_tail is not None else constants.trace_log_tail()
        )
        self._lock = threading.Lock()
        self._seq = 0
        self._prev_excepthook = None
        self.dumps = 0

    # -- lifecycle ---------------------------------------------------- #

    def install(self) -> "FlightRecorder":
        global _flight
        # the root logger, and the port's own root (which does not
        # propagate: ``base/logging.py``)
        for lg in self._loggers():
            lg.addHandler(self._log)
        self._prev_excepthook = sys.excepthook
        sys.excepthook = self._excepthook
        _flight = self
        return self

    @staticmethod
    def _loggers():
        return (logging.getLogger(), logging.getLogger(port_logging.ROOT))

    def uninstall(self):
        global _flight
        for lg in self._loggers():
            lg.removeHandler(self._log)
        if self._prev_excepthook is not None:
            sys.excepthook = self._prev_excepthook
            self._prev_excepthook = None
        if _flight is self:
            _flight = None

    def _excepthook(self, exc_type, exc, tb):
        try:
            self.dump(
                "crash",
                extra={
                    "exc": exc_type.__name__,
                    "traceback": traceback.format_exception(
                        exc_type, exc, tb
                    ),
                },
            )
        finally:
            (self._prev_excepthook or sys.__excepthook__)(exc_type, exc, tb)

    # -- dumping ------------------------------------------------------ #

    def _payload(self, reason: str, extra: Optional[dict]) -> dict:
        return {
            "schema": 1,
            "worker": self.worker_name,
            "pid": os.getpid(),
            "reason": reason,
            "time": time.time(),
            "spans": tracing.recent_spans(self.span_tail),
            "open_spans": tracing.live_spans(),
            "counters": self._registry.delta(self._counters0),
            "log_tail": list(self._log.lines),
            "extra": extra or {},
        }

    def dump(self, reason: str, extra: Optional[dict] = None) -> Optional[str]:
        """Write one flight dump; returns its path (None on failure)."""
        try:
            payload = self._payload(reason, extra)
            root = self._root or constants.get_flight_root()
            os.makedirs(root, exist_ok=True)
            safe = self.worker_name.replace("/", "_") or "worker"
            with self._lock:
                self._seq += 1
                seq = self._seq
            path = os.path.join(
                root, f"{safe}-{os.getpid()}-{seq:03d}-{reason}.json"
            )
            tmp = f"{path}.tmp"
            with open(tmp, "w") as f:
                json.dump(payload, f)
            os.replace(tmp, path)  # atomic: a watcher never reads torn JSON
            self.dumps += 1
            metrics_mod.counters.add(metrics_mod.TRACE_FLIGHT_DUMPS)
            logger.error(
                "flight recorder: dumped %s (%d span(s), %d log line(s))",
                path, len(payload["spans"]), len(payload["log_tail"]),
            )
            return path
        except Exception:
            logger.warning("flight dump (%s) failed", reason, exc_info=True)
            return None


# The installed recorder (one per process); flight_dump() is the trigger
# any layer (watchdog, preemption, train guard) calls without plumbing, a
# no-op until a worker installs a recorder.
_flight: Optional[FlightRecorder] = None


def flight_recorder() -> Optional[FlightRecorder]:
    return _flight


def flight_dump(reason: str, extra: Optional[dict] = None) -> Optional[str]:
    """Dump the installed flight recorder (None / no-op when absent)."""
    if _flight is None:
        return None
    return _flight.dump(reason, extra)


# --------------------------------------------------------------------- #
# preemption
# --------------------------------------------------------------------- #


def watchdog_timeout_from_env() -> Optional[float]:
    """``AREAL_WATCHDOG_TIMEOUT_S`` as a timeout, or None (disabled)."""
    timeout = constants.env_float(constants.WATCHDOG_TIMEOUT_ENV, 0.0)
    return timeout if timeout > 0 else None


class GracefulShutdown:
    """SIGTERM / SIGINT -> a graceful-stop request with a save deadline.

    The train loop polls :meth:`should_stop` once per step and, when set,
    saves a committed recover checkpoint, republishes ``model_version``
    and exits :data:`EXIT_PREEMPTED`. Handlers only install on the main
    thread (Python's rule); other threads can still call :meth:`request`.
    The ``signal.term`` fault point scripts a delivery without process
    machinery.
    """

    def __init__(self, deadline_s: float = 60.0, install: bool = True):
        self.deadline_s = deadline_s
        self.requested_at: Optional[float] = None
        self._event = threading.Event()
        self._prev = {}
        if install:
            self.install()

    @classmethod
    def from_env(cls, install: bool = True) -> "GracefulShutdown":
        return cls(
            deadline_s=constants.env_float(constants.PREEMPT_DEADLINE_ENV, 60.0),
            install=install,
        )

    def install(self, sigs=(signal_mod.SIGTERM, signal_mod.SIGINT)):
        try:
            for s in sigs:
                self._prev[s] = signal_mod.signal(s, self._on_signal)
        except ValueError:
            logger.warning(
                "not on the main thread; preemption signal handlers not "
                "installed (should_stop still honors request()/faults)"
            )
        return self

    def uninstall(self):
        for s, h in self._prev.items():
            signal_mod.signal(s, h)
        self._prev = {}

    def _on_signal(self, signum, frame):
        logger.warning(
            "received signal %d: graceful stop requested (%.0fs deadline "
            "to commit a recover checkpoint)", signum, self.deadline_s,
        )
        self.request()

    def request(self):
        first = self.requested_at is None
        if first:
            self.requested_at = time.monotonic()
        self._event.set()
        if first:
            # preemption evidence: what the worker was doing when it was
            # told to stop (a real SIGTERM and the signal.term point alike);
            # the trainer counts ft/preemptions when it honours the request
            flight_dump("preempt", {"deadline_s": self.deadline_s})

    def should_stop(self) -> bool:
        if self._event.is_set():
            return True
        if faults.maybe_trip("signal.term"):
            self.request()
            return True
        return False

    def remaining(self) -> float:
        """Seconds left of the save deadline (inf before any request)."""
        if self.requested_at is None:
            return float("inf")
        return max(
            self.deadline_s - (time.monotonic() - self.requested_at), 0.0
        )


# --------------------------------------------------------------------- #
# watchdog
# --------------------------------------------------------------------- #


class HangWatchdog:
    """Detects a wedged worker: a monotonic heartbeat (:meth:`bump`, once
    per step) plus a daemon thread that, once the heartbeat goes stale past
    ``timeout_s``, logs every thread's stack and the open ``tracing.span``
    registry and dumps the flight recorder. With ``AREAL_WATCHDOG_ABORT``
    set it also exits :data:`EXIT_WATCHDOG` (``os._exit``: a hung device
    call ignores graceful teardown) so the scheduler restarts the world.
    """

    def __init__(
        self,
        name: str = "trainer",
        timeout_s: float = 600.0,
        poll_interval: Optional[float] = None,
        on_dump: Optional[Callable[[float], None]] = None,
    ):
        self.name = name
        self.timeout_s = timeout_s
        self.poll_interval = (
            poll_interval
            if poll_interval is not None
            else min(max(timeout_s / 4.0, 0.05), 30.0)
        )
        self.dumps = 0
        self._on_dump = on_dump  # test hook
        self._last = time.monotonic()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def bump(self):
        """Mark liveness: call once per step of the guarded loop."""
        self._last = time.monotonic()

    def start(self):
        self._thread = threading.Thread(
            target=self._watch, name=f"watchdog:{self.name}", daemon=True
        )
        self._thread.start()
        return self

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)

    def _watch(self):
        while not self._stop.wait(self.poll_interval):
            stalled = time.monotonic() - self._last
            if stalled <= self.timeout_s:
                continue
            self._dump(stalled)
            # re-arm: at most one dump per stalled window
            self._last = time.monotonic()
            if constants.watchdog_abort_enabled():
                logger.error(
                    "watchdog[%s]: aborting (exit %d) so the scheduler "
                    "restarts the world", self.name, EXIT_WATCHDOG,
                )
                os._exit(EXIT_WATCHDOG)

    def _dump(self, stalled: float):
        lines = [
            f"watchdog[{self.name}]: no heartbeat for {stalled:.1f}s "
            f"(threshold {self.timeout_s:.1f}s); thread stacks follow"
        ]
        thread_names = {t.ident: t.name for t in threading.enumerate()}
        for tid, frame in sys._current_frames().items():
            lines.append(
                f"--- thread {thread_names.get(tid, '?')} (id {tid}) ---"
            )
            lines.extend(l.rstrip() for l in traceback.format_stack(frame))
        spans = tracing.live_spans()
        if spans:
            lines.append("--- open tracing spans ---")
            for s in spans:
                lines.append(
                    f"{s['name']}: open {s['elapsed_s']:.1f}s "
                    f"(thread {s['thread']})"
                )
        logger.error("\n".join(lines))
        self.dumps += 1
        metrics_mod.counters.add(metrics_mod.GUARD_WATCHDOG_DUMPS)
        flight_dump(
            "watchdog",
            {"stalled_s": stalled, "timeout_s": self.timeout_s},
        )
        if self._on_dump is not None:
            self._on_dump(stalled)
