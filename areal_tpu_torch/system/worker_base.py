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

The flight recorder and the telemetry exporter wait for the telemetry
twin; where the reference dumps the flight recorder, the port logs.
"""

import logging
import os
import signal as signal_mod
import sys
import threading
import time
import traceback
from typing import Callable, Optional

from areal_tpu_torch.base import constants, name_resolve, names

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
                "installed (should_stop still honors request())"
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
        if self.requested_at is None:
            self.requested_at = time.monotonic()
        self._event.set()

    def should_stop(self) -> bool:
        return self._event.is_set()

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
    ``timeout_s``, logs every thread's stack. With ``AREAL_WATCHDOG_ABORT``
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
        logger.error("\n".join(lines))
        self.dumps += 1
        if self._on_dump is not None:
            self._on_dump(stalled)
