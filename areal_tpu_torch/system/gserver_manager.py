"""Generation-fleet manager: request router, staleness gate and weight
updates (the counterpart of ``areal_tpu/system/gserver_manager.py``), served
over the standard library.

- **Routing** (``/schedule_request``): round-robin / least-requests /
  least-token-usage, sticky per qid so the samples of one prompt share a
  server and its prefix cache; a chunk re-scheduled at the version it was
  routed under goes back to the same server (``previous_server_url``).
- **Staleness gate** (``/allocate_rollout``, ``is_staled``): with
  ``expected_version = (training_samples + running) // train_batch_size``,
  a rollout is denied when ``expected_version > max_head_offpolicyness +
  version`` or when ``running >= max_concurrent_rollouts``. ``running``
  and ``training_samples`` count prompt groups.
- **Weight sync**: a poll loop reads the trainer's ``model_version`` key
  (``"<version>:<path>"``) and fans ``/update_weights_from_disk`` out to
  every healthy server. The version advances even when some servers fail;
  those are evicted and a probe loop re-admits them after a catch-up load.
  Superseded checkpoint dirs are pruned once every healthy server acked a
  newer version. Unlike the reference, a snapshot the manager skipped
  (the trainer announced ``v<n+1>`` before the poll read ``v<n>``) joins
  that pruning order by its version when the manager moves past it: it
  sits beside the announced one under the trainer's ``v<version>`` naming
  and no server holds it, so the newest ``n_checkpoints_to_keep``
  snapshots stay whichever the poll happened to read. The reference never
  deletes a skipped dir.

Threads: every route runs on an HTTP thread of its own and serializes on
one ``threading.Lock``, the scope of the reference's ``asyncio.Lock``; the
weight fan-out awaits OUTSIDE it, so allocation and routing continue
during a reload. The poll and probe loops run on one event loop in a
background thread (``start`` / ``stop``). The reference's tracing spans,
fault-injection points and process-global metric counters are not ported:
what a route or a test reads lives in ``rollout_stat`` and ``counters``.
"""

import asyncio
import dataclasses
import logging
import os
import threading
import time
from collections import defaultdict
from typing import Dict, List, Optional

from areal_tpu_torch.base import http, name_resolve, names, recover
from areal_tpu_torch.gen.client import GenAPIClient
from areal_tpu_torch.system.fleet import FleetHealth

logger = logging.getLogger("areal_tpu_torch.gserver_manager")


@dataclasses.dataclass
class GserverManagerConfig:
    experiment_name: str = "exp"
    trial_name: str = "trial"
    model_name: str = "actor"
    train_batch_size: int = 64
    max_head_offpolicyness: int = 4
    max_concurrent_rollouts: int = 128
    schedule_policy: str = "round_robin"
    flush_request_timeout: float = 300.0
    n_checkpoints_to_keep: int = 2
    # --- health plane -------------------------------------------------- #
    health_fail_threshold: int = 3      # consecutive failures -> evict
    health_probe_cooldown: float = 5.0  # open -> probe-eligible delay
    health_check_interval: float = 2.0  # probe-loop tick
    heartbeat_interval: float = 10.0    # active /health poll of closed servers


@dataclasses.dataclass
class RolloutStat:
    submitted: int = 0
    running: int = 0
    accepted: int = 0


class _HTTPError(Exception):
    """An error answer: status, JSON body and headers."""

    def __init__(self, status: int, body: dict, headers=None):
        super().__init__(body)
        self.status, self.body, self.headers = status, body, headers or {}


class GserverManager:
    def __init__(self, config: GserverManagerConfig,
                 server_urls: Optional[List[str]] = None):
        self.config = config
        self.server_urls: List[str] = server_urls or []
        self.rollout_stat = RolloutStat()
        self.fleet = FleetHealth(
            self.server_urls,
            fail_threshold=config.health_fail_threshold,
            probe_cooldown_s=config.health_probe_cooldown,
        )
        self._qid_to_server: Dict[str, str] = {}
        self._request_counts: Dict[str, int] = defaultdict(int)
        self._token_usage: Dict[str, float] = defaultdict(float)
        # per-tenant accounting ("" = untagged rollout traffic)
        self._tenant_requests: Dict[str, int] = defaultdict(int)
        self._tenant_tokens: Dict[str, float] = defaultdict(float)
        # per-qid, per-server accounting, so finish_rollout releases exactly
        # what the qid's schedule_request calls accumulated
        self._qid_sched: Dict[str, Dict[str, Dict[str, float]]] = {}
        self._rr_next = 0
        # -1 so the trainer's first snapshot (v0) is pushed to the fleet
        self.version = -1
        self._ckpt_dirs: List[str] = []
        self._ckpt_versions: Dict[str, int] = {}
        self._latest_path: Optional[str] = None
        # version being fanned out (None = no flush in flight)
        self._flushing_version: Optional[int] = None
        # qids with a live allocation: a duplicate finish cannot release twice
        self._active_rollouts: set = set()
        # in-flight catch-up loads per checkpoint dir (the pruner keeps them)
        self._catchup_paths: Dict[str, int] = defaultdict(int)
        self._last_heartbeat: Dict[str, float] = {}
        self._lock = threading.Lock()
        # what the reference counts in its process-global metrics, and the
        # gate's decisions: denials by reason, the most groups ever running
        self.counters: Dict[str, int] = defaultdict(int)
        self.last_weight_update_s = 0.0   # the last fan-out, wall seconds
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._loop_thread: Optional[threading.Thread] = None
        self._tasks: List[asyncio.Task] = []
        # one detached catch-up/probe task per server being re-admitted
        self._probe_tasks: Dict[str, asyncio.Task] = {}
        self._httpd = None
        self._http_thread: Optional[threading.Thread] = None
        self.port: Optional[int] = None

    def routes(self):
        """The route table in one place (the reference's ``_bind_routes``)."""
        return {
            ("POST", "/schedule_request"): self._handler(self.schedule_request),
            ("POST", "/allocate_rollout"): self._handler(self.allocate_rollout),
            ("POST", "/finish_rollout"): self._handler(self.finish_rollout),
            ("POST", "/report_failure"): self._handler(self.report_failure),
            ("POST", "/add_server"): self._handler(self.add_server),
            ("POST", "/remove_server"): self._handler(self.remove_server),
            ("POST", "/get_model_version"): self._handler(
                lambda d: {"version": self.version}),
            ("GET", "/health"): self._handler(lambda d: {"status": "ok"}),
            ("GET", "/metrics_json"): self._handler(lambda d: self.metrics()),
        }

    @staticmethod
    def _handler(fn):
        def route(body: bytes):
            try:
                d = http.parse_json(body)
            except ValueError as e:
                return 400, {"error": f"malformed body: {e}"}
            try:
                return 200, fn(d)
            except _HTTPError as e:
                return e.status, e.body, e.headers
            except (KeyError, TypeError, ValueError) as e:
                return 400, {"error": f"malformed request: {e!r}"}
        return route

    # ------------------------------------------------------------------ #
    # lifecycle
    # ------------------------------------------------------------------ #

    def discover_servers(self):
        """Read generation-server URLs from name_resolve."""
        root = names.gen_servers(self.config.experiment_name,
                                 self.config.trial_name)
        try:
            self.server_urls = sorted(name_resolve.get_subtree(root))
        except name_resolve.NameEntryNotFoundError:
            self.server_urls = []
        for url in self.server_urls:
            self.fleet.add_server(url)
        return self.server_urls

    def start(self, host: str = "127.0.0.1", port: int = 0) -> int:
        """Serve the routes and start the weight-poll and probe loops on a
        background event loop; returns the bound port."""
        self._httpd, self._http_thread = http.start_server(
            self.routes(), host, port, "gserver-manager-http")
        self.port = self._httpd.server_address[1]
        self._loop = asyncio.new_event_loop()
        started = threading.Event()

        def run():
            asyncio.set_event_loop(self._loop)
            self._tasks = [self._loop.create_task(self._poll_weights()),
                           self._loop.create_task(self._probe_loop())]
            started.set()
            self._loop.run_forever()

        self._loop_thread = threading.Thread(target=run, daemon=True,
                                             name="gserver-manager-loop")
        self._loop_thread.start()
        started.wait()
        return self.port

    def stop(self):
        if self._loop is not None:
            async def cancel_all():
                tasks = [*self._tasks, *self._probe_tasks.values()]
                for t in tasks:
                    t.cancel()
                await asyncio.gather(*tasks, return_exceptions=True)

            asyncio.run_coroutine_threadsafe(cancel_all(), self._loop).result()
            self._loop.call_soon_threadsafe(self._loop.stop)
            self._loop_thread.join()
            self._loop.close()
            self._loop = None
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._http_thread.join()
            self._httpd = None

    def _training_samples(self) -> int:
        name = names.training_samples(self.config.experiment_name,
                                      self.config.trial_name)
        try:
            return int(name_resolve.get(name))
        except name_resolve.NameEntryNotFoundError:
            return 0

    def is_staled(self) -> bool:
        global_cnt = self._training_samples() + self.rollout_stat.running
        expected_version = global_cnt // self.config.train_batch_size
        return expected_version > self.config.max_head_offpolicyness + max(
            self.version, 0
        )

    # ------------------------------------------------------------------ #
    # weight-update polling
    # ------------------------------------------------------------------ #

    async def _poll_weights(self, interval: float = 0.5):
        while True:
            try:
                await self.check_new_params()
            except asyncio.CancelledError:
                raise
            except Exception:
                logger.exception("weight poll failed")
            await asyncio.sleep(interval)

    async def check_new_params(self) -> Optional[str]:
        """If the trainer published a newer version, update every server.
        Safe to call from any event loop while the poll loop runs: a call
        that finds the same version's fan-out in flight waits for it."""
        name = names.model_version(self.config.experiment_name,
                                   self.config.trial_name,
                                   self.config.model_name)
        try:
            raw = name_resolve.get(name)
        except name_resolve.NameEntryNotFoundError:
            return None
        version, _, path = raw.partition(":")
        version = int(version)
        with self._lock:
            if version <= self.version:
                return None
            inflight = self._flushing_version is not None
            if not inflight:
                # visible to the probe loop: a catch-up load completing while
                # this fan-out is in flight must not re-admit at the version
                # being superseded
                self._flushing_version = version
        if inflight:
            while self._flushing_version is not None:
                await asyncio.sleep(0.01)
            return path if self.version >= version else None
        try:
            await self.flush_and_update_weights(path, version)
            # the version advances even on partial failure: survivors serve
            # the new weights, failed servers were evicted and catch up
            # through the probe loop
            with self._lock:
                skipped = range(self.version + 1, version)
                self.version = version
                self._track_skipped(path, version, skipped)
                self._ckpt_dirs.append(path)
                self._ckpt_versions[path] = version
                self._latest_path = path
                self._prune_checkpoints()
        finally:
            self._flushing_version = None
        return path

    async def flush_and_update_weights(self, path: str, version: int):
        with self._lock:
            urls = [u for u in self.server_urls if self.fleet.is_healthy(u)]
        t0 = time.monotonic()
        async with GenAPIClient(timeout=self.config.flush_request_timeout) as c:
            results = await asyncio.gather(
                *(c.update_weights_from_disk(url, path, version=version,
                                             allow_interrupt=True)
                  for url in urls),
                return_exceptions=True,
            )
        n_paused, n_ok = 0, 0
        with self._lock:
            for url, r in zip(urls, results):
                if isinstance(r, BaseException) or not r.get("success"):
                    # this server now lags the fleet's weight version:
                    # evict it; the probe loop re-admits it after catch-up
                    logger.error("weight update v%d failed on %s: %r",
                                 version, url, r)
                    self.counters["weight_update_failures"] += 1
                    self.fleet.evict(url, f"weight update v{version} failed")
                    self._remap_stickies()
                else:
                    n_ok += 1
                    n_paused += r.get("num_paused_requests", 0)
                    self.fleet.observe_success(url)
                    self.fleet.ack_version(url, version)
            self.counters["weight_updates"] += 1
            self.counters["interrupted_requests"] += n_paused
            self.last_weight_update_s = time.monotonic() - t0
        if n_ok < len(urls):
            logger.warning("weight update v%d: %d/%d servers updated; "
                           "evicted the rest", version, n_ok, len(urls))
        logger.info("updated %d servers to v%d (%d requests interrupted)",
                    n_ok, version, n_paused)

    def _track_skipped(self, path: str, version: int, skipped):
        """Queue the snapshots of ``skipped`` versions that sit beside
        ``path`` under the ``v<version>`` naming for pruning, in version
        order (never loaded, so no server holds them)."""
        parent, base = os.path.split(path.rstrip("/"))
        if base != f"v{version}":
            return
        for k in skipped:
            old = os.path.join(parent, f"v{k}")
            if k >= 0 and os.path.isdir(old) and old not in self._ckpt_versions:
                self.counters["skipped_versions"] += 1
                self._ckpt_dirs.append(old)
                self._ckpt_versions[old] = k

    def _prune_checkpoints(self):
        """Delete superseded checkpoint dirs, but only those whose version
        every healthy server has acked moving past and that no catch-up
        load holds. The newest snapshot is never deleted."""
        while len(self._ckpt_dirs) > self.config.n_checkpoints_to_keep:
            old = self._ckpt_dirs[0]
            if old == self._latest_path:
                break
            v = self._ckpt_versions.get(old, -1)
            if (self._catchup_paths.get(old, 0) > 0
                    or self.fleet.min_acked_version() < v):
                self.counters["prune_deferred"] += 1
                logger.info("deferring prune of %s (v%d): not every healthy "
                            "server has acked it", old, v)
                break
            self._ckpt_dirs.pop(0)
            self._ckpt_versions.pop(old, None)
            recover.discard_checkpoint(old)

    # ------------------------------------------------------------------ #
    # health probing / re-admission
    # ------------------------------------------------------------------ #

    async def _probe_loop(self):
        while True:
            try:
                await self.run_health_checks()
            except asyncio.CancelledError:
                raise
            except Exception:
                logger.exception("health probe pass failed")
            await asyncio.sleep(self.config.health_check_interval)

    async def run_health_checks(self, wait_probes: bool = False):
        """One probe pass: heartbeat closed servers, probe open ones.
        ``wait_probes`` awaits the detached probe tasks before returning."""
        now = time.monotonic()
        with self._lock:
            # first sighting stamps the clock without probing
            for u in self.fleet.healthy_urls():
                self._last_heartbeat.setdefault(u, now)
            heartbeats = [
                u for u in self.fleet.healthy_urls()
                if now - self._last_heartbeat[u] >= self.config.heartbeat_interval
            ]
            candidates = self.fleet.probe_candidates()
            for url in candidates:
                prev = self._probe_tasks.get(url)
                if prev is None or prev.done():
                    self.fleet.begin_probe(url)
                    # probes carry a catch-up weight load: detached, so one
                    # slow load never freezes heartbeating
                    self._probe_tasks[url] = asyncio.get_running_loop(
                    ).create_task(self._probe_one(url))
        if wait_probes and self._probe_tasks:
            await asyncio.gather(*self._probe_tasks.values(),
                                 return_exceptions=True)
        if not heartbeats:
            return
        async with GenAPIClient(
                timeout=self.config.flush_request_timeout) as client:

            async def _heartbeat_one(url: str):
                self._last_heartbeat[url] = now
                ok = await client.health(url)
                with self._lock:
                    if ok:
                        self.fleet.observe_success(url)
                    elif self.fleet.observe_failure(url, "heartbeat failed"):
                        self._remap_stickies()

            await asyncio.gather(*[_heartbeat_one(u) for u in heartbeats],
                                 return_exceptions=True)

    async def _probe_one(self, url: str):
        async with GenAPIClient(
                timeout=self.config.flush_request_timeout) as client:
            await self._probe_with_client(client, url)

    async def _probe_with_client(self, client: GenAPIClient, url: str):
        """Half-open probe: /health, then a catch-up weight load, then
        re-admission into routing and fan-out."""
        with self._lock:
            self.fleet.begin_probe(url)
        if not await client.health(url):
            with self._lock:
                self.fleet.probe_failed(url, "health probe failed")
            return
        with self._lock:
            path, version = self._latest_path, self.version
            flushing = self._flushing_version
            if version >= 0 and path is not None:
                self._catchup_paths[path] += 1
        if version >= 0 and path is not None:
            # catch up to the fleet's weights before serving again
            try:
                r = await client.update_weights_from_disk(
                    url, path, version=version, allow_interrupt=True)
            except Exception as e:
                with self._lock:
                    self.fleet.probe_failed(url, f"catch-up load failed: {e!r}")
                return
            finally:
                with self._lock:
                    self._catchup_paths[path] -= 1
                    if self._catchup_paths[path] <= 0:
                        del self._catchup_paths[path]
            with self._lock:
                if not r.get("success"):
                    self.fleet.probe_failed(url, f"catch-up load rejected: {r}")
                    return
                if version != self.version or self._flushing_version is not None:
                    # a newer version was published (or is being fanned out,
                    # skipping this half-open server) while the load ran
                    self.fleet.probe_failed(
                        url, f"fleet moved past v{version} during catch-up "
                             f"(now v{self.version}, flushing="
                             f"{self._flushing_version})")
                    return
                self.fleet.readmit(url, acked_version=version)
        elif flushing is not None:
            # the first publish's fan-out is in flight and skipped this
            # server: re-admitting now would serve pre-publish weights
            with self._lock:
                self.fleet.probe_failed(
                    url, f"first publish (v{flushing}) in flight")
            return
        else:
            with self._lock:
                self.fleet.readmit(url)
        self._last_heartbeat[url] = time.monotonic()

    def _remap_stickies(self):
        """Drop sticky qid -> server assignments that point at evicted
        servers (caller holds the lock)."""
        dead = [qid for qid, url in self._qid_to_server.items()
                if not self.fleet.is_healthy(url)]
        for qid in dead:
            del self._qid_to_server[qid]
        if dead:
            self.counters["sticky_remaps"] += len(dead)
            logger.info("remapped %d sticky qids off evicted servers", len(dead))

    # ------------------------------------------------------------------ #
    # handlers: each takes the JSON body and returns the JSON answer
    # ------------------------------------------------------------------ #

    def _pick_server(self) -> str:
        urls = [u for u in self.server_urls if self.fleet.is_healthy(u)]
        if not urls and self.server_urls:
            # whole fleet evicted: 503 + Retry-After (the probe cadence)
            self.counters["route_no_healthy"] += 1
            raise _HTTPError(
                503, {"error": "no healthy generation server (all breakers "
                               "open)"},
                {"Retry-After": str(max(1, int(self.fleet.probe_cooldown_s
                                               + 0.999)))})
        if not urls:
            raise _HTTPError(503, {"error": "no generation servers registered"})
        if self.config.schedule_policy == "least_requests":
            return min(urls, key=lambda u: self._request_counts[u])
        if self.config.schedule_policy == "least_token_usage":
            return min(urls, key=lambda u: self._token_usage[u])
        url = urls[self._rr_next % len(urls)]
        self._rr_next += 1
        return url

    def schedule_request(self, meta: dict) -> dict:
        with self._lock:
            self.counters["scheduled"] += 1
            prev_url = meta.get("previous_server_url")
            if (prev_url and meta.get("previous_version") == self.version
                    and self.fleet.is_healthy(prev_url)):
                return {"url": prev_url, "version": self.version}
            # tenant-qualified sticky key
            tenant = str(meta.get("tenant") or "")
            qid = str(meta["qid"])
            if tenant:
                qid = f"{tenant}/{qid}"
            url = self._qid_to_server.get(qid)
            if url is not None and not self.fleet.is_healthy(url):
                url = None  # sticky target was evicted: remap
            if url is None:
                url = self._pick_server()
                self._qid_to_server[qid] = url
            tokens = meta.get("prompt_len", 0) + 0.4 * meta.get(
                "new_token_budget", 0) * meta.get("group_size", 1)
            self._request_counts[url] += 1
            self._token_usage[url] += tokens
            self._tenant_requests[tenant] += 1
            self._tenant_tokens[tenant] += tokens
            acct = self._qid_sched.setdefault(qid, {}).setdefault(
                url, {"n": 0, "tokens": 0.0})
            acct["n"] += 1
            acct["tokens"] += tokens
            return {"url": url, "version": self.version}

    def allocate_rollout(self, d: dict) -> dict:
        with self._lock:
            has_capacity = (
                self.rollout_stat.running < self.config.max_concurrent_rollouts
            )
            staled = self.is_staled()
            if has_capacity and not staled:
                self.rollout_stat.submitted += 1
                self.rollout_stat.running += 1
                self._active_rollouts.add(str(d.get("qid")))
                self.counters["allocated"] += 1
                self.counters["max_running"] = max(
                    self.counters["max_running"], self.rollout_stat.running)
                return {"success": True, "reason": ""}
            reason = []
            if not has_capacity:
                self.counters["denied_capacity"] += 1
                reason.append(
                    f"capacity: {self.rollout_stat.running} >= "
                    f"{self.config.max_concurrent_rollouts}"
                )
            if staled:
                self.counters["denied_staled"] += 1
                cnt = self._training_samples() + self.rollout_stat.running
                reason.append(
                    f"staled: expected version "
                    f"{cnt // self.config.train_batch_size} > "
                    f"{self.config.max_head_offpolicyness} + {self.version}"
                )
            return {"success": False, "reason": "; ".join(reason)}

    def finish_rollout(self, d: dict) -> dict:
        with self._lock:
            qid = str(d["qid"])
            # release everything this rollout accumulated, multi-turn
            # agents' suffixed sub-qids ("<qid>-tK") included
            for key in [qid] + [k for k in self._qid_sched
                                if k.startswith(f"{qid}-t")]:
                per_url = self._qid_sched.pop(key, None)
                self._qid_to_server.pop(key, None)
                for url, acct in (per_url or {}).items():
                    self._request_counts[url] = max(
                        0, self._request_counts[url] - acct["n"])
                    self._token_usage[url] = max(
                        0.0, self._token_usage[url] - acct["tokens"])
            # idempotent: only a live allocation releases a slot
            if qid in self._active_rollouts:
                self._active_rollouts.discard(qid)
                self.rollout_stat.running = max(0, self.rollout_stat.running - 1)
                if d.get("accepted"):
                    self.rollout_stat.accepted += 1
            return {"success": True}

    def add_server(self, d: dict) -> dict:
        """Add a server to routing live; it starts closed (healthy)."""
        url = str(d.get("url", ""))
        if not url:
            raise _HTTPError(400, {"error": "missing 'url'"})
        with self._lock:
            if url not in self.server_urls:
                self.server_urls.append(url)
            self.fleet.add_server(url)
            return {"success": True, "servers": list(self.server_urls)}

    def remove_server(self, d: dict) -> dict:
        """Remove a server from routing live; its sticky qids remap."""
        url = str(d.get("url", ""))
        with self._lock:
            if self.server_urls == [url]:
                # never empty the routed set: every schedule_request would
                # fail with no way back but /add_server
                raise _HTTPError(409, {
                    "success": False,
                    "error": "refusing to remove the last server",
                    "servers": list(self.server_urls)})
            if url in self.server_urls:
                self.server_urls.remove(url)
            self.fleet.remove_server(url)
            self._remap_stickies()
            return {"success": True, "servers": list(self.server_urls)}

    def report_failure(self, d: dict) -> dict:
        """Passive failure observation: a rollout worker's generate against
        ``url`` failed after client-level retries."""
        url = d.get("url", "")
        reason = d.get("reason", "reported by rollout worker")
        qid = d.get("qid")
        if qid is not None:
            reason = f"{reason} (qid={qid})"
        with self._lock:
            evicted = self.fleet.observe_failure(url, reason)
            if evicted:
                self._remap_stickies()
            s = self.fleet.get(url)
            return {"evicted": evicted, "state": s.state if s else "unknown"}

    def metrics(self) -> dict:
        with self._lock:
            return {
                "version": self.version,
                "submitted": self.rollout_stat.submitted,
                "running": self.rollout_stat.running,
                "accepted": self.rollout_stat.accepted,
                "servers": list(self.server_urls),
                "healthy_servers": self.fleet.healthy_urls(),
                "fleet": self.fleet.snapshot(),
                "request_counts": dict(self._request_counts),
                "tenant_requests": dict(self._tenant_requests),
                "tenant_tokens": {t: round(v, 1)
                                  for t, v in self._tenant_tokens.items()},
                # the reference's merged worker telemetry (not ported)
                "fleet_telemetry": None,
                "counters": dict(self.counters),
            }


def serve_manager(manager: GserverManager, host: str = "127.0.0.1",
                  port: int = 0) -> GserverManager:
    """Start ``manager`` (routes + background loops) and publish its address
    for rollout workers; the caller ends it with ``manager.stop()``."""
    port = manager.start(host, port)
    name_resolve.add(
        names.gserver_manager(manager.config.experiment_name,
                              manager.config.trial_name),
        f"http://{host}:{port}", replace=True,
    )
    return manager
