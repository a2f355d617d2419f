"""Training metric sinks and the process-global counter registry (the
counterpart of ``areal_tpu/base/metrics.py``).

- ``MetricLogger``: one JSON line per logged step in
  ``<logdir>/metrics.jsonl`` (``{"step", "time", "<prefix>/<key>": ...}``,
  the reference's layout), and TensorBoard scalars when ``tensorboardX``
  imports.
- ``counters``: cheap thread-safe host counters, peaks, gauges and
  fixed-boundary histograms that every layer bumps (retries, evictions,
  guard decisions, lifecycle latencies, spans). The per-worker telemetry
  exporter publishes ``counters.export_state()``; the fleet aggregator
  merges the snapshots by kind.
- The catalog: every fixed counter name as an UPPERCASE constant, equal
  name for name and kind for kind to the reference's, so one dashboard
  reads either package's workers.

Nothing here reads the device: a counter is bumped from numbers the host
already holds.
"""

import bisect
import json
import math
import os
import threading
import time
from typing import Dict, List, Optional

from areal_tpu_torch.base import logging

logger = logging.getLogger("metrics")


# --------------------------------------------------------------------- #
# Metric kinds. Every registered key has exactly one kind, declared in
# the METRIC_KINDS catalog below (unknown keys default to ``sum``); the
# per-interval ``delta()`` view and the fleet aggregator merge by kind
# (sum: subtract/add, peak: report/max, histogram: bucket-wise merge)
# instead of guessing from name suffixes.
# --------------------------------------------------------------------- #

KIND_SUM = "sum"
KIND_PEAK = "peak"
KIND_HISTOGRAM = "histogram"
KIND_GAUGE = "gauge"


def _log_spaced(lo: float, hi: float, per_decade: int) -> List[float]:
    k0 = round(math.log10(lo) * per_decade)
    k1 = round(math.log10(hi) * per_decade)
    return [round(10 ** (k / per_decade), 10) for k in range(k0, k1 + 1)]


# Default bucket edges for duration-like histograms: 100 µs … 10 000 s,
# 4 buckets per decade (±~33% relative resolution — enough to tell p50
# from p99 of any latency this system produces, small enough to ship in
# every exporter snapshot).
DEFAULT_HISTOGRAM_BOUNDARIES: List[float] = _log_spaced(1e-4, 1e4, 4)

# Integer-centered edges for version-lag histograms: staleness is a small
# integer and log buckets would smear 0/1/2 (the values the paper's
# bounded-staleness story is about) into one bucket.
VERSION_LAG_BOUNDARIES: List[float] = [
    0.5, 1.5, 2.5, 3.5, 4.5, 6.5, 8.5, 12.5, 16.5, 24.5, 32.5, 48.5,
    64.5, 96.5, 128.5,
]


class Histogram:
    """Fixed-boundary histogram: mergeable across processes, cheap to
    observe (one bisect + three adds), summarizable to count/sum/mean and
    interpolated percentiles. NOT thread-safe on its own — the owning
    :class:`CounterRegistry` serializes access under its lock.

    ``counts`` has ``len(boundaries) + 1`` entries; entry ``i`` counts
    values ``<= boundaries[i]`` (and greater than the previous edge), the
    last entry is the overflow bucket.
    """

    __slots__ = ("boundaries", "counts", "sum", "count", "min", "max")

    def __init__(self, boundaries: Optional[List[float]] = None):
        self.boundaries = list(
            boundaries if boundaries is not None
            else DEFAULT_HISTOGRAM_BOUNDARIES
        )
        assert self.boundaries == sorted(self.boundaries), "edges must ascend"
        self.counts = [0] * (len(self.boundaries) + 1)
        self.sum = 0.0
        self.count = 0
        self.min = float("inf")
        self.max = float("-inf")

    def observe(self, value: float, n: int = 1) -> None:
        """Record ``value`` ``n`` times (``n > 1`` lets batched producers —
        e.g. the spec-decode chunk folding a whole ``[steps, slots]``
        accept-length grid — record without a per-observation loop)."""
        v = float(value)
        self.counts[bisect.bisect_left(self.boundaries, v)] += n
        self.sum += v * n
        self.count += n
        if v < self.min:
            self.min = v
        if v > self.max:
            self.max = v

    def merge(self, other: "Histogram") -> None:
        if other.boundaries != self.boundaries:
            raise ValueError(
                "cannot merge histograms with different boundaries "
                f"({len(self.boundaries)} vs {len(other.boundaries)} edges)"
            )
        for i, c in enumerate(other.counts):
            self.counts[i] += c
        self.sum += other.sum
        self.count += other.count
        self.min = min(self.min, other.min)
        self.max = max(self.max, other.max)

    def percentile(self, q: float) -> float:
        """Interpolated q-th percentile (q in [0, 100]); 0.0 when empty.
        Bucket-local linear interpolation, clamped to the observed
        min/max so all-identical observations report exactly that value."""
        if self.count == 0:
            return 0.0
        rank = q / 100.0 * self.count
        seen = 0
        for i, c in enumerate(self.counts):
            if c == 0:
                continue
            if seen + c >= rank:
                lo = self.boundaries[i - 1] if i > 0 else 0.0
                hi = (
                    self.boundaries[i]
                    if i < len(self.boundaries)
                    else self.max
                )
                frac = (rank - seen) / c
                est = lo + (hi - lo) * max(0.0, min(frac, 1.0))
                return max(self.min, min(est, self.max))
            seen += c
        return self.max

    def summary(self) -> Dict[str, float]:
        if self.count == 0:
            return {"count": 0.0}
        return {
            "count": float(self.count),
            "sum": self.sum,
            "mean": self.sum / self.count,
            "min": self.min,
            "max": self.max,
            "p50": self.percentile(50),
            "p95": self.percentile(95),
            "p99": self.percentile(99),
        }

    def state(self) -> dict:
        """JSON-serializable full state (for the telemetry exporter)."""
        return {
            "boundaries": self.boundaries,
            "counts": list(self.counts),
            "sum": self.sum,
            "count": self.count,
            "min": self.min if self.count else None,
            "max": self.max if self.count else None,
        }

    @classmethod
    def from_state(cls, d: dict) -> "Histogram":
        h = cls(boundaries=d["boundaries"])
        h.counts = [int(c) for c in d["counts"]]
        h.sum = float(d["sum"])
        h.count = int(d["count"])
        h.min = float("inf") if d.get("min") is None else float(d["min"])
        h.max = float("-inf") if d.get("max") is None else float(d["max"])
        return h

    def copy(self) -> "Histogram":
        return Histogram.from_state(self.state())


class CounterRegistry:
    """Process-global named counters/gauges for data-plane observability.

    Thread-safe (the train prefetcher packs on a background thread).
    ``add`` accumulates, ``peak`` keeps a running maximum (pipeline depth),
    ``observe`` records into a fixed-boundary histogram, ``snapshot``/
    ``delta`` give scalar dict views the trainer folds into its per-step
    stats under ``pipe/``, and ``export_state`` serializes everything for
    the per-worker telemetry exporter.

    Metric kinds come from the module-level METRIC_KINDS catalog (plus
    ``register_kind`` for dynamic names); unknown keys default to ``sum``.
    """

    def __init__(self, kinds: Optional[Dict[str, str]] = None):
        self._lock = threading.Lock()
        self._vals: Dict[str, float] = {}
        self._hists: Dict[str, Histogram] = {}
        # per-registry overrides; the catalog below is the shared default
        self._kinds: Dict[str, str] = dict(kinds or {})

    def kind(self, name: str) -> str:
        k = self._kinds.get(name)
        if k is None:
            k = METRIC_KINDS.get(name, KIND_SUM)
        return k

    def register_kind(self, name: str, kind: str) -> None:
        assert kind in (KIND_SUM, KIND_PEAK, KIND_HISTOGRAM, KIND_GAUGE), kind
        with self._lock:
            self._kinds[name] = kind

    def add(self, name: str, value: float = 1.0) -> None:
        with self._lock:
            self._vals[name] = self._vals.get(name, 0.0) + float(value)

    def peak(self, name: str, value: float) -> None:
        with self._lock:
            self._kinds.setdefault(name, KIND_PEAK)
            if float(value) > self._vals.get(name, float("-inf")):
                self._vals[name] = float(value)

    def gauge(self, name: str, value: float) -> None:
        """Last-value-wins gauge (a live setting, not an accumulation —
        e.g. the adaptive speculative-K currently in force). Reported
        as-is in ``delta`` views; the fleet aggregator takes the max
        across workers."""
        with self._lock:
            self._kinds.setdefault(name, KIND_GAUGE)
            self._vals[name] = float(value)

    def observe(self, name: str, value: float, n: int = 1) -> None:
        """Record ``n`` observations of ``value`` into the histogram
        ``name`` (created on first use with the catalog's boundaries for
        that key)."""
        with self._lock:
            h = self._hists.get(name)
            if h is None:
                h = Histogram(HISTOGRAM_BOUNDARIES.get(name))
                self._hists[name] = h
                self._kinds.setdefault(name, KIND_HISTOGRAM)
            h.observe(value, n)

    def get(self, name: str, default: float = 0.0) -> float:
        with self._lock:
            return self._vals.get(name, default)

    def histogram(self, name: str) -> Optional[Histogram]:
        """Copy of one histogram (None when nothing was observed)."""
        with self._lock:
            h = self._hists.get(name)
            return h.copy() if h is not None else None

    def clear(self, name: str) -> None:
        """Drop one counter. Peaks (``peak``) are process-lifetime maxima —
        a measurement that wants the peak OF ITS OWN interval must clear
        the key at the interval start; snapshot-and-subtract is meaningless
        for a maximum."""
        with self._lock:
            self._vals.pop(name, None)
            self._hists.pop(name, None)

    def snapshot(self) -> Dict[str, float]:
        with self._lock:
            return dict(self._vals)

    def delta(self, before: Dict[str, float]) -> Dict[str, float]:
        """Per-interval scalar view: current snapshot minus ``before`` for
        sum-kind keys; peak-kind and gauge-kind keys report as-is (a
        maximum or a live setting has no meaningful difference).
        Histograms are not part of the scalar delta — read them via
        ``histogram``/``histogram_summaries``."""
        now = self.snapshot()
        return {
            k: (
                v
                if self.kind(k) in (KIND_PEAK, KIND_GAUGE)
                else v - before.get(k, 0.0)
            )
            for k, v in now.items()
        }

    def histogram_summaries(self) -> Dict[str, Dict[str, float]]:
        """``{name: {count, sum, mean, min, max, p50, p95, p99}}`` for every
        histogram with at least one observation."""
        with self._lock:
            hists = {k: h.copy() for k, h in self._hists.items() if h.count}
        return {k: h.summary() for k, h in hists.items()}

    def export_state(self) -> dict:
        """Full serializable state: scalar counters with their kinds plus
        histogram bucket states — the payload the per-worker telemetry
        exporter publishes and the fleet aggregator merges."""
        with self._lock:
            vals = dict(self._vals)
            hists = {k: h.state() for k, h in self._hists.items()}
        return {
            "counters": vals,
            "kinds": {k: self.kind(k) for k in vals},
            "histograms": hists,
        }

    def reset(self) -> None:
        with self._lock:
            self._vals.clear()
            self._hists.clear()


# The process-global registry (≈ the reference's monotonic perf counters in
# ``realhf/base/monitor.py``). Engines/trainers import this single instance.
counters = CounterRegistry()


# --------------------------------------------------------------------- #
# Counter catalog. Every fixed counter name is an UPPERCASE constant in
# this module — the single authoritative name list dashboards and tests
# key off. Enforced statically by the ``unregistered-counter`` rule of
# ``tools/arealint`` (string-literal names at call sites must match a
# value here; constant references must be defined here). Dynamic families
# (``tracing.span``'s ``<name>_s``/``<name>_n``, ``faults/<point>``) are
# exempt — they cannot be checked statically.
# --------------------------------------------------------------------- #

# Data-plane pipeline namespace (``fwd_pipe/`` / ``train_pipe/`` /
# ``stats_fetch/``) — proves the host<->device overlap happened
# (docs/pipelined_data_plane.md) instead of inferring it from wall time.
PIPE_STATS_FETCH_BLOCKING = "stats_fetch/blocking"   # blocking device pulls
PIPE_PREFETCHED_MINIBATCHES = "train_pipe/prefetched_minibatches"
PIPE_STATS_FLUSHES = "train_pipe/stats_flushes"      # deferred-stats flushes
PIPE_FWD_DISPATCHED = "fwd_pipe/dispatched"          # forward mbs dispatched
PIPE_FWD_MAX_IN_FLIGHT = "fwd_pipe/max_in_flight"    # realized pipeline depth
PIPE_FWD_DEVICE_IDLE_GAP_S = "fwd_pipe/device_idle_gap_s"


# --------------------------------------------------------------------- #
# Fault-tolerance counter namespace (``ft/``) — every retry / eviction /
# requeue decision the fleet-health subsystem makes is observable here
# (docs/fault_tolerance.md).  Tests assert on these instead of scraping
# logs.  ``faults/<point>`` counts injected faults per injection point.
# --------------------------------------------------------------------- #

FT_CLIENT_RETRIES = "ft/client_retries"            # GenAPIClient backoff retries
FT_GEN_SERVER_FAILURES = "ft/gen_server_failures"  # generate failed after retries
FT_ROLLOUT_REQUEUES = "ft/rollout_requeues"        # failed sample requeued
FT_ROLLOUT_DROPPED = "ft/rollout_dropped"          # attempts exhausted; sample lost
FT_FAILURES_OBSERVED = "ft/failures_observed"      # health-plane failure observations
FT_EVICTIONS = "ft/evictions"                      # breaker closed → open
FT_READMISSIONS = "ft/readmissions"                # probe + catch-up succeeded
FT_PROBE_FAILURES = "ft/probe_failures"            # half-open probe failed
FT_WEIGHT_UPDATE_FAILURES = "ft/weight_update_failures"
FT_STICKY_REMAPS = "ft/sticky_remaps"              # qid→server remapped off corpse
FT_ROUTE_NO_HEALTHY = "ft/route_no_healthy"        # routed with zero healthy servers
FT_PRUNE_DEFERRED = "ft/prune_deferred"            # ckpt prune blocked by un-acked server
FT_PUSH_DROPS = "ft/push_drops"                    # ZMQ push timed out; trajectory dropped
FT_DRAIN_ABANDONED = "ft/drain_abandoned"          # tasks cancelled at drain timeout
FT_STALE_DROPPED_ON_RECOVER = "ft/stale_dropped_on_recover"
FT_PUBLISH_FAILURES = "ft/publish_failures"        # background weight publish raised
FT_PREEMPTIONS = "ft/preemptions"                  # graceful-stop requests honored

# Elastic multihost (docs/fault_tolerance.md "Elastic multihost"): the
# surgical rank-recovery plane. rank_restarts/world_epochs are counted by
# the WorldSupervisor; collective_timeouts by the rank that aborted a
# bounded collective. recovery_time_s (histogram below) measures fault
# detection -> every rank live at the new epoch.
FT_RANK_RESTARTS = "ft/rank_restarts"              # dead/wedged ranks relaunched
FT_WORLD_EPOCHS = "ft/world_epochs"                # world reformations committed
FT_COLLECTIVE_TIMEOUTS = "ft/collective_timeouts"  # bounded collectives aborted
RECOVERY_TIME_S = "recovery_time_s"                # histogram: detect -> reformed


# --------------------------------------------------------------------- #
# Trainer guardrail namespace (``guard/``) — the step-level anomaly plane
# (docs/fault_tolerance.md "Trainer survivability"): on-device finite-ness
# checks, skipped optimizer updates, rollbacks to the last committed
# checkpoint, watchdog stack dumps.
# --------------------------------------------------------------------- #

GUARD_ANOMALOUS_STEPS = "guard/anomalous_steps"    # non-finite loss/grad_norm observed
GUARD_SKIPPED_UPDATES = "guard/update_skipped"     # optimizer update selected away on device
GUARD_ROLLBACKS = "guard/rollbacks"                # K consecutive anomalies -> ckpt rollback
GUARD_ROLLBACK_FAILED = "guard/rollback_failed"    # wanted to roll back; no committed ckpt
GUARD_CKPT_FALLBACKS = "guard/ckpt_fallbacks"      # committed sibling promoted over a missing/uncommitted canonical dir
GUARD_WATCHDOG_DUMPS = "guard/watchdog_dumps"      # hang watchdog dumped thread stacks


# --------------------------------------------------------------------- #
# Trajectory lifecycle histograms (docs/observability.md): every accepted
# rollout is stamped submit → first-chunk → reward → enqueue on its way
# through partial_rollout → push_pull_stream → buffer, and consumption
# (buffer.record_batch_consumption at the trainer's multihost commit
# point) turns the stamps into distributions — the
# paper's staleness/latency story as measured percentiles, not averages.
# --------------------------------------------------------------------- #

STALENESS_VERSIONS = "staleness_versions"  # trainer version - version_start at consumption
QUEUE_WAIT_S = "queue_wait_s"              # rollout enqueue -> trainer consumption
E2E_LATENCY_S = "e2e_latency_s"            # generation submit -> trainer consumption
TTFC_S = "ttfc_s"                          # generation submit -> first chunk back
REWARD_LAG_S = "reward_lag_s"              # generation submit -> reward computed


# --------------------------------------------------------------------- #
# Per-role activity counters: the always-on heartbeat numbers each worker
# publishes through the telemetry exporter, so a fleet/ record proves
# every role did work (failure counters stay zero in a healthy run).
# --------------------------------------------------------------------- #

ROLLOUT_PUSHED = "rollout/pushed"          # trajectories pushed to the trainer
ROLLOUT_ACCEPTED = "rollout/accepted"      # rollouts finished accepted
GEN_SERVED = "gen/served"                  # generate requests completed
GEN_TOKENS = "gen/tokens"                  # tokens generated
MANAGER_SCHEDULED = "manager/schedule_requests"
MANAGER_ALLOCATED = "manager/allocated"    # rollouts admitted by the gate
TRAIN_STEPS = "train/steps"                # optimizer steps taken

# Speculative decoding (docs/performance.md "Speculative decoding"):
# drafted vs accepted draft tokens (sums; their ratio is the accept rate)
# plus an accept-length distribution per (slot, spec step) — the drafter
# quality signal the bench and the ops CLI read.
GEN_SPEC_DRAFT_TOKENS = "gen/spec_draft_tokens"
GEN_SPEC_ACCEPTED_TOKENS = "gen/spec_accepted_tokens"
GEN_SPEC_ACCEPT_LEN = "gen/spec_accept_len"

# Draft-MODEL speculative decoding: the per-position acceptance
# probability min(1, p/q) the rejection sampler computes for sampled
# (general-q) drafters — the draft-quality signal independent of where
# the first rejection lands — plus the draft pool's occupancy histogram
# (its pages move in lockstep with the target pool's, so this mirrors
# gen/kv_pool_occupancy whenever a draft model is configured; bytes ride
# the per-worker gauge channel and /metrics_json).
GEN_SPEC_Q_ACCEPT_PROB = "gen/spec_q_accept_prob"
GEN_DRAFT_KV_POOL_OCCUPANCY = "gen/draft_kv_pool_occupancy"

# Fused sampling epilogue (docs/performance.md "Fused sampling
# epilogue"): decode steps sampled through the streamed LM-head epilogue
# vs rows that fell back to the sorted reference path (top-p / oversize
# top-k slots) — their ratio is the fused coverage of live traffic —
# plus the adaptive speculative-K currently in force (a gauge: last value
# wins locally, fleet aggregation takes the max across workers).
GEN_FUSED_SAMPLE_STEPS = "gen/fused_sample_steps"
GEN_SAMPLER_FALLBACK_ROWS = "gen/sampler_fallback_rows"
GEN_SPEC_K_CURRENT = "gen/spec_k_current"

# Chunk-boundary sync protocol (docs/performance.md "Speculative
# decoding" / chunk pipelining): every decode chunk's harvest-flag fetch
# is dispatch-ahead (the D2H copy is enqueued at dispatch, resolved one
# chunk later under AREAL_DECODE_PIPELINE) — ``blocked`` counts resolves
# that found the copy not yet landed (a fresh host<->device round trip,
# the thing the protocol exists to eliminate). Steady-state pipelined
# decode keeps blocked at zero; the overlap test pins it.
GEN_CHUNK_FLAG_FETCHES = "gen/chunk_flag_fetches"
GEN_CHUNK_FLAG_BLOCKED = "gen/chunk_flag_blocked"

# KV-pool quantization (docs/performance.md "KV quantization"): pages
# allocated into an int8 pool (their KV lands quantized at the post-scan
# scatter) plus a pool-occupancy histogram — the HBM-headroom signal the
# fleet aggregator and the gen server's /metrics_json gauges expose.
GEN_KVQ_PAGES_QUANTIZED = "gen/kvq_pages_quantized"
GEN_KV_POOL_OCCUPANCY = "gen/kv_pool_occupancy"

# --------------------------------------------------------------------- #
# Serving-gateway namespace (``gw/``, docs/serving.md): every admission /
# QoS / scaling decision the OpenAI-compatible frontend makes. The queue
# histograms are the autoscaler's primary latency signals; the per-tenant
# token family (``gw/tenant_tokens/<tenant>``) is dynamic and therefore
# registered by its prefix constant only (same exemption as
# ``faults/<point>`` — it cannot be enumerated statically).
# --------------------------------------------------------------------- #

GW_REQUESTS = "gw/requests"               # API requests past validation
GW_ADMITTED = "gw/admitted"               # requests dispatched into a slot
GW_REJECTED_429 = "gw/rejected_429"       # rate-limit / queue-full rejections
GW_REJECTED_4XX = "gw/rejected_4xx"       # validation rejections (400/401)
GW_COMPLETED = "gw/completed"             # requests finished (any reason)
GW_STREAMED_TOKENS = "gw/streamed_tokens" # tokens emitted to API clients
GW_RESUBMITS = "gw/resubmits"             # interrupted gens resumed transparently
GW_QUEUE_WAIT_S = "gw/queue_wait_s"       # histogram: enqueue -> dispatch
GW_TTFT_S = "gw/ttft_s"                   # histogram: enqueue -> first token
GW_SCALE_UPS = "gw/scale_ups"             # autoscaler grew the routed set
GW_SCALE_DOWNS = "gw/scale_downs"         # autoscaler shrank the routed set
GW_TENANT_TOKENS_PREFIX = "gw/tenant_tokens/"  # + <tenant>: per-tenant sums

# Survivability plane (docs/serving.md "Survivability"): deadline
# propagation, hedged dispatch and the brownout ladder.
GW_DEADLINE_SHED = "gw/deadline_shed"     # expired in queue / mid-stream
GW_HEDGES = "gw/hedges"                   # hedge streams opened
GW_HEDGE_WINS = "gw/hedge_wins"           # hedge beat the primary's 1st chunk
GW_STREAM_RESUMES = "gw/stream_resumes"   # streams resumed after backend death
GW_BROWNOUT_LEVEL = "gw/brownout_level"   # gauge: current degradation level
GW_BROWNOUT_TRANSITIONS = "gw/brownout_transitions"  # ladder level changes

# --------------------------------------------------------------------- #
# Distributed tracing namespace (``trace/``, docs/observability.md
# "Distributed tracing"): the span ring / flush plane plus flight-
# recorder dumps. ``trace/span_s`` is a histogram over every recorded
# span's duration (one distribution across names — per-name wall time
# already rides the ``<name>_s`` sums ``tracing.span`` has always kept).
# --------------------------------------------------------------------- #

TRACE_SPANS = "trace/spans"                 # spans recorded into the ring
TRACE_SPAN_ERRORS = "trace/span_errors"     # spans that exited via exception
TRACE_DROPPED = "trace/dropped"             # ring overwrote an unflushed span
TRACE_FLUSHES = "trace/flushes"             # ring drains to the fileroot
TRACE_FLUSHED_SPANS = "trace/flushed_spans" # spans written by those drains
TRACE_FLIGHT_DUMPS = "trace/flight_dumps"   # flight-recorder dumps written
TRACE_SPAN_S = "trace/span_s"               # histogram: recorded span durations


# Fraction edges for the pool-occupancy histogram: occupancy lives in
# [0, 1] and the log-spaced duration edges would put the whole range into
# two buckets; 0.9+ gets finer edges because that is where admission
# starts deferring (the signal an autoscaler acts on).
POOL_OCCUPANCY_BOUNDARIES: List[float] = [
    0.1, 0.2, 0.3, 0.4, 0.5, 0.6, 0.7, 0.8, 0.9, 0.95, 0.99,
]

# Small-integer edges for the accept-length histogram: accept lengths are
# 0..K (K = AREAL_SPEC_K, typically <= 8) and the duration edges would
# smear 0/1/2 — the values that decide whether spec decode pays — into
# one bucket.
SPEC_ACCEPT_LEN_BOUNDARIES: List[float] = [
    0.5, 1.5, 2.5, 3.5, 4.5, 5.5, 6.5, 7.5, 8.5, 12.5, 16.5,
]

# Probability edges for the general-q acceptance-probability histogram:
# values live in [0, 1]; finer edges toward 1.0 because that is where a
# good draft model lives (0.9 vs 0.99 mean accept is the difference
# between spec paying and not at large K).
SPEC_Q_ACCEPT_PROB_BOUNDARIES: List[float] = [
    0.05, 0.1, 0.2, 0.3, 0.4, 0.5, 0.6, 0.7, 0.8, 0.9, 0.95, 0.99,
]


# Per-key metric kinds; unknown keys default to KIND_SUM. The arealint
# ``unregistered-counter`` rule keys off the UPPERCASE constants above;
# this map adds the KIND so delta()/the fleet aggregator merge correctly.
METRIC_KINDS: Dict[str, str] = {
    PIPE_FWD_MAX_IN_FLIGHT: KIND_PEAK,
    STALENESS_VERSIONS: KIND_HISTOGRAM,
    QUEUE_WAIT_S: KIND_HISTOGRAM,
    E2E_LATENCY_S: KIND_HISTOGRAM,
    TTFC_S: KIND_HISTOGRAM,
    REWARD_LAG_S: KIND_HISTOGRAM,
    GEN_SPEC_ACCEPT_LEN: KIND_HISTOGRAM,
    GEN_SPEC_K_CURRENT: KIND_GAUGE,
    GEN_SPEC_Q_ACCEPT_PROB: KIND_HISTOGRAM,
    GEN_KV_POOL_OCCUPANCY: KIND_HISTOGRAM,
    GEN_DRAFT_KV_POOL_OCCUPANCY: KIND_HISTOGRAM,
    RECOVERY_TIME_S: KIND_HISTOGRAM,
    GW_QUEUE_WAIT_S: KIND_HISTOGRAM,
    GW_TTFT_S: KIND_HISTOGRAM,
    GW_BROWNOUT_LEVEL: KIND_GAUGE,
    TRACE_SPAN_S: KIND_HISTOGRAM,
}

# Non-default bucket edges per histogram key (default: the log-spaced
# duration edges).
HISTOGRAM_BOUNDARIES: Dict[str, List[float]] = {
    STALENESS_VERSIONS: VERSION_LAG_BOUNDARIES,
    GEN_SPEC_ACCEPT_LEN: SPEC_ACCEPT_LEN_BOUNDARIES,
    GEN_SPEC_Q_ACCEPT_PROB: SPEC_Q_ACCEPT_PROB_BOUNDARIES,
    GEN_KV_POOL_OCCUPANCY: POOL_OCCUPANCY_BOUNDARIES,
    GEN_DRAFT_KV_POOL_OCCUPANCY: POOL_OCCUPANCY_BOUNDARIES,
}


class MetricLogger:
    def __init__(self, logdir: str, backends: tuple = ("jsonl", "tensorboard")):
        os.makedirs(logdir, exist_ok=True)
        self._jsonl = None
        self._tb = None
        self._tb_failed_keys: set = set()
        if "jsonl" in backends:
            self._jsonl = open(os.path.join(logdir, "metrics.jsonl"), "a")
        if "tensorboard" in backends:
            try:
                from tensorboardX import SummaryWriter

                self._tb = SummaryWriter(logdir=os.path.join(logdir, "tb"))
            except ImportError:
                pass

    def log(
        self,
        data: Dict[str, float],
        step: int,
        prefix: Optional[str] = None,
        wall_time: Optional[float] = None,
    ):
        """``wall_time`` stamps a step with the time it ran when the
        trainer logs several steps at once."""
        if prefix:
            data = {f"{prefix}/{k}": v for k, v in data.items()}
        if self._jsonl:
            self._jsonl.write(
                json.dumps(
                    dict(
                        step=step,
                        time=time.time() if wall_time is None else wall_time,
                        **data,
                    )
                )
                + "\n"
            )
            self._jsonl.flush()
        if self._tb:
            for k, v in data.items():
                try:
                    self._tb.add_scalar(k, v, step, walltime=wall_time)
                except Exception:
                    if k not in self._tb_failed_keys:
                        self._tb_failed_keys.add(k)
                        logger.warning(
                            "tensorboard add_scalar(%r) failed; further "
                            "failures for this key are suppressed",
                            k, exc_info=True,
                        )

    def close(self):
        """Idempotent."""
        if self._jsonl:
            self._jsonl.close()
            self._jsonl = None
        if self._tb:
            self._tb.close()
            self._tb = None
