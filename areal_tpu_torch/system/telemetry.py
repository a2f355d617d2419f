"""Fleet telemetry plane: per-worker snapshots and their aggregation (the
counterpart of ``areal_tpu/system/telemetry.py``).

- Every worker process publishes a JSON **snapshot** of its
  ``metrics.counters`` registry (scalar counters with kinds, histogram
  bucket states, open spans, role gauges) under
  ``names.telemetry(<exp>, <trial>, <worker>)`` in name_resolve, beside
  its heartbeat (``worker_base.TelemetryExporter``).
- The trainer, the manager and the ops CLI **collect** the snapshots and
  **aggregate** them by kind: sums add up, peaks and gauges take the fleet
  max, histograms merge bucket-wise so fleet percentiles are exact.
- The aggregate flattens into the ``fleet/`` scalars ``MetricLogger``
  writes.

The snapshot layout is the reference's, so either package's aggregator
reads either package's workers.
"""

import json
import os
import time
from typing import Dict, List, Optional

from areal_tpu_torch.base import logging, name_resolve, names, tracing
from areal_tpu_torch.base import metrics as metrics_mod

logger = logging.getLogger("telemetry")

SNAPSHOT_VERSION = 1


def build_snapshot(
    worker_name: str,
    role: str,
    step: int = 0,
    registry: Optional[metrics_mod.CounterRegistry] = None,
    gauges: Optional[Dict[str, float]] = None,
    server_states: Optional[Dict[str, str]] = None,
) -> dict:
    """One worker's full telemetry state as a JSON-serializable dict."""
    reg = registry if registry is not None else metrics_mod.counters
    snap = {
        "v": SNAPSHOT_VERSION,
        "worker": worker_name,
        "role": role,
        "step": int(step),
        "pid": os.getpid(),
        "time": time.time(),
        "spans": tracing.live_spans(),
        "gauges": dict(gauges or {}),
    }
    snap.update(reg.export_state())
    if server_states:
        snap["server_states"] = dict(server_states)
    return snap


def publish_snapshot(experiment_name: str, trial_name: str, snap: dict):
    name_resolve.add(
        names.telemetry(experiment_name, trial_name, snap["worker"]),
        json.dumps(snap),
        replace=True,
    )


def collect_snapshots(experiment_name: str, trial_name: str) -> List[dict]:
    """Every currently-published worker snapshot (malformed ones skipped
    loudly — one corrupt writer must not blind the whole plane). Keys are
    read one by one, not via ``get_subtree``: the file-backed sweep is
    non-atomic, so a worker deleting its entry mid-walk (trial teardown)
    must lose only its own snapshot, not the whole collection."""
    root = names.telemetry_root(experiment_name, trial_name)
    out = []
    for k in name_resolve.find_subtree(root):
        try:
            r = name_resolve.get(k)
        except name_resolve.NameEntryNotFoundError:
            continue  # writer exited between the walk and the read
        try:
            d = json.loads(r)
            if isinstance(d, dict) and "worker" in d:
                out.append(d)
        except (ValueError, TypeError):
            logger.warning("skipping malformed telemetry snapshot %s", k)
    return out


class FleetAggregate:
    """Merged view over a set of worker snapshots."""

    def __init__(self):
        self.workers: List[dict] = []       # per-worker metadata + gauges
        self.counters: Dict[str, float] = {}
        self.kinds: Dict[str, str] = {}
        self.histograms: Dict[str, metrics_mod.Histogram] = {}
        self.server_states: Dict[str, str] = {}

    def merge_snapshot(self, snap: dict) -> None:
        self.workers.append(
            {
                "worker": snap.get("worker", "?"),
                "role": snap.get("role", "?"),
                "step": snap.get("step", 0),
                "pid": snap.get("pid"),
                "time": snap.get("time", 0.0),
                "gauges": snap.get("gauges", {}),
                "counters": snap.get("counters", {}),
                "histograms": snap.get("histograms", {}),
                "spans": snap.get("spans", []),
            }
        )
        kinds = snap.get("kinds", {})
        for k, v in snap.get("counters", {}).items():
            kind = kinds.get(k, metrics_mod.METRIC_KINDS.get(k))
            if kind is None:
                kind = metrics_mod.KIND_SUM
            self.kinds[k] = kind
            if kind in (metrics_mod.KIND_PEAK, metrics_mod.KIND_GAUGE):
                # peaks: fleet max by definition; gauges: a fleet of
                # identical-config workers reports one live setting, and
                # max is the conservative merge when they briefly differ
                # (e.g. adaptive spec-K retuning at different times)
                self.counters[k] = max(self.counters.get(k, float("-inf")), v)
            else:
                self.counters[k] = self.counters.get(k, 0.0) + v
        for k, state in snap.get("histograms", {}).items():
            try:
                h = metrics_mod.Histogram.from_state(state)
            except (KeyError, TypeError, ValueError):
                logger.warning("skipping malformed histogram state %r", k)
                continue
            if k in self.histograms:
                try:
                    self.histograms[k].merge(h)
                except ValueError:
                    logger.warning(
                        "histogram %r has mismatched boundaries across "
                        "workers; keeping the first", k,
                    )
            else:
                self.histograms[k] = h
        for url, state in snap.get("server_states", {}).items():
            self.server_states[url] = state

    def scalars(self) -> Dict[str, float]:
        """Flat scalar view for MetricLogger (caller applies the ``fleet``
        prefix): fleet-total counters (the full ``ft/`` catalog is
        zero-filled so a healthy fleet reports explicit zeros, not
        absence), merged-histogram summaries as ``<name>/<stat>``, breaker
        tallies, and summed worker gauges."""
        out: Dict[str, float] = {"workers": float(len(self.workers))}
        out["worker_pids"] = float(
            len({w.get("pid") for w in self.workers if w.get("pid")})
        )
        for k in _ft_catalog():
            out[k] = 0.0
        out.update(self.counters)
        for name, h in self.histograms.items():
            for stat, v in h.summary().items():
                out[f"{name}/{stat}"] = v
        if self.server_states:
            states = list(self.server_states.values())
            out["servers_total"] = float(len(states))
            for s in ("closed", "open", "half_open"):
                out[f"servers_{s}"] = float(states.count(s))
        gauge_sums: Dict[str, float] = {}
        for w in self.workers:
            for g, v in (w.get("gauges") or {}).items():
                try:
                    gauge_sums[g] = gauge_sums.get(g, 0.0) + float(v)
                except (TypeError, ValueError):
                    continue
        out.update(gauge_sums)
        return out


def _ft_catalog() -> List[str]:
    """Every ``ft/`` counter constant in the metrics catalog."""
    return [
        v
        for k, v in vars(metrics_mod).items()
        if k.startswith("FT_") and isinstance(v, str)
    ]


def aggregate(snapshots: List[dict]) -> FleetAggregate:
    agg = FleetAggregate()
    # deterministic merge order (and a stable per-worker table downstream)
    for snap in sorted(snapshots, key=lambda s: str(s.get("worker", ""))):
        agg.merge_snapshot(snap)
    return agg


def collect_fleet_scalars(
    experiment_name: str,
    trial_name: str,
    local_snapshot: Optional[dict] = None,
) -> Optional[Dict[str, float]]:
    """One aggregation pass: pull every published snapshot, optionally
    substitute the caller's LIVE registry for its own published (possibly
    stale) snapshot, and flatten. None when nothing is published yet."""
    snaps = collect_snapshots(experiment_name, trial_name)
    if local_snapshot is not None:
        snaps = [
            s for s in snaps if s.get("worker") != local_snapshot["worker"]
        ]
        snaps.append(local_snapshot)
    if not snaps:
        return None
    return aggregate(snaps).scalars()
