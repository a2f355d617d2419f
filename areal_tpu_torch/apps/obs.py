"""Live fleet-observability CLI (the counterpart of
``areal_tpu/apps/obs.py``).

Tails the telemetry plane of a running (or just-finished) trial and renders
a per-worker table plus the merged fleet view — staleness/latency
percentiles, fleet-total counters, and per-server breaker states — straight
from the per-worker snapshots the exporters publish through name_resolve.
No trainer involvement: this reads the same channel the trainer's ``fleet/``
jsonl record is built from.

Usage::

    python -m areal_tpu_torch.apps.obs <fileroot> [--experiment E --trial T]
        [--once] [--interval 2.0] [--json] [--trace <request-id|qid>]

``<fileroot>`` is the experiment fileroot (the launcher's ``fileroot``
config); the file-backed name_resolve lives under ``<fileroot>/
name_resolve``. Without ``--experiment/--trial`` the trial with the newest
snapshot is picked. ``--once`` renders a single frame (scripts/tests);
the default loops until Ctrl-C. Workers only publish when
``AREAL_TELEMETRY_EXPORT`` is enabled on the trial.

``--trace`` switches to the distributed-tracing view: it joins the per-worker
span flushes under ``<fileroot>/trace_spans/`` and renders one request's
span tree. The needle may be a trace id (or ≥8-char prefix), a gateway
request id (``gw-<16hex>``), or an RL ``qid``.
"""

import argparse
import json
import os
import sys
import time
from typing import Dict, List, Optional, Tuple

from areal_tpu_torch.base import name_resolve, names
from areal_tpu_torch.system import telemetry, tracejoin


def _configure_name_resolve(fileroot: str):
    name_resolve.reconfigure(
        name_resolve.NameResolveConfig(
            type="file", root=os.path.join(fileroot, "name_resolve")
        )
    )


def discover_trials() -> List[Tuple[str, str, float]]:
    """(experiment, trial, newest-snapshot-time) for every trial with
    published telemetry."""
    try:
        keys = name_resolve.find_subtree(names.ROOT)
    except name_resolve.NameEntryNotFoundError:
        return []
    newest: Dict[Tuple[str, str], float] = {}
    for k in keys:
        parts = k.split("/")
        # areal_tpu/<exp>/<trial>/telemetry/<worker...>
        if len(parts) >= 5 and parts[0] == names.ROOT and parts[3] == "telemetry":
            exp, trial = parts[1], parts[2]
            t = newest.get((exp, trial), 0.0)
            try:
                snap = json.loads(name_resolve.get(k))
                t = max(t, float(snap.get("time", 0.0)))
            except Exception:
                pass
            newest[(exp, trial)] = t
    return sorted(
        [(e, t, ts) for (e, t), ts in newest.items()], key=lambda r: -r[2]
    )


def _fmt(v: float) -> str:
    if v == 0:
        return "0"
    if abs(v) >= 1000:
        return f"{v:,.0f}"
    if abs(v) >= 1:
        return f"{v:.2f}".rstrip("0").rstrip(".")
    return f"{v:.4f}".rstrip("0").rstrip(".")


_ROLE_HEADLINE = {
    # role -> (label, counter key) shown in the per-worker "work" column
    "trainer": ("steps", "train/steps"),
    "rollout": ("pushed", "rollout/pushed"),
    "gen_server": ("served", "gen/served"),
    "manager": ("scheduled", "manager/schedule_requests"),
    "gateway": ("completed", "gw/completed"),
    # elastic world supervisor: rank relaunches headline the recovery
    # activity; its step gauge is the current world epoch
    "supervisor": ("restarts", "ft/rank_restarts"),
}


def render(agg: "telemetry.FleetAggregate", now: Optional[float] = None) -> str:
    now = time.time() if now is None else now
    lines: List[str] = []
    w_col = max([len("worker")] + [len(w["worker"]) for w in agg.workers])
    lines.append(
        f"{'worker':<{w_col}}  {'role':<10} {'pid':>7} {'step':>7} "
        f"{'age_s':>6}  {'work':>16}  {'ft_total':>8}  longest open span"
    )
    for w in agg.workers:
        label, key = _ROLE_HEADLINE.get(w["role"], ("-", None))
        work = (
            f"{label}={_fmt(w['counters'].get(key, 0.0))}"
            if key is not None
            else "-"
        )
        ft_total = sum(
            v for k, v in w["counters"].items() if k.startswith("ft/")
        )
        spans = sorted(
            w.get("spans") or [], key=lambda s: -s.get("elapsed_s", 0.0)
        )
        span = (
            f"{spans[0]['name']} ({spans[0]['elapsed_s']:.1f}s)"
            if spans
            else "-"
        )
        lines.append(
            f"{w['worker']:<{w_col}}  {w['role']:<10} "
            f"{w.get('pid') or '-':>7} {w['step']:>7} "
            f"{max(now - w['time'], 0.0):>6.1f}  {work:>16}  "
            f"{_fmt(ft_total):>8}  {span}"
        )
    if agg.server_states:
        lines.append("")
        lines.append("gen-server breakers:")
        for url, state in sorted(agg.server_states.items()):
            lines.append(f"  {url:<40} {state}")
    drafted = agg.counters.get("gen/spec_draft_tokens", 0.0)
    if drafted:
        # speculative-decoding fleet summary: realized accept rate (the
        # breakeven signal /spec_decode acts on) plus the draft-model
        # pool bytes when a TransformerDrafter is serving
        accepted = agg.counters.get("gen/spec_accepted_tokens", 0.0)
        draft_bytes = sum(
            (w.get("gauges") or {}).get("draft_kv_pool_bytes", 0.0)
            for w in agg.workers
        )
        row = (
            f"spec decode: drafted={_fmt(drafted)} "
            f"accepted={_fmt(accepted)} "
            f"accept_rate={accepted / max(drafted, 1.0):.3f}"
        )
        if draft_bytes:
            row += f"  draft_kv_pool={draft_bytes / 2**20:.1f}MiB"
        lines.append("")
        lines.append(row)
    if agg.histograms:
        lines.append("")
        lines.append(
            f"{'distribution':<22} {'count':>8} {'mean':>10} {'p50':>10} "
            f"{'p95':>10} {'p99':>10} {'max':>10}"
        )
        for name in sorted(agg.histograms):
            s = agg.histograms[name].summary()
            if not s.get("count"):
                continue
            lines.append(
                f"{name:<22} {int(s['count']):>8} {_fmt(s['mean']):>10} "
                f"{_fmt(s['p50']):>10} {_fmt(s['p95']):>10} "
                f"{_fmt(s['p99']):>10} {_fmt(s['max']):>10}"
            )
    nonzero = {
        k: v
        for k, v in sorted(agg.counters.items())
        if v and agg.kinds.get(k) != "histogram"
    }
    if nonzero:
        lines.append("")
        lines.append("fleet totals (nonzero):")
        for k, v in nonzero.items():
            lines.append(f"  {k:<40} {_fmt(v)}")
    return "\n".join(lines)


def render_frame(experiment: str, trial: str, as_json: bool) -> Optional[str]:
    snaps = telemetry.collect_snapshots(experiment, trial)
    if not snaps:
        return None
    agg = telemetry.aggregate(snaps)
    if as_json:
        return json.dumps(agg.scalars(), sort_keys=True)
    header = (
        f"trial {experiment}/{trial} — {len(agg.workers)} workers, "
        f"{time.strftime('%H:%M:%S')}"
    )
    return header + "\n" + render(agg)


def render_trace(fileroot: str, needle: str) -> Optional[str]:
    """The ``--trace`` view: resolve the needle against the flushed spans
    and render the request's span tree (None when nothing matches)."""
    spans = tracejoin.scan(fileroot)
    trace_id = tracejoin.resolve_trace_id(spans, needle)
    if trace_id is None:
        return None
    return tracejoin.render_tree(spans, trace_id)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="areal_tpu_torch.apps.obs", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    p.add_argument("fileroot", help="experiment fileroot (launcher config)")
    p.add_argument("--experiment", default=None)
    p.add_argument("--trial", default=None)
    p.add_argument("--once", action="store_true", help="render one frame")
    p.add_argument("--interval", type=float, default=2.0)
    p.add_argument("--json", action="store_true", dest="as_json",
                   help="emit the flat fleet/ scalar dict as JSON")
    p.add_argument("--trace", default=None, metavar="ID",
                   help="render one request's span tree: trace id (or "
                        "prefix), gateway rid, or RL qid")
    args = p.parse_args(argv)

    if args.trace is not None:
        tree = render_trace(args.fileroot, args.trace)
        if tree is None:
            print(
                f"no trace matches {args.trace!r} under "
                f"{args.fileroot}/trace_spans — are span flushes enabled "
                "(AREAL_TRACE_SPANS) and has a flush interval elapsed?",
                file=sys.stderr,
            )
            return 1
        print(tree)
        return 0

    _configure_name_resolve(args.fileroot)
    experiment, trial = args.experiment, args.trial
    if experiment is None or trial is None:
        trials = discover_trials()
        if not trials:
            print(
                "no telemetry published under "
                f"{args.fileroot}/name_resolve — is AREAL_TELEMETRY_EXPORT "
                "enabled on the trial?",
                file=sys.stderr,
            )
            return 1
        experiment, trial = trials[0][0], trials[0][1]

    while True:
        frame = render_frame(experiment, trial, args.as_json)
        if frame is None:
            print(
                f"no telemetry for {experiment}/{trial}", file=sys.stderr
            )
            return 1
        print(frame, flush=True)
        if args.once:
            return 0
        try:
            time.sleep(args.interval)
        except KeyboardInterrupt:
            return 0


if __name__ == "__main__":
    sys.exit(main())
