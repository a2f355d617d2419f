"""Merge per-worker span flushes into one multi-process trace (the
counterpart of ``areal_tpu/system/tracejoin.py``; either package's flushes
read alike).

Every worker's :func:`areal_tpu_torch.base.tracing.flush` appends completed
spans (each stamped with worker name, pid, trace/span/parent ids, wall
start, duration, error flag, attrs) as jsonl under
``<fileroot>/trace_spans/``. This module joins those files back into a
single timeline:

- :func:`scan` — load every flushed span under a fileroot;
- :func:`chrome_trace` / :func:`write_chrome_trace` — the merged
  Chrome-``trace_event`` / Perfetto JSON (one ``pid`` row per worker, one
  ``X`` event per span, trace/span ids + attrs in ``args``) — load it in
  ``chrome://tracing`` or https://ui.perfetto.dev;
- :func:`resolve_trace_id` — map an operator-supplied needle (full or
  prefixed trace id, gateway ``rid``, RL ``qid``) to a trace id;
- :func:`span_tree` / :func:`render_tree` — one request's spans as a
  parent/child tree, the renderer behind ``obs --trace``.

CLI::

    python -m areal_tpu_torch.system.tracejoin <fileroot> [--out trace.json]
        [--trace <request-id|qid>]
"""

import argparse
import glob
import json
import os
import sys
from typing import Dict, List, Optional

from areal_tpu_torch.base import constants


def scan(fileroot: Optional[str] = None) -> List[dict]:
    """Every flushed span under ``<fileroot>/trace_spans/*.jsonl``,
    sorted by wall start. Unparseable lines are skipped (a torn final
    line from a crashed worker must not hide the rest of the trace)."""
    root = (
        os.path.join(fileroot, "trace_spans")
        if fileroot is not None
        else constants.get_trace_span_root()
    )
    spans: List[dict] = []
    for path in sorted(glob.glob(os.path.join(root, "*.jsonl"))):
        try:
            with open(path) as f:
                for line in f:
                    line = line.strip()
                    if not line:
                        continue
                    try:
                        rec = json.loads(line)
                    except ValueError:
                        continue
                    if isinstance(rec, dict) and "span_id" in rec:
                        spans.append(rec)
        except OSError:
            continue
    spans.sort(key=lambda s: s.get("start", 0.0))
    return spans


def _span_attrs(s: dict) -> Dict[str, object]:
    a = s.get("attrs") or {}
    return a if isinstance(a, dict) else {}


def resolve_trace_id(spans: List[dict], needle: str) -> Optional[str]:
    """Trace id for an operator-supplied needle: a full/prefixed trace
    id, a request id (``rid`` attr — the gateway's ``gw-<16hex>`` or the
    RL ``{qid}-<8hex>``), or a bare RL ``qid``. Returns the newest match
    so a re-used qid resolves to its latest trajectory."""
    if not needle:
        return None
    best: Optional[str] = None
    for s in spans:  # spans are start-sorted: later match wins
        tid = s.get("trace_id")
        if not isinstance(tid, str):
            continue
        if tid == needle or (len(needle) >= 8 and tid.startswith(needle)):
            best = tid
            continue
        attrs = _span_attrs(s)
        rid = attrs.get("rid")
        qid = attrs.get("qid")
        if needle in (rid, qid):
            best = tid
        elif isinstance(rid, str) and rid.startswith(f"{needle}-"):
            # chunked/hedged rids suffix the base rid (-c<n>/-h<n>) and
            # RL rids suffix the qid — a base-id needle still joins
            best = tid
    return best


def trace_spans(spans: List[dict], trace_id: str) -> List[dict]:
    return [s for s in spans if s.get("trace_id") == trace_id]


def chrome_trace(spans: List[dict]) -> dict:
    """The Chrome-``trace_event`` JSON object for a span set: complete
    (``ph: "X"``) events in microseconds, one process row per worker
    (metadata ``process_name`` events), thread rows per recorded thread
    name. ``args`` carries the trace identity + attrs so Perfetto's
    search joins on trace id / rid / qid."""
    events: List[dict] = []
    pids: Dict[str, int] = {}
    tids: Dict[tuple, int] = {}
    for s in spans:
        worker = str(s.get("worker", s.get("pid", "?")))
        pid = pids.get(worker)
        if pid is None:
            pid = pids[worker] = len(pids) + 1
            events.append({
                "ph": "M", "name": "process_name", "pid": pid, "tid": 0,
                "args": {"name": worker},
            })
        thread = str(s.get("thread", "main"))
        tid = tids.get((worker, thread))
        if tid is None:
            tid = tids[(worker, thread)] = (
                len([1 for w, _t in tids if w == worker]) + 1
            )
            events.append({
                "ph": "M", "name": "thread_name", "pid": pid, "tid": tid,
                "args": {"name": thread},
            })
        args: Dict[str, object] = {
            "trace_id": s.get("trace_id"),
            "span_id": s.get("span_id"),
            "parent_id": s.get("parent_id"),
        }
        args.update(_span_attrs(s))
        if s.get("error"):
            args["error"] = True
            if s.get("exc"):
                args["exc"] = s["exc"]
        events.append({
            "ph": "X",
            "name": str(s.get("name", "?")),
            "cat": "span" if not s.get("error") else "span,error",
            "pid": pid,
            "tid": tid,
            "ts": float(s.get("start", 0.0)) * 1e6,
            "dur": max(float(s.get("dur_s", 0.0)) * 1e6, 1.0),
            "args": args,
        })
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def write_chrome_trace(
    path: str,
    fileroot: Optional[str] = None,
    trace_id: Optional[str] = None,
) -> int:
    """Merge every flushed span under ``fileroot`` (optionally filtered
    to one trace) into a Chrome trace JSON at ``path``; returns the span
    count written. Atomic (tmp + replace), so a watcher never reads a
    torn file."""
    spans = scan(fileroot)
    if trace_id is not None:
        spans = trace_spans(spans, trace_id)
    doc = chrome_trace(spans)
    tmp = f"{path}.tmp"
    with open(tmp, "w") as f:
        json.dump(doc, f)
    os.replace(tmp, path)
    return len(spans)


# --------------------------------------------------------------------- #
# Span tree (obs --trace)
# --------------------------------------------------------------------- #


def span_tree(spans: List[dict], trace_id: str) -> List[dict]:
    """The trace's spans as root nodes with nested ``children``, ordered
    by start time. A span whose parent never flushed (ring overwrite,
    crashed worker) is promoted to a root rather than dropped."""
    mine = sorted(
        trace_spans(spans, trace_id), key=lambda s: s.get("start", 0.0)
    )
    nodes = {s["span_id"]: {**s, "children": []} for s in mine}
    roots: List[dict] = []
    for s in mine:
        node = nodes[s["span_id"]]
        parent = nodes.get(s.get("parent_id"))
        if parent is not None and parent is not node:
            parent["children"].append(node)
        else:
            roots.append(node)
    return roots


def render_tree(spans: List[dict], trace_id: str) -> str:
    """Terminal rendering of one trace's span tree — what
    ``python -m areal_tpu_torch.apps.obs --trace <id>`` prints."""
    roots = span_tree(spans, trace_id)
    if not roots:
        return f"trace {trace_id}: no spans found"
    n = len(trace_spans(spans, trace_id))
    workers = sorted({str(s.get("worker", "?")) for s in spans
                      if s.get("trace_id") == trace_id})
    t0 = min(r["start"] for r in roots)
    lines = [
        f"trace {trace_id} — {n} span(s) across "
        f"{len(workers)} worker(s): {', '.join(workers)}"
    ]

    def emit(node: dict, depth: int) -> None:
        attrs = _span_attrs(node)
        extra = "".join(
            f" {k}={attrs[k]}" for k in ("rid", "qid") if k in attrs
        )
        err = ""
        if node.get("error"):
            err = f" ERROR({node.get('exc', '?')})"
        lines.append(
            f"  {'  ' * depth}{node.get('name', '?')}"
            f"  +{(node.get('start', t0) - t0) * 1e3:.1f}ms"
            f"  {node.get('dur_s', 0.0) * 1e3:.1f}ms"
            f"  [{node.get('worker', '?')}]{extra}{err}"
        )
        for c in node["children"]:
            emit(c, depth + 1)

    for r in roots:
        emit(r, 0)
    return "\n".join(lines)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="areal_tpu_torch.system.tracejoin",
        description="Merge per-worker span flushes into one Chrome trace",
    )
    p.add_argument("fileroot", nargs="?", default=None,
                   help="fileroot the workers flushed under "
                        "(default: $AREAL_FILEROOT)")
    p.add_argument("--out", default=None,
                   help="write the merged Chrome trace JSON here")
    p.add_argument("--trace", default=None, metavar="ID",
                   help="filter to one request: trace id (or prefix), "
                        "gateway rid, or RL qid")
    args = p.parse_args(argv)

    spans = scan(args.fileroot)
    trace_id = None
    if args.trace:
        trace_id = resolve_trace_id(spans, args.trace)
        if trace_id is None:
            print(f"no trace matches {args.trace!r}", file=sys.stderr)
            return 1
        print(render_tree(spans, trace_id))
    if args.out:
        n = write_chrome_trace(args.out, args.fileroot, trace_id)
        print(f"wrote {n} span(s) to {args.out}", file=sys.stderr)
    elif not args.trace:
        print(f"{len(spans)} span(s) flushed; pass --out to merge them",
              file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
