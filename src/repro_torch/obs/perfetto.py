"""Chrome/Perfetto trace-event exporter.

Serializes a ``TraceRecorder`` into the Chrome trace-event JSON format
(the ``{"traceEvents": [...]}`` object form), which ``ui.perfetto.dev``
and ``chrome://tracing`` load directly:

  * pid 1 "pipeline": one tid per lane (step, compute, stalls, host link,
    HBM fill, prefetch queue, ...) — per-lane busy spans as "X" complete
    events, ledger transitions as "i" instants, occupancy as "C" counters;
  * pid 2 "requests": one tid per request id — the derived lifecycle state
    spans (queued / prefill / decode / swapped) plus transition instants,
    so one row per request reads top-to-bottom like its life story.

Timestamps are microseconds (the format's unit), kept as floats — no
rounding is introduced, so span adjacency survives export exactly and the
trace-invariant checker can assert per-lane non-overlap without slack.

Schedule-determined events carry their canonical key in ``args.sched`` as a
JSON string; ``tools/check_trace.py --compare`` matches those sequences
between an engine trace and a sim trace of the same workload.

All output goes through ``json_safe``: NaN/Inf are legal Python floats but
illegal JSON, so they serialize as ``null`` instead of the non-standard
``NaN`` token ``json.dumps`` would otherwise emit.
"""
from __future__ import annotations

import json
import math
from typing import Dict, List

from repro_torch.obs.trace import PIPELINE_LANES, TraceRecorder

PID_PIPELINE = 1
PID_REQUESTS = 2


def json_safe(obj):
    """Recursively replace NaN/Inf floats with None (JSON ``null``)."""
    if isinstance(obj, float):
        return obj if math.isfinite(obj) else None
    if isinstance(obj, dict):
        return {k: json_safe(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [json_safe(v) for v in obj]
    return obj


def dump_json(path: str, obj) -> None:
    """NaN-safe JSON dump — the one writer every metrics/trace export
    uses, so no machine-readable record ever carries a ``NaN`` token."""
    with open(path, "w") as f:
        json.dump(json_safe(obj), f, indent=2)
        f.write("\n")


def to_chrome(rec: TraceRecorder) -> Dict[str, object]:
    """Build the Chrome trace-event object form from recorded events."""
    rec.close()
    events: List[dict] = []

    def meta(pid: int, tid: int, what: str, name: str, idx: int) -> None:
        events.append({"name": what, "ph": "M", "pid": pid, "tid": tid,
                       "args": {"name": name}})
        events.append({"name": f"{what.split('_')[0]}_sort_index", "ph": "M",
                       "pid": pid, "tid": tid, "args": {"sort_index": idx}})

    events.append({"name": "process_name", "ph": "M", "pid": PID_PIPELINE,
                   "args": {"name": f"pipeline ({rec.backend})"}})
    events.append({"name": "process_name", "ph": "M", "pid": PID_REQUESTS,
                   "args": {"name": "requests"}})

    lane_tid = {lane: i + 1 for i, lane in enumerate(PIPELINE_LANES)}
    used_lanes = set()
    used_rids = set()

    for e in rec.events:
        if e.lane == "request":
            pid, tid = PID_REQUESTS, (e.rid or 0) + 1
            used_rids.add(e.rid or 0)
        else:
            lane = e.lane if e.lane in lane_tid else e.name
            if lane not in lane_tid:
                lane_tid[lane] = len(lane_tid) + 1
            pid, tid = PID_PIPELINE, lane_tid[lane]
            used_lanes.add(lane)
        out = {"name": e.name, "ph": e.ph, "pid": pid, "tid": tid,
               "ts": e.ts * 1e6, "cat": e.lane}
        args = dict(e.args)
        if e.step is not None:
            args["step"] = e.step
        if e.rid is not None:
            args["rid"] = e.rid
        if e.sched is not None:
            args["sched"] = json.dumps(e.sched)
        if e.ph == "X":
            out["dur"] = e.dur * 1e6
        elif e.ph == "i":
            out["s"] = "t"  # thread-scoped instant
        elif e.ph == "C":
            args = {"value": e.args.get("value", 0)}
        out["args"] = args
        events.append(out)

    for lane, tid in lane_tid.items():
        if lane in used_lanes:
            meta(PID_PIPELINE, tid, "thread_name", lane, tid)
    for rid in sorted(used_rids):
        meta(PID_REQUESTS, rid + 1, "thread_name", f"req {rid}", rid)

    return {
        "traceEvents": events,
        "displayTimeUnit": "ms",
        "otherData": {
            "backend": rec.backend,
            "clock": "simulated" if rec.manual_clock else "wall",
            "generator": "repro_torch.obs",
        },
    }


def export_chrome(rec: TraceRecorder, path: str) -> str:
    """Write ``rec`` as a Chrome/Perfetto ``trace.json``; returns ``path``."""
    dump_json(path, to_chrome(rec))
    return path
