"""The campaign report: one rendering of a run's telemetry artifacts (a
copy of erlamsa_tpu/obs/report.py over the port's artifacts).

``build_report`` folds the three artifact families a campaign leaves
behind — the metrics snapshot (services.metrics.Counters.snapshot),
the merged Chrome-trace document (obs/trace.export) and the federation
snapshot (obs/federate.snapshot) — into one plain-dict report:
per-stage cost ledger (seconds, share of wall, overlap), throughput,
transport bytes, resilience/fault tallies, coverage plane, per-node
worker totals, and a span census from the trace.

``render_text`` turns that dict into the human report; ``main`` is the
CLI:

    python -m erlamsa_tpu_torch.obs.report --metrics M.json \\
        [--trace T.json] [--flight F.json] [--json OUT]

over the files of ``python -m erlamsa_tpu_torch ... --metrics-out M.json
--trace T.json`` (and a ``--flight-dir`` dump). The federation snapshot
is an optional input of ``build_report`` only: the port has no fleet to
write one yet. Everything here is read-only over already-written
artifacts — stdlib-pure, no services import, safe from any process.
"""

from __future__ import annotations

import argparse
import json
import sys


def _stage_table(pipeline: dict) -> list[dict]:
    """Per-stage cost ledger rows, sorted by spent seconds descending."""
    stages = (pipeline or {}).get("stages") or {}
    total = sum(stages.values()) or 0.0
    rows = [
        {"stage": name, "seconds": round(float(secs), 3),
         "share_pct": round(100.0 * float(secs) / total, 1) if total else 0.0}
        for name, secs in stages.items()
    ]
    rows.sort(key=lambda r: (-r["seconds"], r["stage"]))
    return rows


def _span_census(trace_doc: dict) -> dict:
    """Fold a Chrome-trace document into {span name: {count, total_ms}}
    plus the fleet shape (nodes seen, remote span count, trace_id)."""
    events = (trace_doc or {}).get("traceEvents") or []
    census: dict[str, dict] = {}
    pids: set = set()
    nodes: dict = {}
    for ev in events:
        ph = ev.get("ph")
        if ph == "M":
            if ev.get("name") == "process_name":
                name = (ev.get("args") or {}).get("name", "")
                if str(name).startswith("worker:"):
                    nodes[ev.get("pid")] = str(name)[len("worker:"):]
            continue
        if ph != "X":
            continue
        pids.add(ev.get("pid"))
        row = census.setdefault(ev.get("name", "?"),
                                {"count": 0, "total_ms": 0.0})
        row["count"] += 1
        row["total_ms"] += float(ev.get("dur", 0)) / 1000.0
    for row in census.values():
        row["total_ms"] = round(row["total_ms"], 3)
    other = (trace_doc or {}).get("otherData") or {}
    return {
        "trace_id": other.get("trace_id", ""),
        "dropped_events": other.get("dropped_events", 0),
        "processes": len(pids),
        "worker_nodes": sorted(nodes.values()),
        "spans": dict(sorted(census.items())),
    }


def _flight_summary(entries: list) -> dict:
    """Count flight-ring entries by kind and by node (federated rings
    carry a node stamp; local entries count under "local")."""
    kinds: dict[str, int] = {}
    by_node: dict[str, int] = {}
    for e in entries or []:
        if not isinstance(e, dict):
            continue
        if e.get("kind") is not None:
            k = str(e["kind"])
        elif e.get("type") == "span":
            k = "span:" + str(e.get("name", "?"))
        else:
            k = str(e.get("type", "?"))
        kinds[k] = kinds.get(k, 0) + 1
        node = str(e.get("node", "local"))
        by_node[node] = by_node.get(node, 0) + 1
    return {"entries": sum(kinds.values()),
            "kinds": dict(sorted(kinds.items())),
            "by_node": dict(sorted(by_node.items()))}


def build_report(metrics_snap: dict | None = None,
                 trace_doc: dict | None = None,
                 flight_entries: list | None = None,
                 federation_snap: dict | None = None) -> dict:
    """Fold campaign artifacts into the report dict. Every input is
    optional — a missing artifact yields an absent/empty section, never
    an error, so the CLI works on whatever a run left behind."""
    snap = metrics_snap or {}
    pipeline = snap.get("pipeline") or {}
    resilience = snap.get("resilience") or {}
    report: dict = {
        "campaign": {
            "samples": snap.get("samples", 0),
            "batches": snap.get("batches", 0),
            "bytes_out": snap.get("bytes_out", 0),
            "wall_s": snap.get("wall_s", 0.0),
            "device_s": snap.get("device_s", 0.0),
            "samples_per_sec": snap.get("samples_per_sec", 0.0),
            "host_tail_pct": snap.get("host_tail_pct", 0.0),
            "degraded": (resilience or {}).get("degraded", 0),
        },
        "stages": {
            "ledger": _stage_table(pipeline),
            "wall_s": pipeline.get("wall_s", 0.0),
            "overlap_ratio": pipeline.get("overlap_ratio", 0.0),
            "device_idle_frac": pipeline.get("device_idle_frac", 0.0),
            "drain_backlog_peak": pipeline.get("drain_backlog_peak", 0),
            "reduce_overlap": pipeline.get("reduce_overlap", 0.0),
        },
        "transport": dict(snap.get("fleet_transport") or {}),
        "resilience": {
            "events": dict(sorted((resilience.get("events") or {}).items())),
            "faults": dict(sorted((resilience.get("faults") or {}).items())),
        },
        "coverage": dict(snap.get("coverage") or {}),
        "gen": dict(snap.get("gen") or {}),
    }
    if trace_doc is not None:
        report["trace"] = _span_census(trace_doc)
    if flight_entries is not None:
        report["flight"] = _flight_summary(flight_entries)
    if federation_snap is not None:
        fleet = {}
        for node, totals in sorted(
                (federation_snap.get("nodes") or {}).items()):
            c = (totals or {}).get("counters") or {}
            fleet[node] = {
                "samples": c.get("samples", 0),
                "batches": c.get("batches", 0),
                "device_s": c.get("device_s", 0.0),
                "degraded": c.get("degraded", 0),
                "telemetry_frames": (federation_snap.get("ingests")
                                     or {}).get(node, 0),
                "stages": dict((totals or {}).get("stages") or {}),
            }
        report["fleet"] = fleet
    return report


def render_text(report: dict) -> str:
    """The human rendering — same dict the JSON output carries."""
    out: list[str] = []
    w = out.append
    camp = report.get("campaign") or {}
    w("== erlamsa_tpu campaign report ==")
    w("samples %d  batches %d  bytes_out %d" % (
        camp.get("samples", 0), camp.get("batches", 0),
        camp.get("bytes_out", 0)))
    w("wall %.3fs  device %.3fs  %.1f samples/s  host-tail %.2f%%%s" % (
        camp.get("wall_s", 0.0), camp.get("device_s", 0.0),
        camp.get("samples_per_sec", 0.0), camp.get("host_tail_pct", 0.0),
        "  [DEGRADED]" if camp.get("degraded") else ""))

    stages = report.get("stages") or {}
    ledger = stages.get("ledger") or []
    if ledger:
        w("")
        w("-- stage ledger (pipeline wall %.3fs, overlap %.2fx, "
          "device idle %.0f%%) --" % (
              stages.get("wall_s", 0.0), stages.get("overlap_ratio", 0.0),
              100.0 * stages.get("device_idle_frac", 0.0)))
        width = max(len(r["stage"]) for r in ledger)
        for r in ledger:
            w("  %-*s %9.3fs %6.1f%%" % (width, r["stage"], r["seconds"],
                                         r["share_pct"]))

    transport = report.get("transport") or {}
    if any(transport.values()):
        w("")
        w("-- transport --")
        w("  sent %dB  recv %dB  round-trips %d" % (
            transport.get("bytes_sent", 0), transport.get("bytes_recv", 0),
            transport.get("round_trips", 0)))

    res = report.get("resilience") or {}
    events, faults = res.get("events") or {}, res.get("faults") or {}
    if events or faults:
        w("")
        w("-- resilience --")
        for kind, n in events.items():
            w("  event %-24s %d" % (kind, n))
        for site, n in faults.items():
            w("  fault %-24s %d" % (site, n))

    cov = report.get("coverage") or {}
    if cov.get("folds") or cov.get("frames"):
        w("")
        w("-- coverage --")
        w("  frames %d (stale %d torn %d)  folds %d  edges %d "
          "(+%d new)  distilled %d%s" % (
              cov.get("frames", 0), cov.get("stale", 0), cov.get("torn", 0),
              cov.get("folds", 0), cov.get("edges", 0),
              cov.get("new_edges", 0), cov.get("distilled", 0),
              "  [DEGRADED]" if cov.get("degraded") else ""))

    fleet = report.get("fleet") or {}
    if fleet:
        w("")
        w("-- fleet (%d worker node%s) --" % (
            len(fleet), "" if len(fleet) == 1 else "s"))
        for node, t in fleet.items():
            w("  %-22s samples %-8d batches %-6d device %.3fs  "
              "telemetry %d%s" % (
                  node, t.get("samples", 0), t.get("batches", 0),
                  t.get("device_s", 0.0), t.get("telemetry_frames", 0),
                  "  [DEGRADED]" if t.get("degraded") else ""))

    tr = report.get("trace") or {}
    spans = tr.get("spans") or {}
    if spans:
        w("")
        w("-- trace %s (%d process%s%s, %d dropped) --" % (
            tr.get("trace_id", "?"), tr.get("processes", 0),
            "" if tr.get("processes", 0) == 1 else "es",
            ", workers: " + ", ".join(tr.get("worker_nodes") or [])
            if tr.get("worker_nodes") else "",
            tr.get("dropped_events", 0)))
        width = max(len(n) for n in spans)
        for name, row in spans.items():
            w("  %-*s x%-6d %10.3fms" % (width, name, row["count"],
                                         row["total_ms"]))

    fl = report.get("flight") or {}
    if fl.get("entries"):
        w("")
        w("-- flight ring (%d entries) --" % fl["entries"])
        for kind, n in (fl.get("kinds") or {}).items():
            w("  %-24s %d" % (kind, n))
    w("")
    return "\n".join(out)


def _load(path: str) -> dict | list | None:
    if not path:
        return None
    with open(path) as f:
        return json.load(f)


def _load_flight(path: str) -> list | None:
    """Flight dumps are JSONL (obs/flight.dump): a meta line then one
    entry per line. A plain JSON list is accepted too."""
    if not path:
        return None
    with open(path) as f:
        text = f.read()
    try:
        doc = json.loads(text)
        return doc if isinstance(doc, list) else doc.get("entries", [])
    except ValueError:
        entries = []
        for line in text.splitlines():
            line = line.strip()
            if not line:
                continue
            entry = json.loads(line)
            if isinstance(entry, dict) and entry.get("type") != "meta":
                entries.append(entry)
        return entries


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m erlamsa_tpu_torch.obs.report",
        description="Render the campaign report from a run's telemetry "
                    "artifacts (metrics snapshot, merged trace, flight "
                    "dump).")
    ap.add_argument("--metrics", help="metrics snapshot JSON "
                    "(--metrics-out / faas stats / bench record)")
    ap.add_argument("--trace", help="Chrome-trace JSON (--trace export)")
    ap.add_argument("--flight", help="flight-recorder dump JSON")
    ap.add_argument("--json", dest="json_out",
                    help="also write the report dict as JSON here")
    args = ap.parse_args(argv)
    if not (args.metrics or args.trace or args.flight):
        ap.error("need at least one artifact "
                 "(--metrics / --trace / --flight)")
    try:
        metrics_snap = _load(args.metrics)
        trace_doc = _load(args.trace)
        flight_entries = _load_flight(args.flight)
    except (OSError, ValueError) as e:
        print("report: cannot read artifact: %s" % e, file=sys.stderr)
        return 1
    report = build_report(metrics_snap=metrics_snap, trace_doc=trace_doc,
                          flight_entries=flight_entries)
    if args.json_out:
        try:
            with open(args.json_out, "w") as f:
                json.dump(report, f, indent=2, sort_keys=True)
        except OSError as e:
            print("report: cannot write %s: %s" % (args.json_out, e),
                  file=sys.stderr)
            return 1
    print(render_text(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())
