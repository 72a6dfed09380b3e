"""cephtop — cluster-wide per-stage op-latency breakdown.

Port of ``tools/cephtop.py``: the same panes and output over the port's
``core.admin_socket`` and ``core.perf``.  ``--device`` renders the
port's ``device compile dump``: the kernel build, the reference's
compile table (on the card: first launches and the build), launches per
kernel and the queue's batches.

Polls daemon admin sockets for `perf dump` (the osd.N.op per-stage
histograms + the osd.N.tpuq queue-stage set) and the per-daemon
`osd.N dump_historic_slow_ops` rings, merges them, and renders where
a write spends its time.

    python -m ceph_tpu_torch.tools.cephtop --socket /run/a.sock [--socket /run/b.sock]
    python -m ceph_tpu_torch.tools.cephtop --socket /run/a.sock --slow   # slow-op rings
    python -m ceph_tpu_torch.tools.cephtop --socket /run/a.sock --json

Stage rows are the `lat_*_us` histograms (see tracing.STAGES for the
pipeline order); p50/p99 are log2-bucket interpolations, identical to
the mgr `ops latency` merge.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Dict, Iterable, List

from ceph_tpu_torch.core.admin_socket import admin_command
from ceph_tpu_torch.core.perf import hist_summary, merge_stage_hists

# render order follows the write pipeline; anything else (reads,
# recovery, queue stages) appends alphabetically after
_STAGE_ORDER = [
    "lat_recv_us", "lat_queue_us", "lat_staging_us", "lat_admission_us",
    "lat_encode_fanout_us", "lat_encq_wait_us", "lat_device_us",
    "lat_encq_dispatch_us", "lat_fanout_rtt_us", "lat_commit_wait_us",
    "lat_ack_gate_us", "lat_reply_us", "lat_op_us",
]


def merge_op_hists(perf_dumps: Iterable[Dict]) -> Dict[str, dict]:
    """One socket = one process = one payload; the merge rules
    (op/tpuq filter, tpuq-exactly-once per process) live in
    core.perf.merge_stage_hists, shared with the mgr and bench."""
    return merge_stage_hists(perf_dumps)


def breakdown(merged: Dict[str, dict]) -> List[dict]:
    rows = []
    ordered = [s for s in _STAGE_ORDER if s in merged]
    ordered += sorted(s for s in merged if s not in _STAGE_ORDER)
    for stage in ordered:
        row = hist_summary(merged[stage])
        if not row["count"]:
            continue
        row["stage"] = stage
        rows.append(row)
    return rows


def render(rows: List[dict]) -> str:
    if not rows:
        return "no stage histograms yet (no tracked ops?)"
    widths = (max(len(r["stage"]) for r in rows), 10, 12, 12, 12)
    head = (f"{'stage':<{widths[0]}} {'count':>{widths[1]}} "
            f"{'p50_us':>{widths[2]}} {'p99_us':>{widths[3]}} "
            f"{'mean_us':>{widths[4]}}")
    lines = [head, "-" * len(head)]
    for r in rows:
        lines.append(
            f"{r['stage']:<{widths[0]}} {r['count']:>{widths[1]}} "
            f"{r['p50_us']:>{widths[2]}} {r['p99_us']:>{widths[3]}} "
            f"{r['mean_us']:>{widths[4]}}")
    return "\n".join(lines)


def _slow_ops(socket_paths: List[str]) -> List[dict]:
    """Merged slow-op rings: daemon dump commands are discovered from
    each socket's `help` listing (per-daemon prefixed commands)."""
    out: List[dict] = []
    for path in socket_paths:
        try:
            cmds = admin_command(path, "help")
        except OSError:
            continue
        for prefix in sorted(cmds):
            if not prefix.endswith(" dump_historic_slow_ops"):
                continue
            daemon = prefix.rsplit(" ", 1)[0]
            try:
                d = admin_command(path, prefix)
            except OSError:
                continue
            for o in d.get("ops", []):
                o["daemon"] = daemon
                out.append(o)
    out.sort(key=lambda o: -o.get("age", 0.0))
    return out


def render_slow(ops: List[dict]) -> str:
    if not ops:
        return "slow-op rings are empty"
    lines = []
    for o in ops:
        lines.append(f"{o.get('daemon', '?')}  age={o.get('age')}s  "
                     f"{o.get('description', '')}")
        for ev in o.get("events", []):
            lines.append(f"    {ev.get('t'):>10.6f}  {ev.get('event')}")
    return "\n".join(lines)


def _device_dump(socket_paths: List[str]) -> dict:
    """The first answering socket's `device compile dump` (the watcher
    is process-wide, so any daemon socket of the process serves the
    same table)."""
    for path in socket_paths:
        try:
            return admin_command(path, "device compile dump")
        except OSError:
            continue
    return {}


def _compile_table(d: dict) -> List[str]:
    """The compile table as the reference's ``render_device`` draws it
    (``tools/cephtop.py:127-165``): a row a family (first launches and
    builds on the card), the totals, the warmup, storms, live ones."""
    fams = d.get("families", {})
    if not fams:
        return ["no device compile events yet"]
    head = (f"{'family':<16} {'compiles':>9} {'compile_s':>10} "
            f"{'shapes':>7} {'hits':>9} {'traces':>7} "
            f"{'warm':>5} {'rogue':>6} {'persist':>8}")
    lines = [head, "-" * len(head)]
    for name, f in sorted(fams.items()):
        lines.append(
            f"{name:<16} {f['compiles']:>9} {f['compile_s']:>10.3f} "
            f"{f['distinct_signatures']:>7} {f['cache_hits']:>9} "
            f"{f['traces']:>7} {f.get('warmup', 0):>5} "
            f"{f.get('rogue', 0):>6} {f.get('persist_hits', 0):>8}")
    tot = d.get("totals", {})
    lines.append(
        f"total: {tot.get('compiles', 0)} compiles, "
        f"{tot.get('compile_seconds', 0.0)}s compiling, "
        f"{tot.get('distinct_shapes', 0)} distinct shapes, "
        f"{tot.get('cache_hits', 0)} cache hits, "
        f"{tot.get('rogue_compiles', 0)} rogue, "
        f"{tot.get('cache_persist_hits', 0)} persist hits")
    if d.get("compile_cache_dir"):
        lines.append(f"compile cache: {d['compile_cache_dir']}")
    w = d.get("warmup")
    if w:
        lines.append(
            f"warmup: {'done' if w.get('done') else 'pending'}, "
            f"{w.get('buckets_warmed', 0)} buckets in "
            f"{w.get('seconds', 0.0)}s "
            f"({w.get('pending', 0)} pending, "
            f"{w.get('runs', 0)} runs)")
    for s in d.get("storms", []):
        lines.append(
            f"STORM: {s['family']} x{s['distinct_signatures']} sigs "
            f"in {s['window_s']}s, churning {s['churning']}")
    for lc in d.get("live_compiles", []):
        lines.append(f"LIVE: {lc['family']} compiling for "
                     f"{lc['age_s']}s")
    return lines


def render_device(d: dict) -> str:
    """The port's ``device compile dump``: the kernel build, the compile
    table, launches per kernel and the queue's batches."""
    if not d:
        return "no device compile dump answered"
    b = d.get("build", {})
    state = ("building" if b.get("live")
             else f"built in {b.get('seconds')}s" if b.get("built")
             else "not built")
    if b.get("built"):
        state += (", loaded from a previous build" if b.get("persist_hit")
                  else ", compiled here")
    lines = [f"kernels: {state} ({len(b.get('sources', []))} sources, "
             f"{b.get('dir', '?')})"]
    lines += _compile_table(d)
    launches = d.get("launches", {})
    if launches:
        head = f"{'kernel':<20} {'launches':>10}"
        lines += [head, "-" * len(head)]
        lines += [f"{name:<20} {n:>10}"
                  for name, n in sorted(launches.items())]
    bt = d.get("batches", {})
    lines.append(f"batches: {bt.get('total', 0)} in "
                 f"{bt.get('seconds', 0.0)}s of device time")
    for r in bt.get("recent", [])[-10:]:
        lines.append(f"    {r['age_s']:>10.3f}s ago  {r['kind']:<5} "
                     f"jobs={r['jobs']}  {r['seconds']}s")
    return "\n".join(lines)


def _qos_status(socket_paths: List[str]) -> dict:
    """Merged `osd.N qos status` payloads, discovered from each
    socket's `help` listing (per-daemon prefixed commands)."""
    out: Dict[str, dict] = {}
    for path in socket_paths:
        try:
            cmds = admin_command(path, "help")
        except OSError:
            continue
        for prefix in sorted(cmds):
            if not prefix.endswith(" qos status"):
                continue
            daemon = prefix.rsplit(" ", 2)[0]
            try:
                out[daemon] = admin_command(path, prefix)
            except OSError:
                continue
    return out


def render_qos(st: Dict[str, dict]) -> str:
    if not st:
        return "no qos status admin command answered"
    lines: List[str] = []
    for daemon, d in sorted(st.items()):
        lines.append(f"{daemon}  scheduler={d.get('scheduler', '?')}")
        head = (f"  {'class':<28} {'res':>7} {'wgt':>7} {'lim':>7} "
                f"{'depth':>6} {'admitted':>9} {'p99_wait_us':>12}")
        lines.append(head)
        lines.append("  " + "-" * (len(head) - 2))
        for cls, row in sorted(d.get("classes", {}).items()):
            wait = row.get("wait_us") or {}
            lines.append(
                f"  {cls:<28} {row.get('reservation', '-'):>7} "
                f"{row.get('weight', '-'):>7} {row.get('limit', '-'):>7} "
                f"{row.get('depth', 0):>6} {row.get('admitted', 0):>9} "
                f"{wait.get('p99_us', '-'):>12}")
        ph = d.get("dequeue_phases", {})
        lines.append("  phases: " + " ".join(
            f"{p}={n}" for p, n in sorted(ph.items())))
        rec = d.get("recovery", {})
        lines.append(
            f"  recovery: state={rec.get('state')} "
            f"window={rec.get('effective_window')} "
            f"client_iops={rec.get('client_iops')} "
            f"widened={rec.get('widened')} clamped={rec.get('clamped')}")
        thr = d.get("throttle") or {}
        if thr:
            lines.append(
                f"  throttle: cap={thr.get('message_cap')} "
                f"size_cap={thr.get('size_cap')} "
                f"stalls={thr.get('stalls')}")
    return "\n".join(lines)


def _cluster_status(socket_paths: List[str]) -> dict:
    """The first answering mon's health + PGMap digest (the `mon.N
    status` admin command registered by every monitor)."""
    for path in socket_paths:
        try:
            cmds = admin_command(path, "help")
        except OSError:
            continue
        for prefix in sorted(cmds):
            if not prefix.endswith(" status") or \
                    not prefix.startswith("mon."):
                continue
            try:
                return admin_command(path, prefix)
            except OSError:
                continue
    return {}


def render_cluster(st: dict) -> str:
    if not st:
        return "no mon status admin command answered"
    d = st.get("digest", {})
    lines = [f"health: {st.get('health', '?')}"]
    for name, summary in sorted(st.get("checks", {}).items()):
        lines.append(f"    {name}: {summary}")
    states = " ".join(f"{s}={n}"
                      for s, n in sorted(d.get("pg_states", {}).items()))
    lines.append(f"pgs: {d.get('num_pgs', 0)} ({states})")
    lines.append(f"objects: {d.get('objects', 0)}  "
                 f"stored: {d.get('bytes', 0)} B  "
                 f"degraded: {d.get('degraded_objects', 0)}  "
                 f"misplaced: {d.get('misplaced_objects', 0)}  "
                 f"unfound: {d.get('unfound_objects', 0)}")
    io = d.get("io", {})
    lines.append(
        f"client: {io.get('client_read_ops_per_s', 0)} rd op/s, "
        f"{io.get('client_write_ops_per_s', 0)} wr op/s, "
        f"{io.get('client_write_bytes_per_s', 0)} wr B/s")
    lines.append(
        f"recovery: {io.get('recovery_objects_per_s', 0)} objects/s, "
        f"{io.get('recovery_bytes_per_s', 0)} B/s")
    if d.get("slow_ops"):
        lines.append("slow ops: " + ", ".join(
            f"osd.{o}={n}" for o, n in sorted(d["slow_ops"].items())))
    return "\n".join(lines)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="cephtop", description=__doc__)
    p.add_argument("--socket", action="append", default=[],
                   help="daemon admin socket path (repeatable)")
    p.add_argument("--slow", action="store_true",
                   help="dump the merged slow-op rings instead")
    p.add_argument("--cluster", action="store_true",
                   help="cluster pane: mon health + PGMap digest "
                        "(pg states, degraded totals, io rates)")
    p.add_argument("--device", action="store_true",
                   help="device pane: the kernel build, launches per "
                        "kernel and the queue's batches")
    p.add_argument("--qos", action="store_true",
                   help="qos pane: per-class dmClock admission state "
                        "(triples, depths, waits, phases, recovery "
                        "feedback, edge-throttle stalls)")
    p.add_argument("--json", action="store_true", dest="as_json")
    args = p.parse_args(argv)
    if not args.socket:
        print("cephtop: at least one --socket required", file=sys.stderr)
        return 2

    if args.qos:
        st = _qos_status(args.socket)
        print(json.dumps(st, indent=1) if args.as_json
              else render_qos(st))
        return 0

    if args.device:
        d = _device_dump(args.socket)
        print(json.dumps(d, indent=1) if args.as_json
              else render_device(d))
        return 0

    if args.cluster:
        st = _cluster_status(args.socket)
        print(json.dumps(st, indent=1) if args.as_json
              else render_cluster(st))
        return 0

    if args.slow:
        ops = _slow_ops(args.socket)
        print(json.dumps({"num_ops": len(ops), "ops": ops}, indent=1)
              if args.as_json else render_slow(ops))
        return 0

    dumps = []
    for path in args.socket:
        try:
            dumps.append(admin_command(path, "perf dump"))
        except OSError as e:
            print(f"cephtop: {path}: {e}", file=sys.stderr)
    rows = breakdown(merge_op_hists(dumps))
    print(json.dumps(rows, indent=1) if args.as_json else render(rows))
    return 0


if __name__ == "__main__":
    sys.exit(main())
