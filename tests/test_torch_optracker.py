"""The port's OpTracker (``ceph_tpu_torch/core/optracker.py``) and the
histogram math of ``core/perf.py``, case for case against the unit
cases of ``tests/test_optracker.py``, and the histogram functions
bit-equal to the reference's on seeded histograms.

The slow-op ring and the dump commands over the admin socket run on the
port's cluster, ``torch_daemon_harness.DaemonCluster("ceph_tpu_torch")``
(six port daemons, ``device="cpu"``), through the port's client.  The
mgr ops merge (``:279``) is mirrored in ``tests/test_torch_mgr.py`` and
cephtop (``:310``) in ``tests/test_torch_cli_tools.py``.
"""

import threading
import time

import numpy as np
import pytest

import torch_daemon_harness as H
from ceph_tpu.core import perf as ref_perf
from ceph_tpu_torch.core import perf
from ceph_tpu_torch.core.optracker import LEAKS, OpTracker, declare_op_hists
from ceph_tpu_torch.core.perf import (PerfCounters, hist_delta, hist_merge,
                                      hist_quantile)
from ceph_tpu_torch.core.tracing import STAGES


def _tracker(threshold=1.0, **kw):
    pc = PerfCounters("osd.t.op")
    declare_op_hists(pc)
    return OpTracker(slow_op_threshold=threshold, perf=pc, **kw), pc


# -- stage histograms ---------------------------------------------------------

def test_stage_events_feed_per_stage_histograms():
    trk, pc = _tracker()
    op = trk.create_op("osd_op(x)")
    op.mark_event("queued_for_pg")
    op.mark_event("reached_pg")
    op.mark_event("admitted")
    op.mark_event("submitted")
    op.mark_event("commit")
    op.finish(stage="commit_sent")
    d = pc.dump()
    for hist in ("lat_recv_us", "lat_queue_us", "lat_admission_us",
                 "lat_encode_fanout_us", "lat_commit_wait_us",
                 "lat_reply_us", "lat_op_us"):
        assert d[hist]["count"] == 1, (hist, d[hist])
    # stage deltas sum to roughly the op total (same timeline)
    stage_sum = sum(d[h]["sum"] for h in (
        "lat_recv_us", "lat_queue_us", "lat_admission_us",
        "lat_encode_fanout_us", "lat_commit_wait_us", "lat_reply_us"))
    assert abs(stage_sum - d["lat_op_us"]["sum"]) < 100  # us


def test_stage_delta_is_since_previous_event():
    trk, pc = _tracker()
    op = trk.create_op("x")
    op.mark_event("queued_for_pg")
    time.sleep(0.05)
    op.mark_event("reached_pg")  # ~50ms queue wait
    op.finish(stage="commit_sent")
    q = pc.dump()["lat_queue_us"]
    assert q["count"] == 1
    assert q["sum"] >= 45_000  # the sleep landed in THIS stage
    assert pc.dump()["lat_recv_us"]["sum"] < 45_000


def test_timeline_and_registry_agree():
    """Every hist-feeding stage used by the pipeline is declared."""
    for stage, hist in STAGES.items():
        assert isinstance(stage, str) and stage
        if hist:
            assert hist.startswith("lat_") and hist.endswith("_us")


# -- lifecycle ---------------------------------------------------------------

def test_finish_is_idempotent_one_history_entry():
    trk, _ = _tracker()
    op = trk.create_op("x")
    op.finish(stage="commit_sent")
    op.finish()          # double finish: no-op
    with op:             # context-manager sugar after explicit finish
        pass
    assert trk.dump_historic()["num_ops"] == 1
    assert trk.num_in_flight == 0


def test_terminal_event_recorded_for_eagain_and_abort():
    trk, _ = _tracker()
    op = trk.create_op("x")
    op.finish(stage="eagain")
    op2 = trk.create_op("y")
    with pytest.raises(RuntimeError):
        with op2:
            raise RuntimeError("boom")
    events = [o["events"][-1]["event"]
              for o in trk.dump_historic()["ops"]]
    assert events[0] == "eagain"
    assert events[1].startswith("aborted")
    assert trk.num_in_flight == 0


def test_drain_shutdown_vs_leak():
    trk, _ = _tracker()
    healthy = trk.create_op("in-flight-at-kill")   # never replied
    leaky = trk.create_op("replied-but-never-finished")
    leaky.mark_event("commit_sent")                # reply went out...
    before = len(LEAKS)
    try:
        trk.drain()
        assert trk.num_in_flight == 0
        evs = {o["description"]: o["events"][-1]["event"]
               for o in trk.dump_historic()["ops"]}
        # a kill mid-write is NOT a leak; a concluded op still in the
        # table IS
        assert evs["in-flight-at-kill"] == "daemon_shutdown"
        assert evs["replied-but-never-finished"] == "leaked"
        assert len(LEAKS) == before + 1
        assert "replied-but-never-finished" in LEAKS[-1]
        assert trk.ops_leaked == 1
        assert healthy.done_at is not None
    finally:
        del LEAKS[before:]  # consume the deliberately injected leak


def test_mark_event_thread_safety_ordered_timeline():
    """Concurrent marks keep the timeline ordered: no lost events, and
    the since-previous deltas the histograms eat stay non-negative."""
    trk, pc = _tracker()
    op = trk.create_op("racy")
    n_threads, n_marks = 8, 200
    barrier = threading.Barrier(n_threads)

    def w():
        barrier.wait()
        for _ in range(n_marks):
            op.mark_event("reached_pg")

    ts = [threading.Thread(target=w) for _ in range(n_threads)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=30)
        assert not t.is_alive()
    stamps = [t for t, _, _ in op.events]
    assert stamps == sorted(stamps)
    assert len(op.events) == 1 + n_threads * n_marks
    op.finish(stage="commit_sent")
    d = pc.dump()["lat_queue_us"]
    assert d["count"] == n_threads * n_marks
    assert d["sum"] >= 0


def test_mark_event_overhead_is_microseconds():
    """mark_event + its histogram feed stay negligible next to a write."""
    trk, _ = _tracker()
    op = trk.create_op("bench")
    n = 2000
    best = float("inf")
    for _ in range(5):
        t0 = time.perf_counter()
        for _i in range(n):
            op.mark_event("commit")
        best = min(best, (time.perf_counter() - t0) / n)
    op.finish()
    assert best < 50e-6, f"mark_event cost {best * 1e6:.1f}us"


# -- histogram math ----------------------------------------------------------

def test_hist_quantile_bucket_math():
    pc = PerfCounters("t")
    pc.add_histogram("h")
    # 90 small values (bucket [64,128)) + 10 large ([65536,131072))
    for _ in range(90):
        pc.hinc("h", 100.0)
    for _ in range(10):
        pc.hinc("h", 100_000.0)
    d = pc.dump()["h"]
    p50 = hist_quantile(d, 0.50)
    p99 = hist_quantile(d, 0.99)
    assert 64 <= p50 < 128, p50
    assert 65536 <= p99 <= 131072, p99
    assert hist_quantile({"count": 0, "buckets": []}, 0.5) == 0.0


def test_hist_merge_and_delta():
    pc = PerfCounters("t")
    pc.add_histogram("h")
    pc.hinc("h", 10.0)
    snap1 = pc.dump()["h"]
    pc.hinc("h", 1000.0)
    snap2 = pc.dump()["h"]
    dd = hist_delta(snap2, snap1)
    assert dd["count"] == 1 and 512 <= hist_quantile(dd, 0.5) <= 1024
    acc = {}
    hist_merge(acc, snap1)
    hist_merge(acc, dd)
    assert acc["count"] == snap2["count"]
    assert acc["buckets"] == snap2["buckets"]


# -- cross-checks against ceph_tpu ---------------------------------------------


def _seeded_dumps(mod, seed):
    """Two snapshots of a seeded histogram counter set, through mod's
    own PerfCounters (so the bucket rule is held too)."""
    rng = np.random.default_rng(seed)
    pc = mod.PerfCounters("osd.1.op")
    for name in ("lat_a_us", "lat_b_us"):
        pc.add_histogram(name)
    vals = rng.lognormal(6.0, 2.5, 500)
    for i, v in enumerate(vals):
        pc.hinc("lat_a_us" if i % 3 else "lat_b_us", float(v))
        if i == 200:
            before = pc.dump()
    return before, pc.dump()


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_hist_functions_equal_the_reference(seed):
    before, after = _seeded_dumps(perf, seed)
    rbefore, rafter = _seeded_dumps(ref_perf, seed)
    assert (before, after) == (rbefore, rafter)
    for name in ("lat_a_us", "lat_b_us"):
        h = after[name]
        for q in (0.0, 0.01, 0.5, 0.9, 0.99, 0.999, 1.0):
            assert perf.hist_quantile(h, q) == ref_perf.hist_quantile(h, q)
        assert perf.hist_summary(h) == ref_perf.hist_summary(h)
        assert perf.hist_delta(h, before[name]) == \
            ref_perf.hist_delta(h, before[name])
        acc, racc = {}, {}
        for src in (before[name], h):
            perf.hist_merge(acc, src)
            ref_perf.hist_merge(racc, src)
        assert acc == racc
    payloads = [{"osd.1.op": after, "osd.1.tpuq": after,
                 "osd.2.tpuq": before, "osd.1": {"x": 1}},
                {"osd.3.op": before}]
    assert perf.merge_stage_hists(payloads) == \
        ref_perf.merge_stage_hists(payloads)


def test_perf_collection_and_snapshot_ring_equal_the_reference():
    out = []
    for mod in (perf, ref_perf):
        coll = mod.PerfCountersCollection()
        pc = coll.create("osd")
        pc.add_u64_counter("ops")
        pc.add_time_avg("lat")
        pc.inc("ops", 3)
        pc.dec("ops")
        pc.tinc("lat", 0.25)
        ext = mod.PerfCounters("store")
        ext.add_u64_gauge("bytes")
        ext.set("bytes", 7)
        coll.register("store", ext)
        assert coll.create("osd") is pc and coll.get("store") is ext
        ring = mod.SnapshotRing(capacity=4)
        for t in range(6):
            ring.push({"n": t * t}, stamp=float(t))
        out.append((coll.dump(), ring.rate("n", 3.0), ring.delta("n", 3.0),
                    ring.latest("n"), ring.rate("n", 3.0, now=10.0)))
    assert out[0] == out[1]


# -- cluster integration ------------------------------------------------------

def test_slow_ring_and_dump_commands_on_minicluster(tmp_path):
    """The acceptance shape: a write artificially slowed through an
    existing failpoint lands in dump_historic_slow_ops with its full
    stage timeline, retrieved over the REAL admin socket; the
    complaint time is conf-driven at runtime."""
    from ceph_tpu_torch.core import failpoint as fp
    from ceph_tpu_torch.core.admin_socket import admin_command

    sock = str(tmp_path / "admin.sock")
    c = H.DaemonCluster("ceph_tpu_torch", overrides={"admin_socket": sock},
                        device="cpu")
    cl = H.LibClient(c)
    try:
        io = cl.rc.ioctx(H.EC_POOL)
        io.write_full("warm", b"w" * 1024)  # pools active, obc warm
        # runtime conf drives the ring: every op now counts as slow
        c.ctx.conf.set_val("osd_op_complaint_time", 0.01)
        for o in c.osds.values():
            assert o.op_tracker.slow_op_threshold == 0.01
        # artificially slow the sub-write fan-out (existing failpoint,
        # fires on the fan-out executor — never the messenger loop);
        # sleep returns None, so nothing is dropped, just delayed
        fp.arm("backend.subwrite.fanout", fp.sleep_ms(25))
        try:
            io.write_full("slowme", b"s" * 2048)
        finally:
            fp.disarm("backend.subwrite.fanout")
        pgid, _acting, primary = c.primary_of(H.EC_POOL, "slowme")
        # over the admin socket, per-daemon prefixed like `ceph daemon`
        d = admin_command(sock, f"osd.{primary} dump_historic_slow_ops")
        ops = [o for o in d["ops"] if "slowme" in o["description"]]
        assert ops, d
        events = [e["event"] for e in ops[-1]["events"]]
        for stage in ("initiated", "queued_for_pg", "reached_pg",
                      "admitted", "submitted", "commit", "commit_sent"):
            assert any(ev.split(" ")[0] == stage for ev in events), (
                stage, events)
        # ordering follows the pipeline
        idx = {ev.split(" ")[0]: i for i, ev in enumerate(events)}
        assert (idx["initiated"] < idx["queued_for_pg"]
                < idx["reached_pg"] < idx["admitted"]
                < idx["submitted"] < idx["commit"] < idx["commit_sent"])
        # in-flight dump answers too (likely empty now, shape check)
        infl = admin_command(sock, f"osd.{primary} dump_ops_in_flight")
        assert "num_ops" in infl and "ops" in infl
        # per-stage histograms appear in perf dump
        perf = admin_command(sock, "perf dump")
        opset = perf[f"osd.{primary}.op"]
        assert opset["lat_commit_wait_us"]["count"] >= 1
        assert opset["lat_reply_us"]["count"] >= 1
        # the injected per-peer sleeps (2 peers x 25ms, sequential in
        # the fan-out loop) land in the encode/fan-out stage
        assert hist_quantile(opset["lat_encode_fanout_us"],
                             0.99) >= 40_000
        # reads conclude with their OWN terminal stage: read_sent ->
        # lat_read_us; whole read service times must never inflate
        # lat_reply_us (which for writes is reply-send only)
        assert io.read("slowme") == b"s" * 2048
        hist = admin_command(sock, f"osd.{primary} dump_historic_ops")
        reads = [o for o in hist["ops"]
                 if "slowme" in o["description"]
                 and any(e["event"].split(" ")[0] == "read_sent"
                         for e in o["events"])]
        assert reads, hist
        perf2 = admin_command(sock, "perf dump")
        assert perf2[f"osd.{primary}.op"]["lat_read_us"]["count"] >= 1
    finally:
        cl.shutdown()
        c.shutdown()
