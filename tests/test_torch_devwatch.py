"""``tests/test_devwatch.py`` mirrored on the port's device watch
(``ceph_tpu_torch/gpu/devwatch.py``), case for case, on the CPU: the
compile table of first launches, the storm detector, the steady-state
guard, the queue's compile blame, the crash report's device section,
the gather ring, and the ``osd.N.xla`` set, admin socket, ``cephtop
--device``, mgr, Prometheus and ``ceph`` surfaces.

The reference wraps functions with ``instrumented_jit``; the port's
counterpart is ``instrumented_launch(family, sig, fn)``, which every
kernel wrapper launches through, so a test family here is a plain
function launched through it (``_launcher``), on the CPU as the wrappers'
plain versions are.  No counterpart: the jit static-argument cases
``:80`` and ``:99`` (jax's compile-cache key); the port's signature of
tensors, arrays and scalars stands in for ``:80``, and a static argument
keyed by value as K3's wrapper passes its ``w`` for ``:99``.  The
``slow`` CRUSH churn case (``:484``) is not mirrored.

An autouse fixture fails a test that leaves the port's
``GUARD_VIOLATIONS`` non-empty (the reference conftest's check, which
reads the reference's list only).
"""

import contextlib
import io as _io
import json
import time

import numpy as np
import pytest
import torch

from ceph_tpu_torch.gpu import devwatch
from ceph_tpu_torch.gpu.devwatch import (
    GUARD_VIOLATIONS, _churn_dim, instrumented_launch, sig_str, signature,
    watch,
)


@pytest.fixture(autouse=True)
def _guard():
    """The steady-state guard's per-test check, on the port's list."""
    GUARD_VIOLATIONS.clear()
    yield
    guard, GUARD_VIOLATIONS[:] = (list(GUARD_VIOLATIONS), [])
    assert not guard, ("first launch(es) inside a declared steady-state "
                       "section: " + "; ".join(guard))


@pytest.fixture
def dw():
    """The process-wide watcher with its storm conf and wiring restored
    after the test."""
    w = watch()
    saved = (w.storm_window_s, w.storm_min_sigs, w.storm_min_rogue_sigs,
             w._log, w._queue)
    yield w
    (w.storm_window_s, w.storm_min_sigs, w.storm_min_rogue_sigs,
     w._log, w._queue) = saved
    GUARD_VIOLATIONS.clear()


class StubLog:
    def __init__(self):
        self.lines = []
        self.cluster_msgs = []

    def log(self, subsys, level, msg):
        self.lines.append((subsys, level, msg))

    def cluster(self, level, msg):
        self.cluster_msgs.append((level, msg))


def _launcher(family, fn):
    """``fn`` as a kernel wrapper launches: through instrumented_launch,
    keyed by its arguments' signature."""
    def call(*args):
        return instrumented_launch(family, signature(args, {}),
                                   lambda: fn(*args))
    return call


def _codec():
    from ceph_tpu_torch.ec import codec_from_profile

    return codec_from_profile("plugin=isa k=2 m=1 technique=reed_sol_van",
                              device="cpu")


def _queue():
    from ceph_tpu_torch.gpu.queue import StripeBatchQueue

    return StripeBatchQueue(device="cpu")


# -- signature machinery ------------------------------------------------------

def test_signature_dedup_same_family_same_shape_is_one_compile(dw):
    fam = "t_dedup"
    f = _launcher(fam, lambda x: x + 1)
    a = torch.arange(64, dtype=torch.int32)
    f(a)
    f(a)
    f(torch.arange(64, dtype=torch.int32))  # same signature, new buffer
    st = dw.family_stats(fam)
    assert st["compiles"] == 1
    assert st["cache_hits"] == 2
    assert st["distinct_signatures"] == 1
    f(torch.arange(128, dtype=torch.int32))  # a new shape: a first launch
    st = dw.family_stats(fam)
    assert st["compiles"] == 2 and st["distinct_signatures"] == 2
    # launches at a seen signature feed the family's execute histogram
    hist = dw.perf.dump()[f"exec_{fam}_us"]
    assert hist["count"] == 2


def test_signature_covers_dtype_and_scalar_semantics():
    """Stands in for ``:80``: dtype is part of the key, a tensor and an
    array of one shape give one atom, dynamic scalars key by type."""
    a32 = torch.arange(8, dtype=torch.int32)
    a64 = torch.arange(8, dtype=torch.int64)
    assert signature((a32,), {}) != signature((a64,), {})
    assert signature((a32,), {}) == signature(
        (np.arange(8, dtype=np.int32),), {})
    assert signature((a32, 3), {}) == signature((a32, 4), {})
    assert signature((a32, 3), {}) != signature((a32, 3.0), {})
    assert "int32[8]" in sig_str(signature((a32,), {}))


def test_static_argument_keys_by_value(dw):
    """Stands in for ``:99``: a static argument (K3's ``w``) keys by
    value, so each value is a first launch of its own."""
    fam = "t_static"

    def f(x, n):
        return instrumented_launch(
            fam, signature((x, n), {}, static_argnums=(1,)),
            lambda: x[:n])

    a = torch.arange(16, dtype=torch.int32)
    f(a, 4)
    f(a, 4)   # same static value: a hit
    f(a, 8)   # new static value: a first launch
    st = dw.family_stats(fam)
    assert st["compiles"] == 2 and st["cache_hits"] == 1


def test_churn_dim_names_the_varying_axis():
    sigs = [signature((torch.zeros((2, n), dtype=torch.uint8),), {})
            for n in (128, 256, 512)]
    assert _churn_dim(sigs) == "arg0.shape[1]"
    sigs = [signature((torch.zeros((2, 64), dtype=torch.uint8), k), {},
                      static_argnums=(1,))
            for k in (1, 2, 3)]
    assert _churn_dim(sigs) == "arg1"


# -- recompile-storm detection ------------------------------------------------

def test_storm_detector_fires_and_names_family_and_dimension(dw):
    fam = "t_storm"
    log = StubLog()
    dw.attach_log(log)
    dw.configure(window_s=30.0, min_sigs=3)
    g = _launcher(fam, lambda x: x * 2)
    for n in (16, 24, 40):  # deliberate shape churn
        g(torch.arange(n, dtype=torch.int32))
    warns = [m for _l, m in log.cluster_msgs if "RECOMPILE_STORM" in m]
    assert warns, log.cluster_msgs
    assert fam in warns[0]
    assert "arg0.shape[0]" in warns[0]
    storm = dw.dump()["storms"][-1]
    assert storm["family"] == fam
    assert storm["distinct_signatures"] == 3
    assert storm["churning"] == "arg0.shape[0]"
    # one WARN a window, however much churn follows
    g(torch.arange(56, dtype=torch.int32))
    assert len([m for _l, m in log.cluster_msgs
                if "RECOMPILE_STORM" in m and fam in m]) == 1


def test_no_storm_below_threshold(dw):
    fam = "t_quiet"
    log = StubLog()
    dw.attach_log(log)
    dw.configure(window_s=30.0, min_sigs=4)
    g = _launcher(fam, lambda x: x - 1)
    for n in (8, 12):
        g(torch.arange(n, dtype=torch.int32))
    assert not [m for _l, m in log.cluster_msgs if fam in m]


# -- steady-state guard -------------------------------------------------------

def test_steady_state_guard_catches_in_section_compile(dw):
    fam = "t_guard"
    f = _launcher(fam, lambda x: x ^ 1)
    f(torch.arange(32, dtype=torch.int32))  # warmup: outside the section
    with dw.steady_state():
        f(torch.arange(32, dtype=torch.int32))  # a hit: fine
    assert not GUARD_VIOLATIONS
    with dw.steady_state():
        f(torch.arange(48, dtype=torch.int32))  # a new shape: violation
    assert len(GUARD_VIOLATIONS) == 1
    assert fam in GUARD_VIOLATIONS[0]
    GUARD_VIOLATIONS.clear()  # consumed here, not by the fixture


# -- op-level compile blame ---------------------------------------------------

def test_compile_wait_annotation_on_op_racing_a_live_compile(dw):
    from ceph_tpu_torch.core.optracker import OpTracker, declare_op_hists
    from ceph_tpu_torch.core.perf import PerfCounters

    pc = PerfCounters("osd.t.op")
    declare_op_hists(pc)
    trk = OpTracker(perf=pc)
    op = trk.create_op("osd_op(client.1:1 w)")
    q = _queue()
    try:
        tok = dw.compile_begin("t_race")  # a first launch is running
        fut = q.encode_async(
            _codec(), np.arange(256, dtype=np.uint8).reshape(2, 128),
            trop=op)
        fut.result(10.0)
        dw.compile_end(tok, signature((np.zeros(1),), {}))
        events = [e["event"] for e in op.dump()["events"]]
        assert any(e.startswith("compile_wait") for e in events), events
        assert pc.dump()["lat_compile_wait_us"]["count"] >= 1
    finally:
        op.finish(stage="commit_sent")
        q.stop()


def test_compile_wait_annotation_does_not_shift_stage_baseline(dw):
    from ceph_tpu_torch.core.optracker import OpTracker, declare_op_hists
    from ceph_tpu_torch.core.perf import PerfCounters

    pc = PerfCounters("osd.tb.op")
    declare_op_hists(pc)
    trk = OpTracker(perf=pc)
    op = trk.create_op("osd_op(client.1:9 w)")
    op.mark_event("submitted")
    time.sleep(0.3)
    op.mark_event("compile_wait", "5.0ms", annotation=True)
    time.sleep(0.01)
    op.mark_event("commit")
    events = [e["event"] for e in op.dump()["events"]]
    assert any(e.startswith("compile_wait") for e in events)
    h = pc.dump()["lat_commit_wait_us"]
    # measured since 'submitted', not since the annotation
    assert h["sum"] / h["count"] > 150e3, h
    op.finish(stage="commit_sent")


def test_no_compile_wait_when_no_compile_is_live(dw):
    from ceph_tpu_torch.core.optracker import OpTracker, declare_op_hists
    from ceph_tpu_torch.core.perf import PerfCounters

    pc = PerfCounters("osd.t2.op")
    declare_op_hists(pc)
    trk = OpTracker(perf=pc)
    op = trk.create_op("osd_op(client.1:2 w)")
    codec = _codec()
    q = _queue()
    try:
        # the first encode pays the first launches; the op's window
        # opens after them
        q.encode(codec, np.arange(256, dtype=np.uint8).reshape(2, 128))
        time.sleep(0.01)
        op2 = trk.create_op("osd_op(client.1:3 w)")
        fut = q.encode_async(
            codec, np.arange(256, dtype=np.uint8).reshape(2, 128),
            trop=op2)
        fut.result(10.0)
        events = [e["event"] for e in op2.dump()["events"]]
        assert not any(e.startswith("compile_wait") for e in events), \
            events
        op2.finish(stage="commit_sent")
    finally:
        op.finish(stage="commit_sent")
        q.stop()


# -- crash flight recorder ----------------------------------------------------

def test_crash_report_device_section_roundtrips(dw, tmp_path):
    from ceph_tpu_torch.core import failpoint as fp
    from ceph_tpu_torch.core.crash import CrashArchive

    codec = _codec()
    # one first launch, so last_compiles is not empty
    _launcher("t_crash", lambda x: x + 7)(torch.arange(16,
                                                       dtype=torch.int32))
    q = _queue()
    dw.attach_queue(q)
    fp.arm("queue.batch.dispatch", fp.barrier("devwatch-stall"))
    try:
        fut = q.encode_async(
            codec, np.arange(512, dtype=np.uint8).reshape(2, 256))
        assert fp.wait_hit("devwatch-stall", timeout=10.0)
        arch = CrashArchive(str(tmp_path / "crash"), entity="osd.7")
        try:
            raise RuntimeError("device worker wedged")
        except RuntimeError as e:
            cid = arch.record(e)
        info = arch.info(cid)
        dev = info["device"]
        assert dev["in_flight_batch"]["jobs"] == 1
        assert dev["in_flight_batch"]["kind"] == "enc"
        assert dev["in_flight_batch"]["shapes"] == [[2, 256]]
        assert any(ev["family"] == "t_crash"
                   for ev in dev["last_compiles"])
        assert "staging" in dev and "queue_depth" in dev
        json.dumps(info)  # fully serializable
    finally:
        fp.release("devwatch-stall")
        fut.result(10.0)
        fp.disarm_all()
        q.stop()


def test_gather_ring_records_compile_and_batch_events(dw):
    from ceph_tpu_torch.core.log import Log

    log = Log(default_level=1, name="t.gather")
    dw.attach_log(log)
    _launcher("t_gather", lambda x: x + 3)(torch.arange(8,
                                                        dtype=torch.int32))
    q = _queue()
    try:
        q.encode(_codec(), np.arange(256, dtype=np.uint8).reshape(2, 128))
    finally:
        q.stop()
    recent = log.dump_recent()
    assert any("devwatch compile t_gather" in ln for ln in recent)
    assert any("devwatch batch queue" in ln for ln in recent)


# -- surfaces: perf set, admin socket, mgr, prometheus, cephtop ---------------

def test_osd_xla_perf_set_registered():
    import torch_daemon_harness as H

    c = H.DaemonCluster("ceph_tpu_torch", device="cpu")
    try:
        whoami = next(iter(c.osds))
        dump = c.ctx.perf.dump()
        assert f"osd.{whoami}.xla" in dump
        assert "compile_total" in dump[f"osd.{whoami}.xla"]
    finally:
        c.shutdown()


def test_device_compile_dump_admin_socket_and_cephtop(dw, tmp_path):
    from ceph_tpu_torch.core.admin_socket import admin_command
    from ceph_tpu_torch.core.context import Context
    from ceph_tpu_torch.tools import cephtop

    _launcher("t_sock", lambda x: x + 9)(torch.arange(8, dtype=torch.int32))
    sock = str(tmp_path / "dw.sock")
    ctx = Context("osd.5", {"admin_socket": sock})
    try:
        d = admin_command(sock, "device compile dump")
        assert "t_sock" in d["families"]
        assert d["families"]["t_sock"]["compiles"] >= 1
        assert d["totals"]["compiles"] >= 1
        buf = _io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = cephtop.main(["--socket", sock, "--device"])
        assert rc == 0
        out = buf.getvalue()
        assert "t_sock" in out and "compiles" in out
    finally:
        ctx.shutdown()


def test_mgr_device_module_and_cli_parse(dw):
    from ceph_tpu_torch.core.context import Context
    from ceph_tpu_torch.mgr.manager import MgrDaemon
    from ceph_tpu_torch.tools import ceph as ceph_cli

    _launcher("t_mgr", lambda x: x + 11)(torch.arange(8,
                                                      dtype=torch.int32))
    mgr = MgrDaemon(Context("mgr.t", {}))
    rc, out = mgr.handle_command({"prefix": "device compile dump"})
    assert rc == 0 and "t_mgr" in out["families"]
    assert ceph_cli._parse(["crash", "ls"]) == {"prefix": "crash ls"}
    assert ceph_cli._parse(["crash", "info", "x.1"]) == {
        "prefix": "crash info", "id": "x.1"}
    assert ceph_cli._parse(["device", "compile", "dump"]) == {
        "prefix": "device compile dump"}


def test_prometheus_export_includes_xla_and_reparses(dw):
    from ceph_tpu_torch.core.context import Context
    from ceph_tpu_torch.mgr.manager import MgrDaemon
    from tests.test_pgmap import parse_exposition

    fam = "t_prom"
    f = _launcher(fam, lambda x: x * 3)
    f(torch.arange(8, dtype=torch.int32))
    f(torch.arange(8, dtype=torch.int32))  # one hit: the histogram fed
    mgr = MgrDaemon(Context("mgr.p", {}))
    body = mgr.modules["prometheus"].export()
    types, samples = parse_exposition(body)  # every line must parse
    assert types["ceph_xla_compile_total"] == "counter"
    assert types["ceph_xla_exec_us"] == "histogram"
    by_name = {}
    for name, labels, val in samples:
        by_name.setdefault(name, []).append((labels, val))
    comp = {lab["family"]: float(v)
            for lab, v in by_name["ceph_xla_compile_total"]}
    assert comp[fam] >= 1
    shapes = {lab["family"]: float(v)
              for lab, v in by_name["ceph_xla_distinct_shapes"]}
    assert shapes[fam] >= 1
    buckets = [(lab, float(v))
               for lab, v in by_name["ceph_xla_exec_us_bucket"]
               if lab["family"] == fam]
    assert buckets and buckets[-1][0]["le"] == "+Inf"
    count = next(float(v) for lab, v in by_name["ceph_xla_exec_us_count"]
                 if lab["family"] == fam)
    assert buckets[-1][1] == count >= 1
    finite = [(float(lab["le"]), v) for lab, v in buckets
              if lab["le"] != "+Inf"]
    assert finite == sorted(finite)  # monotone cumulative


def test_ceph_cli_serves_device_and_crash_prefixes(dw, tmp_path):
    from ceph_tpu_torch.tools import ceph as ceph_cli

    _launcher("t_cli", lambda x: x + 13)(torch.arange(8,
                                                      dtype=torch.int32))
    buf = _io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = ceph_cli.main(
            ["--vstart", "1x1", "--data-dir", str(tmp_path / "d"),
             "--device", "cpu",
             "--script", "device compile dump; crash ls"])
    assert rc == 0
    out = buf.getvalue()
    assert "t_cli" in out
    assert "crashes" in out


def test_vstart_durable_cluster_archives_crashes(dw, tmp_path):
    from ceph_tpu_torch.vstart import VStartCluster

    with VStartCluster(n_mons=1, n_osds=1, data_dir=str(tmp_path / "dd"),
                       device="cpu") as c:
        mgr = c.start_mgr()
        arch = c._crash_archive
        try:
            raise RuntimeError("vstart-crash")
        except RuntimeError as e:
            cid = arch.record(e)
        rc, out = mgr.handle_command({"prefix": "crash ls"})
        assert rc == 0
        assert cid in [x["crash_id"] for x in out["crashes"]]
        rc, info = mgr.handle_command(
            {"prefix": "crash info", "id": cid})
        assert rc == 0 and "device" in info


# -- the port's own: the build and first-launch walls -------------------------

def test_build_is_a_compile_with_its_persist_outcome(monkeypatch):
    """A kernel build lands in the table as one compile of the build
    family with its wall, and a build that loaded an existing library is
    a persist hit (a fresh watch, fed what ``_build`` reports)."""
    w = devwatch.DeviceWatch()
    w.note_build(10.0, 12.5, hit=False)
    w.note_build(20.0, 20.25, hit=True)
    d = w.dump()
    fam = d["families"][devwatch.BUILD_FAMILY]
    assert fam["compiles"] == 2 and fam["compile_s"] == 2.75
    assert fam["persist_hits"] == 1 and fam["rogue"] == 0
    assert d["totals"]["cache_persist_hits"] == 1
    assert d["totals"]["cache_persist_misses"] == 1
    assert w.compile_overlap_s(11.0, 21.0) == 1.75
    sig = tuple(("val", repr(s)) for s in devwatch._build.SOURCES)
    assert w.first_launches() == [{"family": devwatch.BUILD_FAMILY,
                                   "sig": sig_str(sig), "wall_s": 2.5,
                                   "class": "bucketed-cold"}]
