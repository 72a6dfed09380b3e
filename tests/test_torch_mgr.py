"""The port's mgr (``ceph_tpu_torch/mgr/{manager,dashboard}.py``) and
``VStartCluster.start_mgr`` on the CPU.

Mirrors, case for case: ``tests/test_mgr_crash.py`` (all 9 cases) and
``tests/test_mgr_dashboard.py`` (all 6, over HTTP against the port's
``VStartCluster(device="cpu")``), ``tests/test_qos_tracking.py:554``
(the ``qos`` module) and ``tests/test_optracker.py:279`` (the ``ops``
module), the last two over ``torch_daemon_harness.DaemonCluster(
"ceph_tpu_torch")``.  One case reads what the port has:
``test_crash_report_has_device_section_by_default`` holds the crash
report's device section to the port's ``DeviceWatch.device_state()``
(the kernel build, the launches and the last batches; the reference's
``last_compiles`` and ``live_compiles`` are its XLA compile table, item
4c of the port).  Two cases pin where the port parts from the
reference (R13 in ROADMAP): the mgr's feeds follow a new leader, and a
second ``start_mgr`` replaces the first.  Every wait polls with a
deadline.
"""

import json
import sys
import threading
import urllib.error
import urllib.request

import pytest

import torch_daemon_harness as H
from ceph_tpu_torch.core.context import Context
from ceph_tpu_torch.core.crash import CrashArchive
from ceph_tpu_torch.gpu import devwatch
from ceph_tpu_torch.mgr.manager import MgrDaemon
from ceph_tpu_torch.vstart import VStartCluster

DEV = "cpu"


@pytest.fixture
def mgr():
    return MgrDaemon(Context("mgr.x", {}))


def _ctx_with_counters(name):
    ctx = Context(name, {})
    pc = ctx.perf.create("osd")
    pc.add_u64_counter("op_w")
    pc.add_time_avg("op_w_latency")
    pc.add_histogram("op_size")
    pc.inc("op_w", 5)
    pc.tinc("op_w_latency", 0.25)
    pc.tinc("op_w_latency", 0.75)
    pc.hinc("op_size", 4096)
    return ctx


# -- tests/test_mgr_crash.py -------------------------------------------------

def test_collect_aggregates_registered_daemons(mgr):
    mgr.register_daemon("osd.0", _ctx_with_counters("osd.0"))
    mgr.register_daemon("osd.1", _ctx_with_counters("osd.1"))
    got = mgr.collect()
    assert set(got) == {"osd.0", "osd.1"}
    assert got["osd.0"]["osd"]["op_w"] == 5
    assert got["osd.1"]["osd"]["op_w_latency"]["avgcount"] == 2
    mgr.unregister_daemon("osd.1")
    assert set(mgr.collect()) == {"osd.0"}


def test_prometheus_export_format(mgr):
    mgr.register_daemon("osd.0", _ctx_with_counters("osd.0"))
    code, out = mgr.handle_command({"prefix": "prometheus export"})
    assert code == 0
    body = out["body"]
    assert '# TYPE ceph_osd_op_w counter' in body
    assert 'ceph_osd_op_w{daemon="osd.0"} 5' in body
    assert 'ceph_osd_op_w_latency_count{daemon="osd.0"} 2' in body
    assert 'ceph_osd_op_w_latency_sum{daemon="osd.0"} 1.0' in body
    # histogram buckets are cumulative
    assert 'ceph_osd_op_size_bucket{daemon="osd.0",le=' in body


def test_mgr_status_and_unknown_command(mgr):
    mgr.register_daemon("osd.0", Context("osd.0", {}))
    code, out = mgr.handle_command({"prefix": "mgr status"})
    assert code == 0
    assert out["daemons"] == ["osd.0"]
    assert "prometheus" in out["modules"]
    code, _ = mgr.handle_command({"prefix": "nope"})
    assert code == -22


def test_crash_archive_record_ls_info(tmp_path, mgr):
    ctx = Context("osd.2", {})
    ctx.log.log("osd", 1, "about to die")
    arch = CrashArchive(str(tmp_path / "crash"), entity="osd.2",
                        log=ctx.log)
    try:
        raise RuntimeError("boom")
    except RuntimeError as e:
        cid = arch.record(e)
    mgr.modules["crash"].add_archive(arch)
    code, out = mgr.handle_command({"prefix": "crash ls"})
    assert code == 0
    assert [c["crash_id"] for c in out["crashes"]] == [cid]
    code, out = mgr.handle_command({"prefix": "crash info", "id": cid})
    assert code == 0
    assert out["entity_name"] == "osd.2"
    assert any("boom" in line for line in out["backtrace"])
    assert any("about to die" in line for line in out["recent_events"])
    code, _ = mgr.handle_command({"prefix": "crash info", "id": "nope"})
    assert code == -2


def test_crash_hook_captures_thread_death(tmp_path):
    arch = CrashArchive(str(tmp_path / "crash"), entity="osd.3")
    arch.install()
    try:
        t = threading.Thread(
            target=lambda: (_ for _ in ()).throw(ValueError("thread-die")))
        t.start()
        t.join()
    finally:
        arch.uninstall()
    crashes = arch.ls()
    assert len(crashes) == 1
    info = arch.info(crashes[0]["crash_id"])
    assert "thread-die" in info["exception"]


def test_crash_sys_excepthook_captures_main_thread_death(tmp_path):
    """install() hooks sys.excepthook too (chained: the previous hook
    still runs), so a MAIN-thread death leaves a crash report."""
    arch = CrashArchive(str(tmp_path / "crash"), entity="osd.4")
    prev_called = []
    prev = sys.excepthook
    sys.excepthook = lambda *a: prev_called.append(a)
    try:
        arch.install()
        try:
            raise KeyError("main-thread-die")
        except KeyError:
            sys.excepthook(*sys.exc_info())
    finally:
        arch.uninstall()
        sys.excepthook = prev
    crashes = arch.ls()
    assert len(crashes) == 1
    assert "main-thread-die" in arch.info(
        crashes[0]["crash_id"])["exception"]
    assert prev_called  # the chained previous hook still ran


def test_crash_asyncio_loop_death_leaves_report(tmp_path):
    """An exception escaping an event-loop callback is archived via
    the loop exception handler (messengers wire their loops through
    install_loop_handler at construction)."""
    import asyncio

    from ceph_tpu_torch.core.crash import install_loop_handler

    arch = CrashArchive(str(tmp_path / "crash"), entity="osd.5")
    arch.install()
    loop = asyncio.new_event_loop()
    install_loop_handler(loop)
    try:
        async def die():
            raise ValueError("loop-task-die")

        async def driver():
            asyncio.ensure_future(die())  # never awaited: escapes
            await asyncio.sleep(0.05)

        loop.run_until_complete(driver())
    finally:
        arch.uninstall()
        loop.close()
    crashes = arch.ls()
    assert len(crashes) == 1
    assert "loop-task-die" in arch.info(
        crashes[0]["crash_id"])["exception"]


def test_crash_report_has_device_section_by_default(tmp_path):
    """record() captures the device-runtime state without any explicit
    wiring: the port's device section (the kernel build, the launches
    per kernel, the queue's last batches)."""
    arch = CrashArchive(str(tmp_path / "crash"), entity="osd.6")
    try:
        raise RuntimeError("boom-with-device")
    except RuntimeError as e:
        cid = arch.record(e)
    info = arch.info(cid)
    dev = info["device"]
    assert "build" in dev and "last_batches" in dev
    assert dev["launches"].keys() == devwatch.watch().launches().keys()


def test_crash_prune(tmp_path):
    arch = CrashArchive(str(tmp_path / "crash"))
    for i in range(5):
        try:
            raise KeyError(i)
        except KeyError as e:
            arch.record(e)
    assert len(arch.ls()) == 5
    arch.prune(keep=2)
    assert len(arch.ls()) == 2


# -- tests/test_mgr_dashboard.py ---------------------------------------------

@pytest.fixture(scope="module")
def cluster():
    with VStartCluster(n_mons=1, n_osds=3, device=DEV) as c:
        pool_id = c.create_pool("data", size=2)
        rc = c.client()
        io = rc.ioctx(pool_id)
        io.write_full("obj1", b"dashboard test payload")
        mgr = c.start_mgr(dashboard=True)
        c._dash_port = mgr.modules["dashboard"].port
        # pg stats arrive on the OSDs' report timer
        c.wait_for(lambda: c.command({"prefix": "pg dump"})[1].get(
            "num_pg_stats", 0) > 0, timeout=30)
        yield c


def _get(cluster, path):
    url = f"http://127.0.0.1:{cluster._dash_port}{path}"
    with urllib.request.urlopen(url, timeout=10) as r:
        return r.status, r.headers.get("Content-Type", ""), r.read()


def test_html_status_page(cluster):
    status, ctype, body = _get(cluster, "/")
    assert status == 200 and ctype.startswith("text/html")
    text = body.decode()
    assert "ceph_tpu cluster" in text
    assert "HEALTH" in text      # health pill rendered
    assert "osd.0" in text or "osd0" in text.replace(".", "")
    assert "data" in text        # the pool table


def test_json_api(cluster):
    for ep, key in (("/api/status", None), ("/api/health", "status"),
                    ("/api/osds", "osds"), ("/api/df", "nodes"),
                    ("/api/pgs", "num_pgs")):
        status, ctype, body = _get(cluster, ep)
        assert status == 200 and ctype.startswith("application/json"), ep
        obj = json.loads(body)
        if key:
            assert key in obj, (ep, obj)
    status, _, body = _get(cluster, "/api/pgs")
    pgs = json.loads(body)
    assert pgs["num_pgs"] > 0
    assert any("active" in s for s in pgs["by_state"])


def test_prometheus_and_perf(cluster):
    status, ctype, body = _get(cluster, "/metrics")
    assert status == 200 and "ceph_" in body.decode()
    status, _, body = _get(cluster, "/api/perf")
    perf = json.loads(body)
    assert perf  # at least one registered perf source


def test_404_and_command(cluster):
    try:
        _get(cluster, "/nope")
        raise AssertionError("expected 404")
    except urllib.error.HTTPError as e:
        assert e.code == 404
    rc, out = cluster.mgr.handle_command({"prefix": "dashboard status"})
    assert rc == 0 and out["running"] and str(cluster._dash_port) in out["url"]


def test_ops_module_sees_vstart_services(cluster):
    """start_mgr wires every OSD SERVICE into the ops-module merge
    (trackers are per-service even when daemons share one Context) —
    the cluster-wide dump surface must not be test-fixture-only."""
    mgr = cluster.mgr
    assert len(mgr.services) == 3, sorted(mgr.services)
    rc, hist = mgr.handle_command({"prefix": "ops dump_in_flight"})
    assert rc == 0 and "ops" in hist
    # the fixture's write concluded through every tracker -> history
    assert sum(t.op_tracker.ops_tracked
               for t in mgr.services.values()) >= 1
    rc, lat = mgr.handle_command({"prefix": "ops latency"})
    assert rc == 0 and lat.get("lat_op_us", {}).get("count", 0) >= 1
    # kill/revive repoints the merge at the revived service's FRESH
    # tracker — not the dead daemon's frozen rings
    cluster.kill_osd(2)
    cluster.revive_osd(2)
    assert mgr.services["osd.2"] is cluster.osds[2]


def test_df_command_and_telemetry(cluster):
    rc, out = cluster.command({"prefix": "df"})
    assert rc == 0
    assert out["total_bytes"] > 0
    assert any(p["name"] == "data" for p in out["pools"])
    data = next(p for p in out["pools"] if p["name"] == "data")
    assert data["objects"] >= 1  # obj1 written in the fixture

    rc, rep = cluster.mgr.handle_command({"prefix": "telemetry show"})
    assert rc == 0
    assert rep["channel"].startswith("local-only")
    assert rep["osds"]["count"] == 3 and rep["osds"]["up"] == 3
    assert any(p["type"] == "replicated" for p in rep["pools"])
    assert len(rep["report_id"]) == 16


# -- tests/test_qos_tracking.py:554 ------------------------------------------

def test_mgr_qos_module_status_and_set():
    """`qos status` merges per-daemon scheduler evidence; `qos set`
    retunes THROUGH the conf observer (the durable path)."""
    c = H.DaemonCluster("ceph_tpu_torch", device=DEV)
    cl = H.LibClient(c)
    try:
        cl.put(H.REP_POOL, "mgrq", b"m" * 4096)
        mgr = MgrDaemon(c.ctx)
        for i, svc in c.osds.items():
            mgr.register_service(f"osd.{i}", svc)
        code, out = mgr.handle_command({"prefix": "qos status"})
        assert code == 0
        assert "osd.0" in out["daemons"]
        assert out["daemons"]["osd.0"]["scheduler"] == "mclock"
        assert "client" in out["daemons"]["osd.0"]["classes"]
        code, out = mgr.handle_command({
            "prefix": "qos set", "class": "tenant:client.9",
            "reservation": 33, "weight": 44, "limit": 0})
        assert code == 0 and out["applied_via"]
        # the conf observer reloaded every scheduler sharing the ctx
        assert c.ctx.conf.get("osd_qos_profiles") == \
            "tenant:client.9=33:44:0"
        info = c.osds[0].qos.registry.info_for("client/client.9")
        assert info.reservation == 33.0 and info.weight == 44.0
        # a bad target is refused BEFORE the conf commits (set_val
        # stores first, observers fire after — a poisoned value would
        # break every later retune and every OSD boot)
        code, out = mgr.handle_command({
            "prefix": "qos set", "class": "bogus",
            "reservation": 1, "weight": 1, "limit": 1})
        assert code == -22
        assert c.ctx.conf.get("osd_qos_profiles") == \
            "tenant:client.9=33:44:0"
        # prometheus surface carries the qos gauges
        code, out = mgr.handle_command({"prefix": "prometheus export"})
        assert code == 0 and "ceph_qos_queue_depth" in out["body"]
    finally:
        cl.shutdown()
        c.shutdown()


# -- tests/test_optracker.py:279 ---------------------------------------------

def test_mgr_ops_module_merges_cluster_wide():
    """mgr cluster poll: slow ops and stage histograms merge across
    registered daemons (the DaemonServer/MMgrReport role)."""
    c = H.DaemonCluster("ceph_tpu_torch", device=DEV)
    cl = H.LibClient(c)
    try:
        c.ctx.conf.set_val("osd_op_complaint_time", 0.0)
        io = cl.rc.ioctx(H.EC_POOL)
        io.write_full("mobj", b"m" * 4096)
        mgr = MgrDaemon(c.ctx)
        for i, svc in c.osds.items():
            mgr.register_daemon(f"osd.{i}", c.ctx, service=svc)
        rc, slow = mgr.handle_command({"prefix": "ops dump_slow"})
        assert rc == 0 and slow["num_ops"] >= 1
        assert any("mobj" in o["description"] for o in slow["ops"])
        assert all("daemon" in o for o in slow["ops"])
        rc, lat = mgr.handle_command({"prefix": "ops latency"})
        assert rc == 0
        assert lat["lat_reply_us"]["count"] >= 1
        assert lat["lat_op_us"]["p99_us"] > 0
        rc, infl = mgr.handle_command({"prefix": "ops dump_in_flight"})
        assert rc == 0 and "ops" in infl
    finally:
        cl.shutdown()
        c.shutdown()


# -- F16: the mgr's feeds follow the leader elected after the leader's loss --

def test_the_mgr_feeds_follow_a_new_leader():
    """``VStartCluster.leader()`` skips a mon shut down (it keeps its last
    state, ``leader``), so the mgr's health, digest and progress feeds
    read the leader the others elect, not the lost one's frozen view
    (the reference's ``leader()`` returns the lost mon: R13)."""
    with VStartCluster(n_mons=3, n_osds=4, device=DEV,
                       conf={"mon_lease": 1.0}) as c:
        mgr = c.start_mgr()
        old = c.leader()
        old.shutdown()
        try:
            c.wait_for(lambda: c.leader() is not old, what="a new leader")
            c.kill_osd(1)
            c.wait_for(lambda: "OSD_DOWN" in mgr.health_fn()[1],
                       what="OSD_DOWN in the mgr's health feed")
            code, out = mgr.handle_command({"prefix": "prometheus export"})
            assert code == 0
            assert 'ceph_health_check{check="OSD_DOWN",' in out["body"]
            assert c.leader().rank != old.rank and old.state == "leader"
        finally:
            # the lost mon is not shut down twice
            c.mons = [mo for mo in c.mons if mo is not old]


def test_a_second_start_mgr_replaces_the_first(tmp_path):
    """``start_mgr`` called twice stops the first mgr's dashboard and
    uninstalls its crash spool's hooks before it starts the second, and
    ``shutdown`` leaves neither behind (the reference's ``start_mgr``
    leaves the first running: R13)."""
    from ceph_tpu_torch.core import crash

    with VStartCluster(n_mons=1, n_osds=3, device=DEV,
                       data_dir=str(tmp_path)) as c:
        first = c.start_mgr(dashboard=True)
        arch1 = c._crash_archive
        dash1 = first.modules["dashboard"]
        assert arch1 in crash._INSTALLED and dash1.server is not None
        second = c.start_mgr(dashboard=True)
        assert second is not first and c.mgr is second
        assert dash1.server is None and dash1._thread is None
        assert arch1 not in crash._INSTALLED
        assert c._crash_archive in crash._INSTALLED
        code, out = second.handle_command({"prefix": "dashboard status"})
        assert code == 0 and out["running"]
        arch2, dash2 = c._crash_archive, second.modules["dashboard"]
    assert arch2 not in crash._INSTALLED and dash2.server is None
