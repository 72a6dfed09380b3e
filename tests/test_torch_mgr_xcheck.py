"""The port's mgr and admin tools held to the reference's, on the CPU.

- ``prometheus export``: the same counters, registered and bumped alike
  in each package's ``Context``, with the same health, PGMap digest and
  QoS feeds, give byte-equal exposition text.  Each package's
  process-wide device watch is swapped for a fresh one fed one compile
  sequence under one clock (other tests of the process may have filled
  the process's), so the ``ceph_xla_*`` lines are compared populated.
- ``telemetry show``: the same report over the same contexts and maps.
- ``balancer optimize``: the same moves on maps both packages build from
  one seed.
- ``progress``: the same events and ETAs over the same ``pg_rows``
  sequence under an injected clock.
- ``ceph``'s ``_parse``: the same command dicts for a list of token
  lines.
- ``objectstore_tool``: byte-equal ``export`` files for the same store
  contents, and each package's tool imports the other's export.
- ``monstore_tool``: the same ``dump-keys``, ``show-paxos``,
  ``show-osdmap`` and ``get`` output on a store a reference mon wrote.
- Two faults of the reference's ``VStartCluster`` that the port does
  not copy, each asserted as the reference has it: ``leader()``
  returns a mon that was shut down (R13), and a second ``start_mgr``
  leaves the first mgr's dashboard serving (R14).
"""

import contextlib
import io
import os
import sys

import numpy as np
import pytest

import ceph_tpu.core.context as ref_context
import ceph_tpu.crush.map as ref_cmap
import ceph_tpu.mgr.manager as ref_manager
import ceph_tpu.osd.osdmap as ref_osdmap
import ceph_tpu.store as ref_store
from ceph_tpu.store import objectstore as ref_os
from ceph_tpu.tpu import devwatch as ref_devwatch
from ceph_tpu_torch.core import context as port_context
from ceph_tpu_torch.crush import map as port_cmap
from ceph_tpu_torch.gpu import devwatch as port_devwatch
from ceph_tpu_torch.mgr import manager as port_manager
from ceph_tpu_torch.osd import osdmap as port_osdmap
from ceph_tpu_torch import store as port_store
from ceph_tpu_torch.store import objectstore as port_os
from ceph_tpu_torch.tools import ceph as port_ceph
from ceph_tpu_torch.tools import monstore_tool as port_monstore
from ceph_tpu_torch.tools import objectstore_tool as port_ostool

TOOLS = os.path.abspath(os.path.join(os.path.dirname(__file__), "..",
                                     "tools"))
if TOOLS not in sys.path:
    sys.path.insert(0, TOOLS)

import ceph as ref_ceph  # noqa: E402
import monstore_tool as ref_monstore  # noqa: E402
import objectstore_tool as ref_ostool  # noqa: E402

SEED = 20261019
REF = (ref_context, ref_manager, ref_cmap, ref_osdmap)
PORT = (port_context, port_manager, port_cmap, port_osdmap)


def _capture(fn, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf), \
            contextlib.redirect_stderr(io.StringIO()):
        rc = fn(argv)
    return rc, buf.getvalue()


def _counters(context_mod, name, seed):
    """A Context with one counter of each kind, bumped from ``seed``."""
    rng = np.random.default_rng(seed)
    ctx = context_mod.Context(name, {})
    pc = ctx.perf.create(f"{name}.op")
    pc.add_u64_counter("op_w")
    pc.add_u64_gauge("queue-depth")
    pc.add_time_avg("op_w_latency")
    pc.add_histogram("lat_op_us")
    pc.inc("op_w", int(rng.integers(1, 1000)))
    pc.set("queue-depth", int(rng.integers(0, 64)))
    for v in rng.uniform(0.0, 2.0, 5):
        pc.tinc("op_w_latency", float(v))
    for v in rng.integers(1, 1 << 20, 40):
        pc.hinc("lat_op_us", int(v))
    return ctx


HEALTH = ("HEALTH_WARN", {"OSD_DOWN": {"severity": "HEALTH_WARN",
                                       "summary": "1 osds down"}})
DIGEST = {"pg_states": {"active+clean": 6, "active+degraded": 2},
          "num_pgs": 8, "degraded_objects": 3, "misplaced_objects": 0,
          "unfound_objects": 0, "used_bytes": 1 << 20,
          "total_bytes": 1 << 30,
          "io": {"client_write_ops_per_s": 2.5, "recovery_bytes_per_s": 0},
          "pools": {1: {"objects": 4, "bytes": 4096, "degraded": 1},
                    2: {"objects": 9, "bytes": 1 << 16, "degraded": 0}}}
QOS = {"classes": {"client": {"depth": 2, "admitted": 17},
                   "recovery": {"depth": 0}},
       "dequeue_phases": {"reservation": 3, "weight": 14},
       "recovery": {"effective_window": 4},
       "throttle": {"stalls": 1}}


class _QosStub:
    def status(self, msgr_perf=None):
        return QOS


class _Svc:
    """A daemon service as the QoS module reads one."""

    def __init__(self) -> None:
        self.qos = _QosStub()
        self.msgr = None


def _mgr(pkg, osdmap=None):
    context_mod, manager_mod = pkg[0], pkg[1]
    mgr = manager_mod.MgrDaemon(context_mod.Context("mgr.x", {}))
    for i in range(3):
        mgr.register_daemon(f"osd.{i}", _counters(context_mod, f"osd.{i}",
                                                  SEED + i),
                            service=_Svc())
    mgr.health_fn = lambda: HEALTH
    mgr.pgmap_digest_fn = lambda: DIGEST
    mgr.osdmap = osdmap
    return mgr


def _build_map(pkg, n_osds=16, hosts=4, pg_num=64, **dev):
    """One seeded map: a flat cluster with a replicated and an EC-typed
    pool, some OSDs reweighted and one down."""
    cmap, osdmap = pkg[2], pkg[3]
    rng = np.random.default_rng(SEED)
    cm, root = cmap.build_flat_cluster(n_osds, hosts=hosts)
    cm.add_simple_rule("r", root, 1, mode="firstn")
    m = osdmap.OSDMap(cm, max_osd=n_osds, **dev)
    m.add_pool(osdmap.PGPool(1, osdmap.POOL_REPLICATED, size=3, min_size=2,
                             pg_num=pg_num, pgp_num=pg_num, crush_rule=0))
    m.add_pool(osdmap.PGPool(2, 3, size=3, min_size=2, pg_num=16,
                             pgp_num=16, crush_rule=0))
    for o in rng.choice(n_osds, 4, replace=False):
        m.osd_weight[o] = int(rng.integers(0x8000, 0x10000))
    m.osd_state_up[int(rng.integers(n_osds))] = False
    return m


def _same_compile_table(monkeypatch):
    """A fresh device watch in each package, fed one sequence under one
    clock: a first launch of a family both declare, a hit, and a rogue
    first launch."""
    clock = [500.0]
    monkeypatch.setattr("time.monotonic", lambda: clock[0])
    sig = (("arr", "uint8", (8, 4096)), ("arr", "uint8", (4, 4096)))
    rogue = (("arr", "uint8", (8, 4097)), ("arr", "uint8", (4, 4097)))
    for mod in (ref_devwatch, port_devwatch):
        w = mod.DeviceWatch()
        monkeypatch.setattr(mod, "_WATCH", w)
        for s, wall in ((sig, 0.25), (rogue, 0.5)):
            tok = w.compile_begin("gf2_matmul")
            clock[0] += wall
            w.compile_end(tok, s)
        w.note_hit("gf2_matmul", 37e-6)


def test_prometheus_export_is_byte_equal(monkeypatch):
    _same_compile_table(monkeypatch)
    bodies = []
    for pkg in (REF, PORT):
        code, out = _mgr(pkg).handle_command({"prefix": "prometheus export"})
        assert code == 0
        bodies.append(out["body"])
    assert bodies[0] == bodies[1]
    assert "ceph_osd_0_op_lat_op_us_bucket" in bodies[1]
    assert 'ceph_qos_queue_depth{daemon="osd.0",class="client"} 2' in \
        bodies[1]
    assert 'ceph_xla_compile_total{family="gf2_matmul"} 2' in bodies[1]
    assert 'ceph_xla_rogue_compiles{family="gf2_matmul"} 1' in bodies[1]
    assert 'ceph_xla_exec_us_bucket{family="gf2_matmul",le="+Inf"} 1' in \
        bodies[1]


def test_telemetry_show_matches(monkeypatch):
    monkeypatch.setattr("time.time", lambda: 1760000000.25)
    reports = []
    for pkg, dev in ((REF, {}), (PORT, {"device": "cpu"})):
        mgr = _mgr(pkg, _build_map(pkg, **dev))
        code, rep = mgr.handle_command({"prefix": "telemetry show"})
        assert code == 0
        reports.append(rep)
    assert reports[0] == reports[1]
    assert reports[1]["osds"] == {"count": 16, "up": 15}
    assert [p["type"] for p in reports[1]["pools"]] == ["replicated",
                                                        "erasure"]


def test_balancer_optimize_gives_the_same_moves():
    outs = []
    for pkg, dev in ((REF, {}), (PORT, {"device": "cpu"})):
        mgr = _mgr(pkg, _build_map(pkg, **dev))
        code, out = mgr.handle_command({"prefix": "balancer optimize",
                                        "pool": 1, "max_moves": 8})
        assert code == 0
        outs.append(out)
    assert outs[0] == outs[1]
    assert outs[1]["moves"]
    code, _ = port_manager.MgrDaemon(port_context.Context("m", {})) \
        .handle_command({"prefix": "balancer optimize", "pool": 1})
    assert code == -2  # no osdmap fed


def _rows(step):
    """Step ``step``'s per-PG rows: two PGs recovering at different
    rates, one damaged by scrub, a replica row that never opens an
    event."""
    deg_a = max(0, 40 - 7 * step)
    deg_b = max(0, 12 - 2 * step) if step >= 1 else 0
    rows = [{"pgid": "1.0", "primary": True, "degraded": deg_a},
            {"pgid": "1.1", "primary": True, "degraded": deg_b},
            {"pgid": "1.0", "primary": False, "degraded": 5},
            {"pgid": "2.3", "primary": True, "degraded": 0,
             "scrub_errors": max(0, 3 - step // 2)}]
    return rows


def test_progress_events_and_etas_match():
    outs = []
    for pkg in (REF, PORT):
        mgr = _mgr(pkg)
        step = [0]
        mgr.pg_rows_fn = lambda: _rows(step[0])
        prog = mgr.modules["progress"]
        prog._now = lambda: 100.0 + 1.5 * step[0]
        seq = []
        for s in range(9):
            step[0] = s
            code, out = mgr.handle_command({"prefix": "progress"})
            assert code == 0
            seq.append(out)
        outs.append(seq)
    assert outs[0] == outs[1]
    last = outs[1][-1]
    assert not last["events"]
    assert {e["id"] for e in last["completed"]} == {
        "recovery-1.0", "recovery-1.1", "repair-2.3"}
    assert any(e["eta_s"] not in (None, 0.0) for s in outs[1]
               for e in s["events"])


LINES = [
    "osd pool create data 32", "osd pool create ec 16 erasure "
    "erasure_code_profile=p1", "osd erasure-code-profile set p1 k=4 m=2",
    "osd erasure-code-profile ls", "osd out 3", "osd in 3", "osd down 1",
    "osd reweight 2 0.5", "osd dump", "osd df", "osd tree", "pg dump",
    "pg scrub 1.0", "pg deep-scrub 2.3", "pg repair 1.7", "fs status",
    "mds fail 0", "df", "status", "-s", "health", "health mute OSD_DOWN",
    "health unmute OSD_DOWN", "health detail", "progress", "crash ls",
    "crash info 2026-01-01T00:00:00.000000", "device compile dump",
    "prometheus export", "ops dump_slow", "ops dump_in_flight",
    "ops latency", "qos status", "qos set tenant:client.9 33 44 0",
    "mgr status", "config set osd.1 debug 5 10", "config rm global debug",
    "config get osd.1", "config dump", "auth get-or-create client.app",
    "auth get client.app", "auth ls", "auth rm client.app", "log hello there",
    "log last", "log last 7", "mon dump", "mon add 127.0.0.1:6790",
    "mon rm 2",
]


@pytest.mark.parametrize("line", LINES)
def test_ceph_parse_gives_the_same_command(line):
    tokens = line.split()
    assert port_ceph._parse(tokens) == ref_ceph._parse(tokens)


def test_ceph_parse_refuses_the_same_lines():
    for line in ("frobnicate", "osd", "auth"):
        for parse in (ref_ceph._parse, port_ceph._parse):
            with pytest.raises((ValueError, IndexError)):
                parse(line.split())


def _fill(store_mod, os_mod, path):
    """Both packages' FileStores with the same two PGs."""
    s = store_mod.create("filestore", path=path)
    s.mkfs()
    s.mount()
    rng = np.random.default_rng(SEED)
    for pg in ("3.1", "3.2"):
        coll = os_mod.Collection(f"{pg}_head")
        t = os_mod.Transaction()
        t.create_collection(coll)
        for j in range(4):
            g = os_mod.GHObject(f"obj{j}", shard=j % 3)
            t.write(coll, g, 0, rng.integers(0, 256, 1000 + 77 * j,
                                             dtype=np.uint8).tobytes())
            t.setattrs(coll, g, {"hinfo": bytes([j]) * 12, "_": b"oi"})
            t.omap_setkeys(coll, g, {f"k{j}": b"v" * j, "z": b""})
        t.touch(coll, os_mod.GHObject("empty"))
        s.queue_transaction(t)
    s.umount()


def test_objectstore_exports_are_byte_equal_and_cross_import(tmp_path):
    exports = {}
    for name, tool, store_mod, os_mod in (
            ("ref", ref_ostool, ref_store, ref_os),
            ("port", port_ostool, port_store, port_os)):
        path = str(tmp_path / f"{name}-osd")
        _fill(store_mod, os_mod, path)
        rc, listed = _capture(tool.main, ["--data-path", path,
                                          "--op", "list-pgs"])
        assert rc == 0 and listed.split() == ["3.1", "3.2"]
        exports[name] = str(tmp_path / f"{name}.exp")
        rc, _ = _capture(tool.main, ["--data-path", path, "--op", "export",
                                     "--pgid", "3.2", "--file",
                                     exports[name]])
        assert rc == 0
    with open(exports["ref"], "rb") as a, open(exports["port"], "rb") as b:
        assert a.read() == b.read()

    # each package imports the other's export into a blockstore
    for name, tool, store_mod, os_mod, other in (
            ("ref", ref_ostool, ref_store, ref_os, "port"),
            ("port", port_ostool, port_store, port_os, "ref")):
        path = str(tmp_path / f"{name}-dst")
        s = store_mod.create("blockstore", path=path)
        s.mkfs(); s.mount(); s.umount()
        rc, out = _capture(tool.main, ["--data-path", path, "--type",
                                       "blockstore", "--op", "import",
                                       "--file", exports[other]])
        assert rc == 0 and out.strip() == "imported 5 objects into 3.2_head"
        src = store_mod.create("filestore", path=str(tmp_path /
                                                     f"{other}-osd"))
        dst = store_mod.create("blockstore", path=path)
        src.mount()
        dst.mount()
        coll = os_mod.Collection("3.2_head")
        objs = src.collection_list(coll)
        assert dst.collection_list(coll) == objs
        for g in objs:
            assert dst.read(coll, g) == src.read(coll, g)
            assert dst.getattrs(coll, g) == src.getattrs(coll, g)
            assert dst.omap_get(coll, g) == src.omap_get(coll, g)
        src.umount()
        dst.umount()


def test_monstore_tool_output_matches_on_a_reference_store(tmp_path):
    from ceph_tpu.vstart import VStartCluster as RefVStart

    d = str(tmp_path / "cluster")
    with RefVStart(n_mons=1, n_osds=3, data_dir=d) as c:
        pool = c.create_pool("data", size=2)
        c.client().ioctx(pool).write_full("o", b"v")
    store = os.path.join(d, "mon0")
    for argv in (["dump-keys"], ["show-paxos"], ["show-osdmap"],
                 ["get", "paxos", "last_committed"],
                 ["get", "mon", "nope"]):
        ref = _capture(ref_monstore.main, [store] + argv)
        port = _capture(port_monstore.main, [store] + argv)
        assert port == ref, argv
    rc, out = _capture(port_monstore.main, [store, "show-osdmap"])
    assert rc == 0 and "pool 1 'data'" in out and "up osds: [0, 1, 2]" in out


def test_the_reference_leader_returns_a_lost_mon():
    """R13: the reference's ``VStartCluster.leader()`` returns a mon
    that was shut down (it keeps its ``leader`` state) after the others
    elected a new leader, so the mgr's feeds read the lost mon.  The
    port skips it (F16, ``tests/test_torch_mgr.py``)."""
    from ceph_tpu.vstart import VStartCluster as RefVStart

    with RefVStart(n_mons=3, n_osds=1, conf={"mon_lease": 1.0}) as c:
        old = c.leader()
        old.shutdown()
        try:
            c.wait_for(lambda: any(mo.state == "leader" for mo in c.mons
                                   if mo is not old), what="a new leader")
            assert c.leader() is old
        finally:
            c.mons = [mo for mo in c.mons if mo is not old]


def test_the_reference_start_mgr_leaves_the_first_mgr_running():
    """R14: a second ``start_mgr`` of the reference's ``VStartCluster``
    leaves the first mgr's dashboard serving after ``shutdown``, which
    stops only the second.  The port's ``start_mgr`` stops the first
    (``tests/test_torch_mgr.py``)."""
    from ceph_tpu.vstart import VStartCluster as RefVStart

    c = RefVStart(n_mons=1, n_osds=1)
    first = None
    try:
        first = c.start_mgr(dashboard=True)
        c.start_mgr(dashboard=True)
    finally:
        c.shutdown()
    try:
        assert first.modules["dashboard"].server is not None
    finally:
        first.modules["dashboard"].stop()
