"""The port's command-line tools on the CPU (``--device cpu``).

- crushtool and osdmaptool: their cases of tests/test_cli_tools.py,
  case for case, binary map files included (reference:
  src/tools/crushtool.cc, src/tools/osdmaptool.cc).  Their JSON against
  the reference tools is held in tests/test_torch_crush.py and
  tests/test_torch_osdmap_xcheck.py, and a binary map crosses between
  the two packages here.
- rados_bench, objectstore_tool and monstore_tool:
  tests/test_cli_tools.py ``:116`` (``ObjBencher`` over the port's
  ``DaemonCluster``), ``:155`` (an objectstore export imported into
  another backend) and ``:222`` (the monstore tool on a store the port's
  ``VStartCluster`` wrote).
- rados and ceph: tests/test_vstart_rados_cli.py ``:87``, ``:107`` and
  ``:136``.  ``:154`` (rbd) waits for ROADMAP queue 1 item 6c and
  ``:196`` (the cephfs shell) for item 6d.
- cephtop: tests/test_optracker.py ``:310``, and its ``--device`` pane
  over the port's ``device compile dump``.
- Without ``--device`` and without a card, rados, ceph and rados_bench
  raise before any daemon starts.  objectstore_tool, monstore_tool and
  cephtop take no ``--device``: they touch no device.

Every wait polls with a deadline.  The outputs held against the
reference tools' are in tests/test_torch_mgr_xcheck.py."""

import contextlib
import io
import json
import os
import tempfile
import threading

import pytest
import torch

from ceph_tpu.core.encoding import Decoder as RefDecoder
from ceph_tpu.crush.compiler import decompile as ref_decompile
from ceph_tpu.osd.map_codec import decode_crush as ref_decode_crush
import torch_daemon_harness as H
from ceph_tpu_torch.tools import (ceph, cephtop, crushtool, monstore_tool,
                                  objectstore_tool, osdmaptool, rados,
                                  rados_bench)
from ceph_tpu_torch.tools.rados_bench import ObjBencher

CPU = ["--device", "cpu"]


def _capture(fn, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf), \
            contextlib.redirect_stderr(io.StringIO()):
        rc = fn(argv)
    return rc, buf.getvalue()


def test_crushtool_build_and_test(tmp_path):
    mapfn = str(tmp_path / "map.bin")
    rc, _ = _capture(crushtool.main, ["--build", "--num_osds", "16",
                                      "host", "straw2", "4",
                                      "root", "straw2", "0",
                                      "-o", mapfn])
    assert rc == 0 and os.path.exists(mapfn)
    rc, text = _capture(crushtool.main,
                        ["-i", mapfn, "--test", "--num-rep", "3",
                         "--min-x", "0", "--max-x", "499",
                         "--show-statistics", "--show-utilization"] + CPU)
    assert rc == 0
    out = json.loads(text)
    st = out["statistics"]
    assert st["total_mappings"] == 500 and st["bad_mappings"] == 0
    u = st["device_utilization"]
    assert u["min"] > 0 and abs(u["mean"] - 500 * 3 / 16) < 1
    assert len(out["utilization"]) == 16


def test_crushtool_weights_zero_out_device(tmp_path):
    mapfn = str(tmp_path / "m.bin")
    _capture(crushtool.main, ["--build", "--num_osds", "8",
                              "root", "straw2", "0", "-o", mapfn])
    rc, text = _capture(crushtool.main,
                        ["-i", mapfn, "--test", "--num-rep", "2",
                         "--max-x", "299", "--show-utilization",
                         "--weight", "3", "0"] + CPU)
    assert rc == 0
    out = json.loads(text)
    assert out["utilization"]["osd.3"] == 0


def test_osdmaptool_createsimple_and_test_map_pgs(tmp_path):
    mapfn = str(tmp_path / "osdmap.bin")
    rc, _ = _capture(osdmaptool.main,
                     ["--createsimple", "16", "--pg_num", "64",
                      "-o", mapfn] + CPU)
    assert rc == 0 and os.path.exists(mapfn)
    rc, text = _capture(osdmaptool.main, [mapfn, "--test-map-pgs"] + CPU)
    assert rc == 0
    out = json.loads(text)
    assert out["pool_pgs_examined"] == 64
    assert sum(out["osd_pg_counts"].values()) == 64 * 3
    assert out["summary"]["max"] >= out["summary"]["min"] > 0


def test_osdmaptool_upmap(tmp_path):
    mapfn = str(tmp_path / "osdmap2.bin")
    _capture(osdmaptool.main, ["--createsimple", "24", "--pg_num", "128",
                               "-o", mapfn] + CPU)
    rc, text = _capture(osdmaptool.main,
                        [mapfn, "--upmap", "--upmap-max", "16",
                         "--upmap-deviation", "0.5"] + CPU)
    assert rc == 0
    out = json.loads(text)
    assert out["upmaps"], "no upmap entries emitted"
    sd = out["stddev"]["pool.1"]
    assert sd["after"] <= sd["before"]


def test_crushtool_compile_decompile_roundtrip(tmp_path):
    """crushtool -d / -c (reference CrushCompiler, crushtool.cc)."""
    binfn = str(tmp_path / "m.bin")
    textfn = str(tmp_path / "m.txt")
    bin2fn = str(tmp_path / "m2.bin")
    rc, _ = _capture(crushtool.main, ["--build", "--num_osds", "8",
                                      "host", "straw2", "4",
                                      "root", "straw2", "0", "-o", binfn])
    assert rc == 0
    rc, _ = _capture(crushtool.main, ["-d", "-i", binfn, "-o", textfn])
    assert rc == 0
    text = open(textfn).read()
    assert "alg straw2" in text and "item osd.0 weight" in text
    rc, _ = _capture(crushtool.main, ["-c", textfn, "-o", bin2fn])
    assert rc == 0
    rc, out2 = _capture(crushtool.main, ["-d", "-i", bin2fn])
    assert rc == 0
    assert out2 == text
    # the binary file is the reference codec's: it decodes there to the
    # same map
    with open(bin2fn, "rb") as f:
        assert ref_decompile(ref_decode_crush(RefDecoder(f.read()))) == text


# -- tests/test_cli_tools.py:116, :155, :222 ----------------------------------

def test_obj_bencher(tmp_path):
    c = H.DaemonCluster("ceph_tpu_torch", device="cpu")
    cl = H.LibClient(c)
    try:
        b = ObjBencher(cl.rc.ioctx(H.REP_POOL))
        w = b.write(seconds=1.0, threads=4, size=4096)
        assert w["total_ops"] > 0 and w["errors"] == 0
        assert w["mb_per_sec"] > 0
        r = b.seq(seconds=0.5, threads=4)
        assert r["total_ops"] > 0 and r["errors"] == 0
        b.cleanup()
    finally:
        cl.shutdown()
        c.shutdown()


def test_objectstore_tool_export_import_roundtrip(tmp_path):
    """ceph-objectstore-tool role (src/tools/ceph_objectstore_tool.cc):
    offline PG export from one store, import into another backend."""
    from ceph_tpu_torch.store import create
    from ceph_tpu_torch.store.objectstore import (Collection, GHObject,
                                                  Transaction)

    src = create("filestore", path=str(tmp_path / "osd0"))
    src.mkfs(); src.mount()
    coll = Collection("3.1_head")
    t = Transaction()
    t.create_collection(coll)
    t.write(coll, GHObject("a"), 0, b"alpha" * 100)
    t.setattrs(coll, GHObject("a"), {"k": b"v"})
    t.omap_setkeys(coll, GHObject("a"), {"o": b"m"})
    t.write(coll, GHObject("b", shard=2), 0, b"beta")
    src.queue_transaction(t)
    src.umount()

    rc, out = _capture(objectstore_tool.main,
                       ["--data-path", str(tmp_path / "osd0"),
                        "--op", "list-pgs"])
    assert rc == 0 and out.strip() == "3.1"
    rc, out = _capture(objectstore_tool.main,
                       ["--data-path", str(tmp_path / "osd0"),
                        "--op", "list", "--pgid", "3.1"])
    assert rc == 0 and len(out.strip().splitlines()) == 2
    exp = str(tmp_path / "pg.exp")
    rc, _ = _capture(objectstore_tool.main,
                     ["--data-path", str(tmp_path / "osd0"),
                      "--op", "export", "--pgid", "3.1", "--file", exp])
    assert rc == 0

    # import into a DIFFERENT backend (blockstore)
    dst = create("blockstore", path=str(tmp_path / "osd1"))
    dst.mkfs(); dst.mount(); dst.umount()
    rc, _ = _capture(objectstore_tool.main,
                     ["--data-path", str(tmp_path / "osd1"),
                      "--type", "blockstore", "--op", "import",
                      "--file", exp])
    assert rc == 0
    dst = create("blockstore", path=str(tmp_path / "osd1"))
    dst.mount()
    assert dst.read(coll, GHObject("a")) == b"alpha" * 100
    assert dst.getattr(coll, GHObject("a"), "k") == b"v"
    assert dst.omap_get(coll, GHObject("a")) == {"o": b"m"}
    assert dst.read(coll, GHObject("b", shard=2)) == b"beta"
    dst.umount()

    # double import refused; remove then re-import works
    rc, _ = _capture(objectstore_tool.main,
                     ["--data-path", str(tmp_path / "osd1"),
                      "--type", "blockstore", "--op", "import",
                      "--file", exp])
    assert rc == 1
    rc, _ = _capture(objectstore_tool.main,
                     ["--data-path", str(tmp_path / "osd1"),
                      "--type", "blockstore", "--op", "remove",
                      "--pgid", "3.1"])
    assert rc == 0
    rc, _ = _capture(objectstore_tool.main,
                     ["--data-path", str(tmp_path / "osd1"),
                      "--type", "blockstore", "--op", "import",
                      "--file", exp])
    assert rc == 0


def test_monstore_tool_offline(tmp_path):
    """ceph-monstore-tool role (reference ceph_monstore_tool.cc):
    inspect a DOWN mon's store — paxos range, current osdmap (anchor +
    incremental replay), raw key surgery."""
    from ceph_tpu_torch.vstart import VStartCluster

    d = str(tmp_path / "cluster")
    with VStartCluster(n_mons=1, n_osds=3, data_dir=d, device="cpu") as c:
        pool = c.create_pool("data", size=2)
        c.client().ioctx(pool).write_full("o", b"v")
    store = os.path.join(d, "mon0")

    def run(*argv):
        return _capture(monstore_tool.main, list(argv))

    rc, out = run(store, "show-paxos")
    assert rc == 0 and "last_committed:" in out
    rc, out = run(store, "show-osdmap")
    assert rc == 0 and "pool 1 'data'" in out
    # the replayed map reflects booted OSDs, not the blank anchor
    assert "up osds: [0, 1, 2]" in out
    rc, out = run(store, "dump-keys")
    assert rc == 0 and "paxos/last_committed" in out
    rc, out = run(store, "get", "paxos", "last_committed")
    assert rc == 0
    # surgery: set + rm round-trip on a scratch key
    rc, _ = run(store, "set", "mon", "scratch", "deadbeef")
    assert rc == 0
    rc, out = run(store, "get", "mon", "scratch")
    assert rc == 0 and "deadbeef" in out
    rc, _ = run(store, "rm", "mon", "scratch")
    assert rc == 0
    rc, _ = run(store, "get", "mon", "scratch")
    assert rc == 2


# -- tests/test_vstart_rados_cli.py:87, :107, :136 ----------------------------

def test_rados_cli_script():
    with tempfile.NamedTemporaryFile(delete=False) as f:
        f.write(b"cli-payload")
        path = f.name
    rc, out = _capture(rados.main, [
        "--vstart", "1x3", "--pool", "cli", "--pool-size", "2",
        "--script",
        f"mkpool cli; put a {path}; stat a; ls; df",
    ] + CPU)
    assert rc == 0
    lines = out.strip().splitlines()
    assert lines[0].startswith("pool cli id ")
    assert "a size 11" in out
    assert "osds: 3/3 up" in out
    os.unlink(path)


def test_ceph_admin_cli_script():
    rc, out = _capture(ceph.main, [
        "--vstart", "1x3", "--script",
        "status; health; osd tree; config set global debug 5; "
        "config get osd.1; log cli smoke; log last 5; mon dump",
    ] + CPU)
    assert rc == 0
    status, health, tree, cset, cget, logw, loglast, mondump = \
        _split_docs(out)
    assert status["rc"] == 0 and status["num_up_osds"] == 3
    assert health["status"] == "HEALTH_OK"
    assert any(n["name"] == "osd.2" for n in tree["nodes"])
    assert any(n.get("type") for n in tree["nodes"])
    assert cget["config"]["debug"] == "5"  # global applies to osd.1
    assert loglast["lines"][-1]["msg"] == "cli smoke"
    assert mondump["monmap"]["epoch"] >= 1


def test_ceph_cli_osd_down_and_cephx():
    rc, out = _capture(ceph.main, [
        "--vstart", "1x3", "--cephx", "--script",
        "auth get-or-create client.app; auth ls; osd out 1; health",
    ] + CPU)
    assert rc == 0
    docs = [json.loads(d) for d in
            out.replace("}\n{", "}\x00{").split("\x00")]
    create, ls, _out_cmd, health = docs
    assert len(bytes.fromhex(create["key"])) == 32
    assert "client.app" in ls["entities"]
    assert health["status"] == "HEALTH_WARN"  # osd.1 out
    assert "OSD_OUT" in health["checks"]


def test_ceph_cli_routes_mgr_and_daemon_commands():
    """The mgr prefixes reach a mgr started on demand, the daemon
    command reaches the OSD service itself, and a line the table does
    not know ends the script with 22."""
    rc, out = _capture(ceph.main, [
        "--vstart", "1x3", "--script",
        "mgr status; ops latency; daemon osd.1 device warmup; "
        "prometheus export"] + CPU)
    assert rc == 0
    json_part, metrics = out.split("\n# TYPE ", 1)
    status, lat, warm = _split_docs(json_part)
    assert status["rc"] == 0 and "cluster" in status["daemons"]
    assert "prometheus" in status["modules"]
    assert lat["rc"] == 0
    assert warm["rc"] == 0 and "buckets_warmed" in warm, warm
    assert metrics.endswith("\n") and "ceph_health_status" in metrics
    rc, _ = _capture(ceph.main, ["--vstart", "1x1", "--script",
                                 "status; no such command"] + CPU)
    assert rc == 22


def test_rados_bench_selftest_on_the_cpu():
    rc, out = _capture(rados_bench.main, [
        "0.5", "seq", "--selftest", "-p", str(H.REP_POOL), "-t", "2",
        "-b", "4096"] + CPU)
    assert rc == 0
    w, r = _split_docs(out)
    assert w["op"] == "write" and w["total_ops"] > 0 and w["errors"] == 0
    assert r["op"] == "seq" and r["total_ops"] > 0 and r["errors"] == 0


def _split_docs(out):
    """The JSON documents the ceph tool printed one after another."""
    docs, depth, buf = [], 0, ""
    for line in out.splitlines():
        buf += line + "\n"
        depth += line.count("{") - line.count("}")
        if depth == 0 and buf.strip():
            docs.append(json.loads(buf))
            buf = ""
    return docs


@pytest.mark.parametrize("tool,argv", [
    (rados, ["--vstart", "1x1", "--script", "ls"]),
    (ceph, ["--vstart", "1x1", "--script", "status"]),
    (rados_bench, ["1", "write", "--selftest"]),
])
def test_cluster_clis_raise_without_a_card(tool, argv, monkeypatch):
    """With no --device and no card, each cluster CLI raises before a
    daemon or a thread starts: it never runs on the CPU by itself."""
    before = {t.ident for t in threading.enumerate()}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        _capture(tool.main, argv)
    assert [t for t in threading.enumerate() if t.ident not in before] == []


# -- tests/test_optracker.py:310 and the device pane ---------------------------

def test_cephtop_renders_breakdown(tmp_path):
    """cephtop end-to-end over a real admin socket."""
    sock = str(tmp_path / "a.sock")
    c = H.DaemonCluster("ceph_tpu_torch", overrides={"admin_socket": sock},
                        device="cpu")
    cl = H.LibClient(c)
    try:
        c.ctx.conf.set_val("osd_op_complaint_time", 0.0)
        io_ = cl.rc.ioctx(H.REP_POOL)
        io_.write_full("topobj", b"t" * 512)
        rc, out = _capture(cephtop.main, ["--socket", sock])
        assert rc == 0
        assert "lat_reply_us" in out and "p99_us" in out
        rc, out = _capture(cephtop.main, ["--socket", sock, "--slow"])
        assert rc == 0
        assert "topobj" in out
    finally:
        cl.shutdown()
        c.shutdown()


def test_cephtop_device_pane_reads_the_port_dump(tmp_path):
    """--device renders the port's ``device compile dump``: the kernel
    build, the compile table (a row a family with its first launches),
    a row a kernel with its launches, the queue's batches."""
    from ceph_tpu_torch.core.context import Context
    from ceph_tpu_torch.gpu import devwatch

    sock = str(tmp_path / "d.sock")
    ctx = Context("osd.0", {"admin_socket": sock})
    # one first launch of the CRC's plain version: a family in the table
    from ceph_tpu_torch.ops.crc32c_device import crc32c_dev

    crc32c_dev(b"cephtop", device="cpu")
    try:
        rc, out = _capture(cephtop.main, ["--socket", sock, "--device"])
        assert rc == 0
        assert out.startswith("kernels: ")
        table = out.index("family ")
        assert "compiles" in out[table:].splitlines()[0]
        assert "\ncrc32c_rows " in out[table:out.index("\nkernel ")], out
        assert "\ntotal: " in out
        for name in devwatch.watch().launches():
            assert f"\n{name} " in out[out.index("\nkernel "):], (name, out)
        assert "batches: " in out
        rc, out = _capture(cephtop.main, ["--socket", sock, "--device",
                                          "--json"])
        assert rc == 0
        assert json.loads(out)["launches"].keys() == \
            devwatch.watch().launches().keys()
    finally:
        ctx.shutdown()
