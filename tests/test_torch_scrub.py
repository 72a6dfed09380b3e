"""The port's ``ScrubEngine`` (``ceph_tpu_torch/osd/scrub.py``) on its
own, over the loopback PGs of ``torch_pg_harness.Net``, on the CPU.

The engine-level cases of ``tests/test_scrub_engine.py``, as their
assertions go: a clean deep scrub stamps and dumps (``:55``); the
stamps survive a restart, here a new ``PG`` over the same store
reloading them (``:75``); a silent bit flip passes the shallow scrub, is
found by the deep one and auto-repaired with replace semantics and the
right ``_av`` (``:93``); the ``store.corrupt_chunk`` failpoint is seeded
and scoped (``:133``); ``store.corrupt_xattr`` is metadata rot a shallow
scrub sees (``:178``); a chunk's decodes coalesce into one wide ``dec``
batch (``:210``); an interrupted deep scrub resumes from its cursor
(``:240``).  Their ``MiniCluster`` rows (``dump_scrubs``, ``pg_stats``)
are the daemon's: the engine's own ``dump()`` stands for them here.

The cases of ``test_scrub_engine.py`` that need the daemon run over
the port's daemon in ``test_torch_daemon.py``: ``:297`` (the scrub as a
qos tenant of the daemon's workqueue) and ``:309`` (the scrub
scheduler).  ``:337`` and ``:432`` (the mon's PG_DAMAGED and
PG_NOT_DEEP_SCRUBBED checks) wait for the client and the cluster,
ROADMAP queue 1 item 1j.

Beyond the reference's cases, the port's own differences: a shec pool
(no MDS recovery) verifies through the codec's decode, never the
queue's ``dec`` kind; and the engine takes a queue future that answers
a tensor as well as a host array.
"""

import threading
from concurrent.futures import Future

import numpy as np
import pytest
import torch

import torch_pg_harness as H
from ceph_tpu_torch.core import failpoint as fp
from ceph_tpu_torch.osd import types as t_
from ceph_tpu_torch.store.objectstore import ChecksumError, GHObject

EC = "plugin=isa k=2 m=1 technique=reed_sol_van"


@pytest.fixture(autouse=True)
def _disarmed():
    fp.disarm_all()
    yield
    fp.disarm_all()


def _net(profile=EC, n=3, **kw):
    return H.Net("ceph_tpu_torch", profile, n, **kw)


def _put(net, oid, data, n=[0]):
    n[0] += 1
    rep = net.op(oid, [t_.OSDOp(t_.OP_WRITEFULL, data=data)],
                 reqid=f"client.1:{n[0]}")
    assert rep.result == 0
    net.settle()


def _get(net, oid):
    net.primary.pg._obc_invalidate()
    rep = net.op(oid, [t_.OSDOp(t_.OP_READ)])
    assert rep.result == 0
    return bytes(rep.ops[0].out_data)


def _victim(net):
    """A shard held by a peer, never the primary's."""
    shard = next(s for s, o in enumerate(net.acting) if o != 0)
    return shard, net.acting[shard]


def test_deep_scrub_clean_stamps_and_dump():
    net = _net()
    try:
        for i in range(4):
            _put(net, f"dsc{i}", bytes([i + 1]) * 2500)
        pg = net.primary.pg
        eng = pg.scrub_engine()
        assert pg.scrub_engine() is eng
        assert eng.run(deep=True) == {}
        assert pg.last_deep_scrub > 0 and pg.last_scrub > 0
        assert pg.scrub_errors == 0
        row = eng.dump()
        assert row["pgid"] == t_.pgid_str(pg.pgid)
        assert row["last_deep_scrub"] == pg.last_deep_scrub
        assert row["running"] is False and row["cursor"] == ""
        perf = net.primary.scrub_perf.dump()
        assert perf["deep_done"] == 1 and perf["objects"] == 4
    finally:
        net.stop()


def test_stamps_survive_a_restart():
    net = _net()
    try:
        _put(net, "persist_me", b"stamp" * 500)
        pg = net.primary.pg
        assert pg.scrub_engine().run(deep=True) == {}
        stamp = pg.last_deep_scrub
        assert stamp > 0
        pg2 = type(pg)(pg.pgid, pg.pool, net.primary, pg.backend.codec)
        assert pg2.last_deep_scrub != stamp
        pg2.load_from_store()
        assert pg2.last_deep_scrub == stamp  # loaded from pg meta
        assert pg2.scrub_errors == 0
    finally:
        net.stop()


def test_shallow_misses_injected_flip_deep_detects_and_repairs():
    payload = b"rot-target" * 400
    net = _net()
    try:
        _put(net, "rot0", payload)
        pg = net.primary.pg
        shard, victim = _victim(net)
        store = net.hosts[victim].store
        g = GHObject("rot0", shard=shard)
        good_chunk = store.read(pg.coll, g)
        store.debug_data_err_enabled = True
        store.debug_inject_data_err(pg.coll, g)
        eng = pg.scrub_engine()
        # shallow scrub never reads data: the rot is invisible
        assert "rot0" not in eng.run(deep=False)
        assert pg.scrub_errors == 0
        # deep scrub reads bytes: the flipped shard surfaces
        errs = eng.run(deep=True, auto_repair=False)
        assert "rot0" in errs, errs
        assert any(str(shard) in e for e in errs["rot0"])
        assert pg.scrub_errors >= 1
        # auto-repair: rebuild, replace semantics, correct _av
        assert eng.run(deep=True, auto_repair=True) == {}
        assert pg.scrub_errors == 0
        # the rewrite cleared the mark AND the rebuilt bytes are the
        # authoritative chunk
        assert store.read(pg.coll, g) == good_chunk
        assert store.getattr(pg.coll, g, "_av") == pg._av_for("rot0")
        assert _get(net, "rot0") == payload
        assert eng.run(deep=True) == {}
        assert net.primary.scrub_perf.dump()["errors_repaired"] == 1
    finally:
        net.stop()


def test_corrupt_chunk_failpoint_is_seeded_and_scoped():
    """store.corrupt_chunk armed with a match scope flips ONLY the
    matched shard's reads, deterministically per seed; a verifying read
    refuses the flipped bytes; deep scrub sees them; disarming restores
    clean reads."""
    net = _net()
    try:
        _put(net, "fprot", b"fp-rot" * 500)
        pg = net.primary.pg
        shard, victim = _victim(net)
        g = GHObject("fprot", shard=shard)
        store = net.hosts[victim].store
        clean = store.read(pg.coll, g)
        fails0 = store.perf.value("read_verify_fail")
        fp.seed(0x15C)
        fp.arm("store.corrupt_chunk", fp.CORRUPT_ACTION,
               match={"oid": "fprot", "shard": str(shard)})
        with pytest.raises(ChecksumError):
            store.read(pg.coll, g)
        assert store.perf.value("read_verify_fail") > fails0
        store.verify_reads = False
        try:
            rotten = store.read(pg.coll, g)
            assert rotten != clean
            assert store.read(pg.coll, g) == rotten  # seeded
        finally:
            store.verify_reads = True
        # an unmatched object is untouched
        _put(net, "fpclean", b"x" * 100)
        assert _get(net, "fpclean") == b"x" * 100
        errs = pg.scrub_engine().run(deep=True, auto_repair=False)
        assert "fprot" in errs and "fpclean" not in errs, errs
        assert fp.fired("store.corrupt_chunk") > 0
        fp.disarm_all()
        assert store.read(pg.coll, g) == clean
        assert pg.scrub_engine().run(deep=True) == {}
    finally:
        net.stop()


def test_corrupt_xattr_failpoint():
    net = _net(profile=None)
    try:
        _put(net, "xrot", b"meta")
        rep = net.op("xrot", [t_.OSDOp(t_.OP_SETXATTR, name="user.k",
                                       data=b"value")], reqid="client.2:1")
        assert rep.result == 0
        net.settle()
        pg = net.primary.pg
        replica = net.hosts[1].store
        fp.arm("store.corrupt_xattr", fp.CORRUPT_ACTION,
               match={"oid": "xrot", "attr": "user.k"})
        got = replica.getattr(pg.coll, GHObject("xrot"), "user.k")
        assert got != b"value"
        # unmatched attrs pass clean
        assert replica.getattrs(pg.coll, GHObject("xrot"))["user.k"] == \
            b"value"
        fp.disarm_all()
        # xattr rot is METADATA rot: even the shallow scrub sees it (a
        # count(1) arming flips exactly one member's digest read)
        fp.arm("store.corrupt_xattr", fp.CORRUPT_ACTION, count=1,
               match={"oid": "xrot", "attr": "user.k"})
        errs = pg.scrub_engine().run(deep=False)
        assert "xrot" in errs, errs
        fp.disarm_all()
        assert pg.scrub_engine().run(deep=False) == {}
    finally:
        net.stop()


def test_deep_scrub_decode_coalesces():
    """A chunk's decodes are all submitted before any is awaited, so
    objects sharing a survivor signature verify in one wide recovery
    product (a dec batch wider than one on the backend's queue)."""
    net = _net()
    try:
        for i in range(6):
            _put(net, f"co_{i}", f"co_{i}".encode() * 300)
        pg = net.primary.pg
        dq = pg.backend.queue
        before = dict(dq.dec_batch_jobs)
        assert pg.scrub_engine().run(deep=True) == {}
        widths = {w: n - before.get(w, 0)
                  for w, n in dq.dec_batch_jobs.items()
                  if n - before.get(w, 0) > 0}
        assert widths, "deep scrub never used the decode queue"
        assert max(widths) > 1, f"decodes never coalesced: {widths}"
        assert sum(w * c for w, c in widths.items()) == 6
    finally:
        net.stop()


def test_mid_scrub_interrupt_resumes_from_cursor():
    """The cursor persists per chunk, so an interrupted deep scrub
    continues where it stopped and the resume completes and stamps."""
    net = _net(conf={"osd_scrub_chunk_max": 2})
    try:
        for i in range(6):
            _put(net, f"cur_{i}", f"cur_{i}".encode() * 200)
        host = net.primary
        pg = host.pg
        eng = pg.scrub_engine()
        names = sorted(pg.backend.object_names())
        # park the scrub at its SECOND chunk (first chunk verified,
        # cursor persisted), then abort the parked thread: the kill seam
        fp.arm("scrub.chunk", fp.barrier("scrub-park"),
               match={"first": names[2]})
        out = []

        def scrub_thread() -> None:
            try:
                out.append(eng.run(deep=True))
            except fp.FailpointAborted:
                pass  # the induced kill: cursor stays persisted

        th = threading.Thread(target=scrub_thread, daemon=True)
        th.start()
        assert fp.wait_hit("scrub-park", timeout=30.0)
        deep, cursor = eng._load_cursor()
        assert deep and cursor == names[1], (cursor, names)
        objs0 = host.scrub_perf.dump()["objects"]
        fp.abort("scrub-park")
        th.join(timeout=30.0)
        assert not th.is_alive() and not out
        fp.disarm_all()
        # the interrupted pass did NOT stamp (it never completed)
        assert pg.last_deep_scrub == 0
        assert eng.run(deep=True) == {}
        assert pg.last_deep_scrub > 0
        # the resume verified only the remainder of the walk
        verified = host.scrub_perf.dump()["objects"] - objs0
        assert verified == len(names) - 2, (verified, len(names))
        assert host.scrub_perf.dump()["resumes"] == 1
        assert eng._load_cursor() == (False, "")  # completion reset it
    finally:
        net.stop()


def test_shec_pool_verifies_through_the_codec_not_the_dec_queue():
    """shec has a recovery matrix but no MDS recovery: its scrub decodes
    through the codec (the port's routing rule), finds the rot and
    repairs it, and the queue's dec kind never runs."""
    net = _net(profile="plugin=shec k=4 m=3 c=2", n=7)
    try:
        for i in range(3):
            _put(net, f"sh_{i}", bytes([i + 7]) * 9000)
        pg = net.primary.pg
        assert not pg.backend.codec.mds_recovery
        dq = pg.backend.queue
        before = dict(dq.dec_batch_jobs)
        store = net.hosts[2].store
        g = GHObject("sh_1", shard=2)
        good = store.read(pg.coll, g)
        store.debug_data_err_enabled = True
        store.debug_inject_data_err(pg.coll, g)
        errs = pg.scrub_engine().run(deep=True, auto_repair=False)
        assert sorted(errs) == ["sh_1"], errs
        assert pg.scrub_engine().run(deep=True, auto_repair=True) == {}
        assert store.read(pg.coll, g) == good
        assert dict(dq.dec_batch_jobs) == before
    finally:
        net.stop()


@pytest.mark.parametrize("as_tensor", [False, True])
def test_resolve_state_takes_an_array_or_a_tensor(as_tensor):
    """``_resolve_state`` turns what the queue's future answers, a host
    array or a tensor, into the object; a failed future falls back to
    ``reconstruct``."""
    payload = bytes(range(256)) * 20
    net = _net()
    try:
        _put(net, "rs", payload)
        pg = net.primary.pg
        be = pg.backend
        avail, metas, lost = pg._ec_gather("rs")
        assert not lost and sorted(avail) == [0, 1, 2]
        sig = (1, 2)
        arrs = {i: np.frombuffer(avail[i], dtype=np.uint8) for i in sig}
        data = be.queue.decode_data_async(be.codec, arrs).result()
        fut = Future()
        fut.set_result(torch.from_numpy(np.ascontiguousarray(data))
                       if as_tensor else data)
        eng = pg.scrub_engine()
        st = eng._resolve_state("rs", avail, metas, sig, fut)
        assert st.data == payload
        bad = Future()
        bad.set_exception(RuntimeError("device lost"))
        assert eng._resolve_state("rs", avail, metas, sig, bad).data == \
            payload
    finally:
        net.stop()
