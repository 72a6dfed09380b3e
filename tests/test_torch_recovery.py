"""The windowed EC recovery engine (``osd/recovery.py``) of both packages,
each over a PG that wraps that package's own ``ECBackend`` and
``MemStore``: a duck-typed stub, and that package's real ``PG``.

Both PGs are built like ``_stub_pg`` of
``tests/test_recovery_pipeline.py`` (``:44-135``).  The stub (kind
``stub``) is a plain object that carries exactly what the engine reads;
the real one (kind ``pg``) is the package's ``osd.pg.PG`` with its
acting set, primary and ``STATE_DEGRADED`` set as the reference's
``_stub_pg`` sets them.  The cases are those of
``test_recovery_pipeline.py:181,218,266,317``, as their assertions go,
run over each package and each kind: one vec message per peer per
round, the legacy fallback, a peer killed mid-window, and ``park_read``
served and timed out.  The last case holds the two packages to each
other: the same seeded window sends the same messages (``to_bytes``
equal), stores the same shard bytes and attributes and accounts the
same recovery io.

Codecs of the port are built with ``device="cpu"`` here; the card's
twin (``tests/test_torch_cuda.py``) builds the same stub on the card.
"""

import importlib
import threading
import time
from types import SimpleNamespace

import pytest

EAGAIN = -11
PKGS = ("ceph_tpu", "ceph_tpu_torch")
KINDS = ("stub", "pg")


def _mods(pkg: str):
    names = ("core.context", "ec", "msg.message", "osd.messages",
             "osd.types", "osd.backend", "osd.pglog", "store.memstore",
             "store.objectstore")
    mods = {n.split(".")[-1]: importlib.import_module(f"{pkg}.{n}")
            for n in names}
    mods["pkg"] = pkg
    return mods


class _Perf:
    def __init__(self):
        self.vals = {}

    def inc(self, name, by=1):
        self.vals[name] = self.vals.get(name, 0) + by

    def set(self, name, v):
        self.vals[name] = v

    def value(self, name, default=0):
        return self.vals.get(name, default)


class _StubMap:
    def __init__(self, down=()):
        self.down = set(down)

    def is_up(self, o):
        return o not in self.down


class _StubOSD:
    """Duck-typed OSD host: records sends, lets the test answer them."""

    def __init__(self, mods, whoami, peers, conf=None):
        self.whoami = whoami
        self.ctx = mods["context"].Context(f"stub.osd{whoami}", conf or {})
        self.store = mods["memstore"].MemStore()
        self.store.mkfs()
        self.store.mount()
        self.addr_book = {p: ("stub", p) for p in peers}
        self.osdmap = _StubMap()
        self.sent = []
        self.responder = None  # fn(osd_id, msg) -> None
        self._read_cbs = {}
        self._tid = 0
        self._tid_lock = threading.Lock()
        self.perf = _Perf()
        self.pg_perf = _Perf()

    def epoch(self):
        return 7

    def _log(self, lvl, msg):
        pass

    def track_reads(self, pgid, cb, count=None):
        with self._tid_lock:
            self._tid += 1
            tid = self._tid
        self._read_cbs[tid] = cb
        return tid

    def untrack_reads(self, tid):
        self._read_cbs.pop(tid, None)

    def send_to_osd(self, osd_id, msg):
        self.sent.append((osd_id, msg))
        if self.responder is not None:
            self.responder(osd_id, msg)

    def reply(self, tid, rep):
        cb = self._read_cbs.get(tid)
        if cb is not None:
            cb(rep)

    def note_recovery_active(self, n):
        if n > self.pg_perf.vals.get("recovery_active", 0):
            self.pg_perf.set("recovery_active", n)


class _StubPG:
    """The attributes ``ChunkGather`` and ``ECRecoveryEngine`` read of a
    PG, over one package's backend (the PG's own wiring: the backend's
    perf and log go to the OSD's)."""

    def __init__(self, mods, profile, acting, whoami, osd, device="cpu"):
        self.mods = mods
        self.lock = threading.RLock()
        self.pgid = (3, 0)
        self.coll = mods["objectstore"].Collection(
            mods["types"].pgid_str(self.pgid) + "_head")
        self.acting = list(acting)
        self.prior_acting = []
        self.missing = {}
        self.unfound = set()
        self.stale_peers = set()
        self.log = mods["pglog"].PGLog()
        self.osd = osd
        kw = {"device": device} if mods["pkg"] == "ceph_tpu_torch" else {}
        codec = mods["ec"].codec_from_profile(profile, **kw)
        self.backend = mods["backend"].ECBackend(
            self.pgid, self.coll, osd.store, whoami, osd.send_to_osd,
            osd.epoch, codec)
        self.backend.perf = osd.pg_perf
        self.backend.log = osd._log
        self.recovery_io = []
        self.verify_fails = []
        self._recovery = None
        t = mods["objectstore"].Transaction()
        t.create_collection(self.coll)
        osd.store.queue_transaction(t)

    def recovery_engine(self):
        with self.lock:
            if self._recovery is None:
                rec = importlib.import_module(
                    f"{self.mods['pkg']}.osd.recovery")
                self._recovery = rec.ECRecoveryEngine(self)
            return self._recovery

    def note_peers_down(self, dead):
        eng = self._recovery
        if eng is not None:
            eng.peer_down(dead)

    def _obc_invalidate(self, oid=None):
        pass

    def _av_for(self, oid):
        with self.lock:
            en = self.log.latest_for(oid)
            return self.mods["backend"]._av_stamp(
                en.version if en is not None else self.log.head)

    def note_recovery_io(self, objects, nbytes):
        self.recovery_io.append((objects, nbytes))

    def _note_read_verify_fail(self, oid, where):
        self.verify_fails.append((oid, list(where)))


def _real_pg(mods, profile, acting, whoami, osd, device="cpu"):
    """The package's own ``PG`` over ``osd``, set as the reference's
    ``_stub_pg`` sets it (``test_recovery_pipeline.py:120-135``)."""
    pg_mod = importlib.import_module(f"{mods['pkg']}.osd.pg")
    kw = {"device": device} if mods["pkg"] == "ceph_tpu_torch" else {}
    codec = mods["ec"].codec_from_profile(profile, **kw)
    pool = SimpleNamespace(size=len(acting), hit_set_count=0)
    pg = pg_mod.PG((3, 0), pool, osd, codec)
    pg.mods = mods
    t = mods["objectstore"].Transaction()
    t.create_collection(pg.coll)
    osd.store.queue_transaction(t)
    with pg.lock:
        pg.acting = list(acting)
        pg.primary = whoami
        pg.state = pg_mod.STATE_DEGRADED
    return pg


def _stub_pg(pkg, profile, acting, whoami=0, peers=(1, 2), conf=None,
             device="cpu", kind="stub"):
    mods = _mods(pkg)
    osd = _StubOSD(mods, whoami, peers, conf=conf)
    if kind == "pg":
        return _real_pg(mods, profile, acting, whoami, osd, device), osd
    return _StubPG(mods, profile, acting, whoami, osd, device=device), osd


def _recovery_io(pg):
    """(objects, bytes) the window accounted to the PG."""
    if isinstance(pg, _StubPG):
        return (sum(o for o, _ in pg.recovery_io),
                sum(b for _, b in pg.recovery_io))
    st = pg.iostat_snapshot()
    return st["rec_ops"], st["rec_bytes"]


def _seed_missing(pg, oids, payload=b"r" * 4096):
    """Log entries + missing marks for `oids`; returns the per-oid chunk
    set a peer serves from (encoded with the pg's own backend)."""
    t_ = pg.mods["types"]
    chunks = {}
    base = pg.log.head.version
    for i, oid in enumerate(sorted(oids)):
        v = t_.EVersion(7, base + i + 1)
        data = oid.encode() + payload
        with pg.lock:
            pg.log.append(t_.LogEntry(op=t_.LOG_MODIFY, oid=oid, version=v,
                                      prior_version=t_.EVersion(0, 0)))
            pg.missing[oid] = v
        cs, _ = pg.backend._encode_object(data)
        chunks[oid] = (cs, v, data)
    return chunks


def _vec_responder(pg, chunks, answer_peers=None, src_epoch=7):
    """Auto-answer vec (and legacy) sub-reads with the right chunks."""
    m, be, osd = pg.mods["messages"], pg.mods["backend"], pg.osd
    EntityName = pg.mods["message"].EntityName

    def row(oid, shard):
        cs, v, data = chunks[oid]
        attrs = {"hinfo": be._hinfo(cs[shard], len(data)),
                 "_av": be._av_stamp(v)}
        return (shard, oid, cs[shard], 0, attrs, {})

    def respond(osd_id, msg):
        if answer_peers is not None and osd_id not in answer_peers:
            return
        if isinstance(msg, m.MECSubReadVec):
            rows = [row(oid, shard) for shard, oid, _o, _l in msg.reads]
            rep = m.MECSubReadVecReply((3, 0), src_epoch, rows)
        elif isinstance(msg, m.MECSubRead):
            r = row(msg.oid, msg.shard)
            rep = m.MECSubReadReply((3, 0), src_epoch, msg.shard, msg.oid,
                                    r[2], 0, r[4], r[5])
        else:
            return
        rep.tid = msg.tid
        rep.src = EntityName("osd", osd_id)
        osd.reply(msg.tid, rep)

    return respond


def _aggregation_window(pkg, device="cpu", kind="stub"):
    """``test_recovery_pipeline.py:181``'s window: k=4 m=2 over three
    OSDs, five objects missing on osd.0."""
    pg, osd = _stub_pg(pkg, "plugin=isa k=4 m=2 technique=reed_sol_van",
                       acting=[0, 1, 2, 0, 1, 2], peers=(1, 2),
                       device=device, kind=kind)
    oids = [f"agg{i}" for i in range(5)]
    chunks = _seed_missing(pg, oids)
    osd.responder = _vec_responder(pg, chunks)
    pg.recovery_engine().recover(
        {oid: pg.log.latest_for(oid) for oid in oids})
    return pg, osd, oids, chunks


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("pkg", PKGS)
def test_vec_subread_aggregation_one_msg_per_peer_per_round(pkg, kind):
    pg, osd, oids, chunks = _aggregation_window(pkg, kind=kind)
    m = pg.mods["messages"]
    GHObject = pg.mods["objectstore"].GHObject
    with pg.lock:
        assert not pg.missing, f"window left objects: {pg.missing}"
    vecs = [(o, v) for o, v in osd.sent if isinstance(v, m.MECSubReadVec)]
    assert len(vecs) == 4  # ceil(5/3) = 2 rounds x 2 peers
    assert all(len(v.reads) == 6 for _o, v in vecs[:2])
    assert osd.pg_perf.vals.get("subread_msgs") == 4
    assert osd.pg_perf.vals.get("subread_ops") == 5
    assert osd.pg_perf.vals.get("recovery_active", 0) >= 3
    # the decode rode the batch queue (shards 0 and 3 were missing)
    assert osd.pg_perf.vals.get("decode_batch_jobs", 0) >= 1
    assert osd.perf.vals.get("recovery_pushes") == 5
    for oid in oids:
        cs, v, data = chunks[oid]
        for shard in (0, 3):
            g = GHObject(oid, shard=shard)
            assert osd.store.read(pg.coll, g) == cs[shard]
            assert osd.store.getattr(pg.coll, g, "_av") == \
                pg.mods["backend"]._av_stamp(v)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("pkg", PKGS)
def test_mixed_version_peer_falls_back_to_legacy_subreads(pkg, kind):
    pg, osd = _stub_pg(pkg, "plugin=isa k=4 m=2 technique=reed_sol_van",
                       acting=[0, 1, 2, 0, 1, 2], peers=(1, 2),
                       conf={"osd_recovery_read_timeout": 0.5}, kind=kind)
    m = pg.mods["messages"]
    oids = ["mv0", "mv1"]
    chunks = _seed_missing(pg, oids)
    base = _vec_responder(pg, chunks)

    def legacy_peer1(osd_id, msg):
        if osd_id == 1 and isinstance(msg, m.MECSubReadVec):
            return  # peer 1 "cannot decode" the vec: silence
        base(osd_id, msg)

    osd.responder = legacy_peer1
    t0 = time.monotonic()
    pg.recovery_engine().recover(
        {oid: pg.log.latest_for(oid) for oid in oids})
    with pg.lock:
        assert not pg.missing, f"fallback never completed: {pg.missing}"
    assert time.monotonic() - t0 < 5.0
    legacy = [(o, v) for o, v in osd.sent
              if isinstance(v, m.MECSubRead) and o == 1]
    assert len(legacy) == 4  # 2 oids x peer 1's two shards
    assert 1 in pg.recovery_engine()._no_vec
    # second window: peer 1 goes straight to legacy, peer 2 keeps vec
    osd.sent.clear()
    more = ["mv2", "mv3"]
    chunks.update(_seed_missing(pg, more, payload=b"s" * 4096))
    pg.recovery_engine().recover(
        {oid: pg.log.latest_for(oid) for oid in more})
    with pg.lock:
        assert not pg.missing
    p1 = [v for o, v in osd.sent if o == 1]
    assert p1 and all(isinstance(v, m.MECSubRead) for v in p1)
    p2 = [v for o, v in osd.sent if o == 2]
    assert p2 and all(isinstance(v, m.MECSubReadVec) for v in p2)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("pkg", PKGS)
def test_kill_peer_mid_window_degrades_to_survivors(pkg, kind):
    pg, osd = _stub_pg(pkg, "plugin=isa k=2 m=2 technique=reed_sol_van",
                       acting=[0, 1, 2, 3], peers=(1, 2, 3),
                       conf={"osd_recovery_read_timeout": 5.0}, kind=kind)
    m = pg.mods["messages"]
    oids = [f"kp{i}" for i in range(4)]
    chunks = _seed_missing(pg, oids)
    held = []  # peer 1's vecs, answered only after the death below
    base = _vec_responder(pg, chunks)

    def respond(osd_id, msg):
        if osd_id == 3:
            return  # peer 3 dies before answering
        if osd_id == 1 and isinstance(msg, m.MECSubReadVec):
            held.append(msg)
            return
        base(osd_id, msg)

    osd.responder = respond
    done = []
    th = threading.Thread(
        target=lambda: (pg.recovery_engine().recover(
            {oid: pg.log.latest_for(oid) for oid in oids}),
            done.append(1)),
        daemon=True)
    t0 = time.monotonic()
    th.start()
    deadline = time.monotonic() + 5.0
    while not held and time.monotonic() < deadline:
        time.sleep(0.02)
    assert held, "peer 1 never got its vec"
    osd.osdmap = _StubMap(down={3})
    pg.note_peers_down({3})
    for msg in held:  # peer 1 answers late
        base(1, msg)
    held.clear()
    osd.responder = lambda o, v: (None if o == 3 else base(o, v))
    th.join(timeout=10.0)
    assert done, "window wedged after mid-window peer death"
    assert time.monotonic() - t0 < 4.5  # nothing waited out peer 3
    with pg.lock:
        assert not pg.missing, f"lost window slots: {pg.missing}"


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("pkg", PKGS)
def test_park_read_serves_after_recovery_and_times_out_honestly(pkg, kind):
    pg, osd = _stub_pg(pkg, "plugin=isa k=4 m=2 technique=reed_sol_van",
                       acting=[0, 1, 2, 0, 1, 2], peers=(1, 2),
                       conf={"osd_recovery_read_timeout": 0.4}, kind=kind)
    chunks = _seed_missing(pg, ["pk0"])
    osd.responder = _vec_responder(pg, chunks)
    got, ev = [], threading.Event()
    assert pg.recovery_engine().park_read(
        "pk0", lambda ok: (got.append(ok), ev.set()))
    assert ev.wait(10.0), "parked read never woken"
    assert got == [True]
    with pg.lock:
        assert "pk0" not in pg.missing
    # an object nobody can serve: the parked read answers False within
    # the bounded wait, not never
    _seed_missing(pg, ["pk1"], payload=b"t" * 4096)
    osd.responder = None
    got2, ev2 = [], threading.Event()
    assert pg.recovery_engine().park_read(
        "pk1", lambda ok: (got2.append(ok), ev2.set()))
    assert ev2.wait(10.0), "bounded wait never fired"
    assert got2 == [False]
    assert not pg.recovery_engine().park_read("pk0", lambda ok: None)


@pytest.mark.parametrize("kind", KINDS)
def test_both_packages_send_and_store_the_same_window(kind):
    """The aggregation window of both packages: the same sub-read
    messages, byte for byte, and the same recovered shard bytes, xattrs
    and PG meta omap on osd.0."""
    runs = {pkg: _aggregation_window(pkg, kind=kind) for pkg in PKGS}
    (rpg, rosd, oids, rchunks), (ppg, posd, _, pchunks) = (
        runs["ceph_tpu"], runs["ceph_tpu_torch"])
    for oid in oids:
        assert [bytes(c) for c in rchunks[oid][0]] == \
            [bytes(c) for c in pchunks[oid][0]]
    assert [(o, type(v).__name__, v.to_bytes()) for o, v in rosd.sent] == \
        [(o, type(v).__name__, v.to_bytes()) for o, v in posd.sent]
    rG, pG = rpg.mods["objectstore"].GHObject, ppg.mods["objectstore"].GHObject
    for oid in oids:
        for shard in (0, 3):
            assert rosd.store.read(rpg.coll, rG(oid, shard=shard)) == \
                posd.store.read(ppg.coll, pG(oid, shard=shard))
            assert rosd.store.getattrs(rpg.coll, rG(oid, shard=shard)) == \
                posd.store.getattrs(ppg.coll, pG(oid, shard=shard))
    assert _recovery_io(rpg) == _recovery_io(ppg) == (
        5, sum(len(rchunks[oid][2]) for oid in oids))
    if kind == "stub":
        assert rpg.recovery_io == ppg.recovery_io
    assert rpg.unfound == ppg.unfound == set()
