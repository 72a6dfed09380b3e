"""The port's ``ECBackend`` against ``ceph_tpu``'s, bit for bit, on the CPU.

Each package's primary (osd.0) and peers run over their own MemStores;
every sub-write is delivered by hand, in order, and acked.  The same
numpy-seeded sequence goes through both packages: a full write (staged
as a ``DeviceBuf``, so the port's ``encp`` batch computes the hinfo
CRCs), a second object, a full rewrite (full-replace rollback rows), a
partial-stripe write (extent rollback rows), a delete, a rollback of
the partial write, and degraded reconstructs.  Compared exactly: every
peer's ``MECSubWriteVec`` (transaction bytes and the whole message),
every stored shard's bytes, xattrs (``hinfo``, ``_av``) and omap, the
PG meta omap (log rows and rollback rows), and the reconstructed
object.

Five profiles: ``isa k=2 m=1`` (the cluster's ``EC_POOL``), ``isa k=8
m=4``, ``jerasure k=4 m=2 cauchy_good``, ``shec k=8 m=4 c=3`` and
``lrc k=4 m=2 l=3``.  Where the reference raises, the port is held to
the reference codec instead: a shec degraded read through the queue
(ROADMAP R2) is held to the reference's ``reconstruct`` (its codec's
``decode_array``), and an lrc pool, which the reference cannot write
(R4), is held to the reference lrc's layer encode, its ``_hinfo`` and
its ``decode``.  Every object spans a power-of-two number of stripes
and each write waits for the last, so the reference queue never codes
a bit-matrix batch at the widths where it goes wrong (R1).

The queue's ``inflight_batch()`` and its ``compile_wait`` blame are
pinned at the end.
"""

import importlib
import os
import threading
import time

import numpy as np
import pytest

PROFILES = {
    "isa_2_1": ("plugin=isa k=2 m=1 technique=reed_sol_van", 3),
    "isa_8_4": ("plugin=isa k=8 m=4 technique=reed_sol_van", 4),
    "jerasure_4_2": ("plugin=jerasure k=4 m=2 technique=cauchy_good", 3),
    "shec_8_4_3": ("plugin=shec k=8 m=4 c=3", 4),
    "lrc_4_2_3": ("plugin=lrc k=4 m=2 l=3", 4),
}
WAIT_S = 60.0


def _mods(pkg: str) -> dict:
    names = ("ec", "osd.backend", "osd.pglog", "osd.types",
             "store.memstore", "store.objectstore")
    mods = {n.split(".")[-1]: importlib.import_module(f"{pkg}.{n}")
            for n in names}
    mods["staging"] = importlib.import_module(
        f"{pkg}.{'gpu' if pkg == 'ceph_tpu_torch' else 'tpu'}.staging")
    mods["pkg"] = pkg
    return mods


class _Cluster:
    """One package's primary osd.0 and its peers, shard s on osd
    s % osds, every sub-write delivered by ``flush``."""

    def __init__(self, pkg: str, profile: str, osds: int,
                 device="cpu", store_dir=None) -> None:
        self.mods = md = _mods(pkg)
        kw = {"device": device} if pkg == "ceph_tpu_torch" else {}
        self.profile = profile
        self.codec = md["ec"].codec_from_profile(profile, **kw)
        self.n = self.codec.get_chunk_count()
        self.acting = [s % osds for s in range(self.n)]
        os_ = md["objectstore"]
        self.coll = os_.Collection("7.0_head")
        self.stores, self.backends = {}, {}
        for o in range(osds):
            st = (md["memstore"].MemStore() if store_dir is None else
                  importlib.import_module(f"{pkg}.store.blockstore")
                  .BlockStore(os.path.join(store_dir, f"osd{o}")))
            st.mkfs()
            st.mount()
            t = os_.Transaction()
            t.create_collection(self.coll)
            st.queue_transaction(t)
            self.stores[o] = st
            self.backends[o] = md["backend"].ECBackend(
                (7, 0), self.coll, st, o, self._send, lambda: 7, self.codec)
        self.pending = []
        self.sent = []  # per write: [(osd, txn bytes, message bytes)]

    @property
    def primary(self):
        return self.backends[0]

    def _send(self, osd, msg) -> None:
        self.pending.append((osd, msg))

    def entry(self, oid: str, v: int, op=None):
        t_ = self.mods["types"]
        return t_.LogEntry(op=t_.LOG_MODIFY if op is None else op, oid=oid,
                           version=t_.EVersion(7, v),
                           prior_version=t_.EVersion(7, v - 1),
                           reqid=f"client.4121:{v}")

    def _run(self, start) -> None:
        sub, done = threading.Event(), threading.Event()
        start(done.set, sub.set)
        assert sub.wait(WAIT_S), "fan-out never queued"
        self.sent.append([(osd, msg.txn, msg.to_bytes())
                          for osd, msg in self.pending])
        while self.pending:
            osd, msg = self.pending.pop(0)
            self.backends[osd].apply_sub_write_vec(msg)
            self.primary.handle_reply(msg.tid, osd)
        assert done.wait(WAIT_S), "write never committed"
        assert not self.primary.in_flight

    def write(self, oid: str, data: bytes, entry, devbuf: bool = False):
        be = self.primary
        payload = data
        if devbuf:
            payload = self.mods["staging"].DeviceBuf.stage(be.queue.pool,
                                                           data)
        state = self.mods["backend"].ObjectState(
            payload, {"user.tag": oid.encode()}, {"om": b"v%d" % len(data)})
        log = self.mods["pglog"].PGLog().omap_additions([entry])
        self._run(lambda done, sub: be.submit(
            oid, state, [entry], log, self.acting, done, on_submitted=sub))

    def partial(self, oid: str, s0: int, stripes: dict, size: int, entry):
        log = self.mods["pglog"].PGLog().omap_additions([entry])
        self._run(lambda done, sub: self.primary.submit_partial(
            oid, s0, stripes, size, [entry], log, self.acting, done,
            on_submitted=sub))

    def delete(self, oid: str, entry):
        log = self.mods["pglog"].PGLog().omap_additions([entry])
        self._run(lambda done, sub: self.primary.submit(
            oid, None, [entry], log, self.acting, done, on_submitted=sub))

    def dump(self) -> dict:
        """Every object of every store: data, xattrs, omap."""
        out = {}
        for o, st in self.stores.items():
            for g in st.collection_list(self.coll):
                out[(o, g.name, g.shard)] = (
                    bytes(st.read(self.coll, g)),
                    dict(st.getattrs(self.coll, g)),
                    dict(st.omap_get(self.coll, g)))
        return out

    def avail(self, oid: str, lost) -> dict:
        return {s: self.backends[self.acting[s]].read_local_chunk(oid, s)
                for s in range(self.n) if s not in lost}

    def meta(self, oid: str, shard: int):
        return self.backends[self.acting[shard]].shard_meta(oid, shard)


    def ranged(self, oid: str, off: int, length: int) -> dict:
        """Every shard's extent [off, off+length) through the sub-read
        path's ``read_local_chunk_extent2`` on its holder."""
        return {s: self.backends[self.acting[s]].read_local_chunk_extent2(
            oid, s, off, length) for s in range(self.n)}

    def umount(self) -> None:
        for st in self.stores.values():
            st.umount()


def _state(st):
    return None if st is None else (bytes(st.data), dict(st.xattrs),
                                    dict(st.omap))


def _script(c: _Cluster, rng) -> dict:
    """The write sequence; returns what the objects hold after it."""
    sw = c.primary.stripe_width
    a1 = rng.integers(0, 256, 4 * sw - 37, dtype=np.uint8).tobytes()
    b1 = rng.integers(0, 256, 2 * sw - 11, dtype=np.uint8).tobytes()
    a2 = rng.integers(0, 256, 4 * sw - 5, dtype=np.uint8).tobytes()
    patch = rng.integers(0, 256, sw + 300, dtype=np.uint8).tobytes()
    c.write("a", a1, c.entry("a", 1), devbuf=True)
    c.write("b", b1, c.entry("b", 2))
    c.write("a", a2, c.entry("a", 3))
    # stripes 1..2 of "a", patched at byte sw + 100 of the object
    a3 = bytearray(a2)
    a3[sw + 100: sw + 100 + len(patch)] = patch
    if _partial_ok(c):
        stripes = {s: bytearray(a3[s * sw:(s + 1) * sw]) for s in (1, 2)}
        c.partial("a", 1, stripes, len(a3), c.entry("a", 4))
    else:  # the PG's RMW path rewrites the whole object instead
        c.write("a", bytes(a3), c.entry("a", 4))
    c.delete("b", c.entry("b", 5, op=c.mods["types"].LOG_DELETE))
    return {"a1": a1, "a2": a2, "a3": bytes(a3), "b1": b1}


def _partial_ok(c: _Cluster) -> bool:
    """Whether an extent of the object can be re-encoded alone.  A
    bit-matrix code's chunk row is w packets of n/w bytes, so it cannot:
    the port's ``can_partial`` says so, the reference's does not (ROADMAP
    R5), and both take the full rewrite here."""
    return "jerasure" not in c.profile


def _lost(c: _Cluster) -> list:
    """Data shards at each end of the data, as many as m allows up to
    two: decodable by every profile here (shec's c = 3; one per lrc
    local group)."""
    ids = getattr(c.primary, "data_ids", list(range(c.primary.k)))
    return [ids[0], ids[-1]][:min(2, c.primary.m)]


def _reconstruct_async(c: _Cluster, oid: str, lost):
    got, ev = [], threading.Event()
    c.primary.reconstruct_async(oid, c.avail(oid, lost),
                                c.meta(oid, 1),
                                lambda st: (got.append(st), ev.set()))
    assert ev.wait(WAIT_S), "reconstruct never completed"
    return got[0]


def _rollback(c: _Cluster, v: int) -> None:
    entry = c.entry("a", v)
    for be in c.backends.values():
        be.roll_back_entry(entry)


@pytest.mark.parametrize("name", [n for n in PROFILES if n != "lrc_4_2_3"])
def test_backends_write_store_and_read_alike(name):
    profile, osds = PROFILES[name]
    ref = _Cluster("ceph_tpu", profile, osds)
    port = _Cluster("ceph_tpu_torch", profile, osds)
    want = _script(ref, np.random.default_rng(17))
    assert _script(port, np.random.default_rng(17)) == want
    assert port.primary.can_partial("a", 100, 200) == _partial_ok(port)
    assert ref.primary.can_partial("a", 100, 200)
    # the messages: one MECSubWriteVec per peer per write, same bytes
    assert [[o for o, _, _ in w] for w in port.sent] == \
        [[o for o, _, _ in w] for w in ref.sent]
    assert port.sent == ref.sent
    assert port.dump() == ref.dump()
    meta = [k for (o, name_, _s) in port.dump() if name_ == "_pgmeta_"
            for k in port.stores[o].omap_get(port.coll,
                                             port.mods["objectstore"]
                                             .GHObject("_pgmeta_"))]
    assert any(k.startswith("rb_") for k in meta)  # rollback rows landed
    # reconstruct, blocking and async, from survivors with two data
    # shards lost; shec's async read is held to the reference's codec
    lost = _lost(port)
    meta0 = ref.meta("a", 1)
    ref_st = ref.primary.reconstruct("a", ref.avail("a", lost), meta0)
    assert _state(ref_st)[0] == want["a3"]
    assert _state(port.primary.reconstruct(
        "a", port.avail("a", lost), port.meta("a", 1))) == _state(ref_st)
    assert _state(_reconstruct_async(port, "a", lost)) == _state(ref_st)
    if "shec" not in name:
        assert _state(_reconstruct_async(ref, "a", lost)) == _state(ref_st)
    # the partial write rolled back on every holder: same stores, and the
    # object reads as the rewrite again
    _rollback(ref, 4)
    _rollback(port, 4)
    assert port.dump() == ref.dump()
    assert _state(port.primary.reconstruct(
        "a", port.avail("a", lost), port.meta("a", 1)))[0] == want["a2"]


@pytest.mark.parametrize("name", ["isa_2_1", "isa_8_4"])
def test_backends_on_blockstores_write_store_and_read_alike(name,
                                                           tmp_path):
    """The same sequence with every OSD of each package on a BlockStore
    of its own package: the same messages and stores, and the ranged
    sub-reads served by the stores' own checksums at rest
    (``checksums_at_rest``: the extent read straight from the store)
    equal to the reference's, to the stored chunks' bytes, and refused
    as ECRC once the block under them rots."""
    profile, osds = PROFILES[name]
    ref = _Cluster("ceph_tpu", profile, osds, store_dir=str(tmp_path / "r"))
    port = _Cluster("ceph_tpu_torch", profile, osds,
                    store_dir=str(tmp_path / "p"))
    try:
        want = _script(ref, np.random.default_rng(17))
        assert _script(port, np.random.default_rng(17)) == want
        assert port.sent == ref.sent
        assert port.dump() == ref.dump()
        assert all(st.checksums_at_rest for st in port.stores.values())
        off, length = 100, port.primary.unit - 200
        got = port.ranged("a", off, length)
        assert got == ref.ranged("a", off, length)
        for s, (data, code) in got.items():
            chunk = port.backends[port.acting[s]].read_local_chunk("a", s)
            assert code == 0 and data == chunk[off: off + length]
        # rot under shard 1's first block: the extent read refuses it
        st = port.stores[port.acting[1]]
        G = port.mods["objectstore"].GHObject
        import chip_smoke

        chip_smoke.flip_at_rest(st, port.coll, G("a", shard=1))
        data, code = port.backends[port.acting[1]].read_local_chunk_extent2(
            "a", 1, off, length)
        assert data is None
        assert code == port.mods["backend"].ECRC
    finally:
        ref.umount()
        port.umount()


def test_lrc_pool_is_held_to_the_reference_codec():
    """The reference cannot write an lrc pool (R4): the port's shards,
    hinfo and _av are held to the reference lrc's layer encode of the
    same interleaved planes, its ``_hinfo`` and ``_av_stamp``; its
    sub-write transactions decode and re-encode byte-equal in the
    reference; its degraded read equals the reference lrc's ``decode``."""
    from ceph_tpu.ec import codec_from_profile as ref_codec
    from ceph_tpu.osd import backend as rb
    from ceph_tpu.osd.ecutil import StripeInfo as RefStripeInfo
    from ceph_tpu.store.objectstore import Transaction as RefTransaction

    profile, osds = PROFILES["lrc_4_2_3"]
    port = _Cluster("ceph_tpu_torch", profile, osds)
    want = _script(port, np.random.default_rng(23))
    ref = ref_codec(profile)
    k, n = ref.get_data_chunk_count(), ref.get_chunk_count()
    si = RefStripeInfo(k, port.primary.unit)
    data_ids = [ref.chunk_index(i) for i in range(k)]
    assert port.primary.data_ids == data_ids != list(range(k))

    def shards_of(obj: bytes) -> np.ndarray:
        planes, _ = si.interleave(obj)
        full = np.zeros((n, planes.shape[1]), dtype=np.uint8)
        full[data_ids] = planes
        ref._encode_layers(full)
        return full

    # after the partial write "a" holds a3: a column-local code stores
    # exactly the full encode of the patched object
    full = shards_of(want["a3"])
    for s in range(n):
        st, g = port.stores[port.acting[s]], port.mods[
            "objectstore"].GHObject("a", shard=s)
        assert bytes(st.read(port.coll, g)) == full[s].tobytes()
        # an extent write leaves the whole-chunk crc invalid
        assert rb.hinfo_decode(st.getattr(port.coll, g, "hinfo")) == (
            len(want["a3"]), 0, False)
        assert st.getattr(port.coll, g, "_av") == rb._av_stamp(
            port.entry("a", 4).version)
    for w in port.sent:
        for _osd, txn, _msg in w:
            assert RefTransaction.from_bytes(txn).to_bytes() == txn
    # roll the partial write back: a2's full write, crc-valid hinfo
    _rollback(port, 4)
    full = shards_of(want["a2"])
    for s in range(n):
        st, g = port.stores[port.acting[s]], port.mods[
            "objectstore"].GHObject("a", shard=s)
        assert bytes(st.read(port.coll, g)) == full[s].tobytes()
        assert st.getattr(port.coll, g, "hinfo") == rb._hinfo(
            full[s].tobytes(), len(want["a2"]))
    lost = _lost(port)
    chunks = {s: full[s] for s in range(n) if s not in lost}
    dec = ref.decode(data_ids, chunks)
    planes = np.stack([np.asarray(dec[i]) for i in data_ids])
    assert si.deinterleave(planes, len(want["a2"])) == want["a2"]
    for st in (port.primary.reconstruct("a", port.avail("a", lost),
                                        port.meta("a", 1)),
               _reconstruct_async(port, "a", lost)):
        assert _state(st)[0] == want["a2"]
        assert st.xattrs == {"user.tag": b"a"}


# -- the queue's in-flight batch and compile blame ---------------------------


def _parked_batch(pkg: str) -> dict:
    """A batch parked at ``queue.batch.dispatch``: what
    ``inflight_batch()`` says of it while it waits."""
    fp = importlib.import_module(f"{pkg}.core.failpoint")
    qmod = importlib.import_module(
        f"{pkg}.{'gpu' if pkg == 'ceph_tpu_torch' else 'tpu'}.queue")
    kw = {"device": "cpu"} if pkg == "ceph_tpu_torch" else {}
    codec = importlib.import_module(f"{pkg}.ec").codec_from_profile(
        "plugin=isa k=4 m=2 technique=reed_sol_van", **kw)
    q = qmod.StripeBatchQueue(**kw)
    token = f"xcheck-inflight-{pkg}"
    fp.arm("queue.batch.dispatch", fp.barrier(token), once=True)
    try:
        assert q.inflight_batch() is None
        fut = q.encode_crc_async(
            codec, np.arange(4 * 512, dtype=np.uint8).reshape(4, 512))
        assert fp.wait_hit(token, timeout=WAIT_S)
        time.sleep(0.01)
        info = q.inflight_batch()
        fp.release(token)
        fut.result(timeout=WAIT_S)
        assert q.inflight_batch() is None
    finally:
        fp.disarm("queue.batch.dispatch")
        q.stop()
    return info


def test_inflight_batch_matches_the_reference():
    ref, port = _parked_batch("ceph_tpu"), _parked_batch("ceph_tpu_torch")
    assert set(port) == set(ref) == {"kind", "jobs", "shapes", "age_s"}
    assert {k: port[k] for k in ("kind", "jobs", "shapes")} == \
        {k: ref[k] for k in ("kind", "jobs", "shapes")} == \
        {"kind": "encp", "jobs": 1, "shapes": [[4, 512]]}
    assert port["age_s"] >= 0.0


def test_device_state_reports_the_batch_on_the_worker():
    from ceph_tpu_torch.core import failpoint as fp
    from ceph_tpu_torch.ec import codec_from_profile
    from ceph_tpu_torch.gpu import devwatch
    from ceph_tpu_torch.gpu.queue import StripeBatchQueue

    codec = codec_from_profile("plugin=isa k=2 m=1", device="cpu")
    q = StripeBatchQueue(device="cpu")
    dw = devwatch.watch()
    dw.attach_queue(q)
    fp.arm("queue.batch.dispatch", fp.barrier("xcheck-state"), once=True)
    try:
        assert dw.device_state()["in_flight_batch"] is None
        fut = q.decode_data_async(codec, {0: np.zeros(256, np.uint8),
                                          2: np.ones(256, np.uint8)})
        assert fp.wait_hit("xcheck-state", timeout=WAIT_S)
        busy = dw.device_state()["in_flight_batch"]
        fp.release("xcheck-state")
        fut.result(timeout=WAIT_S)
    finally:
        fp.disarm("queue.batch.dispatch")
        dw.attach_queue(None)
        q.stop()
    assert busy["kind"] == "dec" and busy["shapes"] == [[2, 256]]


def test_compile_wait_blames_a_job_that_waited_on_the_build(monkeypatch):
    """A job whose [enqueue, compute-done] window overlaps the kernel
    build (here a fake window of ``ops/_build.py``'s stamps) gets the
    ``compile_wait`` annotation and one ``lat_compile_wait_us`` sample,
    as the reference blames a live XLA compile; a job after the build
    ended gets neither."""
    from ceph_tpu_torch.core.optracker import OpTracker, declare_op_hists
    from ceph_tpu_torch.core.perf import PerfCounters
    from ceph_tpu_torch.ec import codec_from_profile
    from ceph_tpu_torch.gpu.queue import StripeBatchQueue
    from ceph_tpu_torch.ops import _build

    perf = PerfCounters("osd.0.op")
    declare_op_hists(perf)
    tracker = OpTracker(perf=perf)
    codec = codec_from_profile("plugin=isa k=2 m=1", device="cpu")
    planes = np.zeros((2, 128), dtype=np.uint8)
    q = StripeBatchQueue(device="cpu")
    try:
        monkeypatch.setattr(_build, "build_t0", time.monotonic() - 5.0)
        monkeypatch.setattr(_build, "build_t1", None)  # live
        live = tracker.create_op("osd_op(write a)")
        q.encode_crc_async(codec, planes, trop=live).result(timeout=WAIT_S)
        monkeypatch.setattr(_build, "build_t1", time.monotonic())
        time.sleep(0.01)
        after = tracker.create_op("osd_op(write b)")
        q.encode_async(codec, planes, trop=after).result(timeout=WAIT_S)
    finally:
        q.stop()
    events = [e[1] for e in live.events]
    assert events.count("compile_wait") == 1
    assert "compile_wait" not in [e[1] for e in after.events]
    hist = perf.dump()["lat_compile_wait_us"]
    assert hist["count"] == 1 and hist["sum"] > 0
