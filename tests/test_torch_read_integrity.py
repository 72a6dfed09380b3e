"""The port's per-extent at-rest seals (``ceph_tpu_torch/store/``),
case for case against the store cases of ``tests/test_read_integrity.py``
(seal on write, verify on read, each over ``memstore``, ``filestore``
and ``blockstore``; ``test_filestore_torn_tail_replay_reseals``), plus
the ``store.corrupt_chunk`` and ``store.corrupt_xattr`` failpoints at
the read boundary over the same three stores.

The cluster cases (``:292`` onward: the EC read-repair loop, the
replicated read's retry and heal, the late ``ECRC`` reply) run on the
port's cluster, ``torch_daemon_harness.DaemonCluster("ceph_tpu_torch")``
(six port daemons on MemStores with ``store_debug_inject_data_err`` on,
the reference's map, ``device="cpu"``), through
the port's client (``torch_daemon_harness.LibClient``).
"""

import time

import pytest

import torch_daemon_harness as H
from ceph_tpu_torch.osd import types as t_

from ceph_tpu_torch.core import failpoint as fp
from ceph_tpu_torch.core.crc import crc32c
from ceph_tpu_torch.store import create
from ceph_tpu_torch.store.filestore import FileStore
from ceph_tpu_torch.store.memstore import MemStore
from ceph_tpu_torch.store.objectstore import (
    ChecksumError,
    Collection,
    ExtentSeals,
    GHObject,
    Transaction,
)

CID = Collection("1.0_head")
OID = GHObject("obj1")
E = 16  # small extent size: multi-extent objects stay tiny


@pytest.fixture(params=["memstore", "filestore", "blockstore"])
def store(request, tmp_path):
    s = create(request.param, path=str(tmp_path / "store"))
    s.csum_extent_size = E
    s.mkfs()
    s.mount()
    yield s
    s.umount()


@pytest.fixture(autouse=True)
def _clean_failpoints():
    fp.disarm_all()
    yield
    fp.disarm_all()


def _mkcoll(store, cid=CID):
    t = Transaction()
    t.create_collection(cid)
    store.queue_transaction(t)


def _write(store, data, off=0, oid=OID):
    t = Transaction()
    t.write(CID, oid, off, data)
    store.queue_transaction(t)


def _seals(store, cid=CID, oid=OID):
    _data, _size, blob = store._read_span(cid, oid, 0, 0)
    return None if blob is None else ExtentSeals.from_bytes(blob)


def _extent_crcs(data, e=E):
    return [crc32c(bytes(data[i: i + e])) for i in range(0, len(data), e)]


def test_write_seals_every_extent(store):
    _mkcoll(store)
    data = b"A" * E + b"B" * E + b"C" * E + b"dd"  # 3 full + 2B tail
    _write(store, data)
    seals = _seals(store)
    assert seals is not None
    assert seals.extent_size == E
    assert seals.crcs == _extent_crcs(data)
    assert store.read(CID, OID) == data
    assert store.read(CID, OID, E + 3, 7) == data[E + 3: E + 10]


def test_partial_overwrite_reseals_only_touched_extents(store):
    _mkcoll(store)
    data = bytearray(b"0" * E + b"1" * E + b"2" * E + b"3" * E)
    _write(store, bytes(data))
    before = _seals(store).crcs
    # overwrite 8 bytes strictly inside extent 1
    patch = b"XYZWXYZW"
    _write(store, patch, off=E + 4)
    data[E + 4: E + 12] = patch
    after = _seals(store).crcs
    assert after == _extent_crcs(data)
    assert after[1] != before[1]
    assert [after[i] for i in (0, 2, 3)] == [before[i] for i in (0, 2, 3)]
    assert store.read(CID, OID) == bytes(data)


def test_append_truncate_zero_reseal(store):
    _mkcoll(store)
    data = bytearray(b"a" * (2 * E + 8))  # 2 full extents + 8B tail
    _write(store, bytes(data))
    # append through the tail extent into a new one
    tail = b"T" * E
    _write(store, tail, off=len(data))
    data += tail
    assert _seals(store).crcs == _extent_crcs(data)
    # truncate mid-extent
    t = Transaction()
    t.truncate(CID, OID, E + 5)
    store.queue_transaction(t)
    del data[E + 5:]
    assert _seals(store).crcs == _extent_crcs(data)
    # zero a range spanning the extent boundary
    t = Transaction()
    t.zero(CID, OID, E - 4, 6)
    store.queue_transaction(t)
    data[E - 4: E + 2] = b"\0" * 6
    assert _seals(store).crcs == _extent_crcs(data)
    assert store.read(CID, OID) == bytes(data)


def test_clone_and_rename_carry_consistent_seals(store):
    _mkcoll(store)
    cid2 = Collection("1.1_head")
    _mkcoll(store, cid2)
    data = b"clone-me" * (E // 2)  # multi-extent
    _write(store, data)
    dst = GHObject("obj1_clone")
    t = Transaction()
    t.clone(CID, OID, dst)
    store.queue_transaction(t)
    assert store.read(CID, dst) == data
    assert _seals(store, CID, dst).crcs == _extent_crcs(data)
    moved = GHObject("obj1_moved")
    t = Transaction()
    t.coll_move_rename(CID, dst, cid2, moved)
    store.queue_transaction(t)
    assert store.read(cid2, moved) == data
    assert _seals(store, cid2, moved).crcs == _extent_crcs(data)
    assert not store.exists(CID, dst)


def test_injected_rot_refused_at_read_time(store):
    """The corruption seam sits BEFORE the verify gate, so marked
    objects are refused — on whole AND ranged reads — instead of
    serving flipped bytes."""
    _mkcoll(store)
    data = b"rot-me--" * (E // 2)
    _write(store, data)
    store.debug_data_err_enabled = True
    store.debug_inject_data_err(CID, OID)
    fails0 = store.perf.value("read_verify_fail")
    with pytest.raises(ChecksumError):
        store.read(CID, OID)
    with pytest.raises(ChecksumError):
        store.read(CID, OID, 3, 5)  # ranged read routes the seam too
    assert store.perf.value("read_verify_fail") == fails0 + 2
    # verification off (the bench comparison knob): rot is SERVED
    store.verify_reads = False
    try:
        assert store.read(CID, OID) != data
    finally:
        store.verify_reads = True
    # a rewrite overwrites the bad media: mark drops, reads are clean
    _write(store, data)
    assert store.read(CID, OID) == data
    store.debug_data_err_enabled = False


def test_ranged_read_verifies_exactly_served_extents(store):
    """Physical rot in one extent: ranged reads of OTHER extents still
    serve (verify covers exactly what is read), any read covering the
    rotted extent refuses.  Backends with their own device layer
    (BlockStore) catch physical rot below the seal layer, so this
    physically flips bytes only where the test can reach the media."""
    _mkcoll(store)
    data = b"0" * E + b"1" * E + b"2" * E + b"3" * E
    _write(store, data)
    victim_off = 2 * E + 5  # inside extent 2
    if isinstance(store, MemStore):
        store._colls[CID][OID].data[victim_off] ^= 0x01
    elif isinstance(store, FileStore):
        path = store._datafile(CID, OID)
        with open(path, "r+b") as f:
            f.seek(victim_off)
            b = f.read(1)
            f.seek(victim_off)
            f.write(bytes([b[0] ^ 0x01]))
    else:
        pytest.skip("blockstore media rot is caught by its own "
                    "per-block device crc (covered elsewhere)")
    assert store.read(CID, OID, 0, 2 * E) == data[: 2 * E]  # clean extents
    assert store.read(CID, OID, 3 * E, E) == data[3 * E:]
    with pytest.raises(ChecksumError):
        store.read(CID, OID, 2 * E + 1, 4)  # covers the rotted extent
    with pytest.raises(ChecksumError):
        store.read(CID, OID)


def test_object_without_seals_reads_unverified(store):
    """Legacy tolerance: an object with NO seal record (pre-upgrade
    data, metadata-only objects) reads without verification rather
    than failing."""
    _mkcoll(store)
    data = b"legacy" * E
    _write(store, data)
    if isinstance(store, MemStore):
        store._colls[CID][OID].seals = None
    else:
        from ceph_tpu_torch.store.kv import WriteBatch

        if isinstance(store, FileStore):
            from ceph_tpu_torch.store.filestore import P_SEAL, _objkey
        else:
            from ceph_tpu_torch.store.blockstore import P_SEAL, _objkey
        b = WriteBatch()
        b.rmkey(P_SEAL, _objkey(CID, OID))
        store._kv.submit(b)
    assert _seals(store) is None
    assert store.read(CID, OID) == data


def test_extent_size_change_verifies_at_stored_granularity(store):
    """Conf-resized extents: objects sealed at the OLD granularity
    still verify (whole-object re-read at the stored extent size)
    until a rewrite re-seals them at the new one."""
    _mkcoll(store)
    data = b"grain" * E
    _write(store, data)
    store.csum_extent_size = 2 * E
    assert store.read(CID, OID, 3, 10) == data[3:13]  # old-granularity
    assert store.read(CID, OID) == data
    _write(store, data)  # full rewrite re-seals at the new size
    seals = _seals(store)
    assert seals.extent_size == 2 * E
    assert seals.crcs == _extent_crcs(data, 2 * E)



def test_filestore_torn_tail_replay_reseals(tmp_path):
    """Crash consistency: a torn apply (WAL ahead of applied_seq, file
    bytes half-written) replays on mount and converges BOTH the file
    content and its seals — the replayed reads verify clean."""
    s = create("filestore", path=str(tmp_path / "fs"))
    s.csum_extent_size = E
    s.mkfs()
    s.mount()
    _mkcoll(s)
    base = b"b" * (3 * E)
    _write(s, base)
    seq_before = s._seq
    patch = b"P" * 10
    _write(s, patch, off=E + 2)  # the txn that will be "torn"
    expected = base[: E + 2] + patch + base[E + 12:]
    assert s.read(CID, OID) == expected
    # rewind applied_seq to before the patch and tear the patched
    # bytes on the media, then kill WITHOUT umount (umount would trim
    # the WAL): exactly the state a crash between the data write and
    # the seal/seq batch leaves behind
    from ceph_tpu_torch.store.filestore import P_META
    from ceph_tpu_torch.store.kv import WriteBatch

    b = WriteBatch()
    b.set(P_META, "applied_seq", str(seq_before).encode())
    s._kv.submit(b, sync=True)
    path = s._datafile(CID, OID)
    with open(path, "r+b") as f:
        f.seek(E + 2)
        f.write(b"\xff" * 5)  # half-applied patch
    s._kv.close()
    s._wal_fh.close()

    s2 = create("filestore", path=str(tmp_path / "fs"))
    s2.csum_extent_size = E
    s2.mount()
    assert s2.read(CID, OID) == expected  # replayed AND verifying
    assert _seals(s2).crcs == _extent_crcs(expected)
    s2.umount()


def test_corrupt_chunk_failpoint_is_caught_by_the_seals(store):
    """store.corrupt_chunk scoped to one shard: that shard's reads fail
    their seal with ChecksumError (counted), the other shard's serve."""
    _mkcoll(store)
    data = bytes(range(256)) * 2
    rot, keep = GHObject("o", shard=6), GHObject("o", shard=2)
    for oid in (rot, keep):
        _write(store, data, oid=oid)
    fp.arm("store.corrupt_chunk", fp.CORRUPT_ACTION,
           match={"oid": "o", "shard": "6"})
    fails0 = store.perf.value("read_verify_fail")
    with pytest.raises(ChecksumError):
        store.read(CID, rot)
    assert store.read(CID, keep) == data
    assert store.perf.value("read_verify_fail") == fails0 + 1
    assert fp.fired("store.corrupt_chunk") == 1
    fp.disarm_all()
    assert store.read(CID, rot) == data  # nothing stored was touched


def test_corrupt_xattr_failpoint_flips_the_served_value(store):
    _mkcoll(store)
    t = Transaction()
    t.touch(CID, OID)
    t.setattrs(CID, OID, {"crc": b"\x01\x02\x03\x04"})
    store.queue_transaction(t)
    fp.arm("store.corrupt_xattr", fp.CORRUPT_ACTION, match={"attr": "crc"})
    assert store.getattr(CID, OID, "crc") != b"\x01\x02\x03\x04"
    assert store.getattrs(CID, OID) == {"crc": b"\x01\x02\x03\x04"}
    fp.disarm_all()
    assert store.getattr(CID, OID, "crc") == b"\x01\x02\x03\x04"


EC_POOL, REP_POOL = H.EC_POOL, H.REP_POOL


# -- end-to-end: EC read-repair --------------------------------------------


@pytest.fixture(scope="module")
def cluster():
    c = H.DaemonCluster("ceph_tpu_torch",
                        overrides={"store_debug_inject_data_err": True},
                        device="cpu")
    yield c
    c.shutdown()


@pytest.fixture(scope="module")
def client(cluster):
    cl = H.LibClient(cluster)
    yield cl
    cl.shutdown()


def _pg_of(cluster, pool, oid):
    pgid, acting, primary = cluster.primary_of(pool, oid)
    return pgid, acting, primary, cluster.osds[primary].pgs[pgid]


def _rot_primary_shard(cluster, pool, oid):
    """Partial-overwrite `oid` (invalidating its hinfo crc — the
    pre-seal blind spot), then rot the PRIMARY's own shard."""
    pgid, acting, primary, pg = _pg_of(cluster, pool, oid)
    shard = acting.index(primary)
    coll = Collection(t_.pgid_str(pgid) + "_head")
    cluster.osds[primary].store.debug_inject_data_err(
        coll, GHObject(oid, shard=shard) if pool == EC_POOL
        else GHObject(oid))
    pg._obc_invalidate(oid)  # the write cached its projected state
    return pgid, shard, primary, pg, coll


def test_ec_read_detects_reconstructs_counts_and_auto_repairs(
        cluster, client):
    """THE acceptance regression: a seeded flip on a partially-
    overwritten EC object (invalid hinfo crc — undetectable by the
    whole-chunk crc check) is caught at READ time by the extent-seal
    gate, the client gets correct bytes via reconstruction, the
    failure is counted and health-attributed, and auto-repair heals
    the shard for a clean re-read."""
    base = b"read-integrity-" * 400
    patch = b"OVERWRITTEN!" * 20
    expected = base[:1000] + patch + base[1000 + len(patch):]

    # -- phase 1: attribution with auto-repair OFF
    cluster.ctx.conf.set_val("osd_scrub_auto_repair", False)
    client.put(EC_POOL, "ri_attr", base)
    client.op(EC_POOL, "ri_attr",
              [t_.OSDOp(t_.OP_WRITE, off=1000, data=patch)])
    pgid, shard, primary, pg, coll = _rot_primary_shard(
        cluster, EC_POOL, "ri_attr")
    store = cluster.osds[primary].store
    fails0 = store.perf.value("read_verify_fail")
    errs0 = pg.scrub_errors
    # the local shard fails verification -> ECRC -> decode around it:
    # the client NEVER sees the flip, and never a bare EIO
    assert client.get(EC_POOL, "ri_attr") == expected
    assert store.perf.value("read_verify_fail") > fails0
    assert pg.scrub_errors == errs0 + 1  # the PG_DAMAGED feed
    assert "ri_attr" in pg._read_repair_pending  # counted exactly once
    stat = next(s for s in cluster.osds[primary].pg_stats()
                if s.pgid == pgid)
    assert stat.scrub_errors >= 1
    # a re-read neither re-bumps nor re-queues (dedup)
    pg._obc_invalidate("ri_attr")
    assert client.get(EC_POOL, "ri_attr") == expected
    assert pg.scrub_errors == errs0 + 1

    # -- phase 2: the full heal loop with auto-repair ON
    cluster.ctx.conf.set_val("osd_scrub_auto_repair", True)
    try:
        client.put(EC_POOL, "ri_heal", base)
        client.op(EC_POOL, "ri_heal",
                  [t_.OSDOp(t_.OP_WRITE, off=1000, data=patch)])
        pgid2, shard2, primary2, pg2, coll2 = _rot_primary_shard(
            cluster, EC_POOL, "ri_heal")
        store2 = cluster.osds[primary2].store
        assert client.get(EC_POOL, "ri_heal") == expected
        # the async targeted repair rewrites the shard (clearing the
        # injected-rot mark) and takes the error count back down
        deadline = time.time() + 20.0
        while time.time() < deadline:
            with pg2.lock:
                if ("ri_heal" not in pg2._read_repair_pending
                        and pg2.scrub_errors == 0):
                    break
            time.sleep(0.05)
        assert pg2.scrub_errors == 0, "read-repair never settled"
        # the repaired shard reads clean straight from the store
        g = GHObject("ri_heal", shard=shard2)
        chunk = store2.read(coll2, g)
        assert chunk  # no ChecksumError: mark cleared by the rewrite
        pg2._obc_invalidate("ri_heal")
        assert client.get(EC_POOL, "ri_heal") == expected
        assert pg2.scrub_engine().run(deep=True) == {}
    finally:
        cluster.ctx.conf.set_val("osd_scrub_auto_repair", False)
        for o in cluster.osds.values():
            o.store.debug_clear_data_err()


def test_replicated_read_verify_fail_retries_and_heals(cluster, client):
    """Replicated pools: the primary's own rotted copy answers
    retryable (EAGAIN -> transparent objecter resend), never flipped
    bytes or EIO; auto-repair pulls the authoritative copy from a
    healthy replica and the retried read completes correctly."""
    cluster.ctx.conf.set_val("osd_scrub_auto_repair", True)
    payload = b"replicated-integrity" * 300
    try:
        client.put(REP_POOL, "rri0", payload)
        pgid, shard, primary, pg, coll = _rot_primary_shard(
            cluster, REP_POOL, "rri0")
        # the get blocks on EAGAIN-retry until the async repair heals
        # the primary's copy, then serves the true bytes
        assert client.get(REP_POOL, "rri0") == payload
        deadline = time.time() + 20.0
        while time.time() < deadline:
            with pg.lock:
                if ("rri0" not in pg._read_repair_pending
                        and pg.scrub_errors == 0):
                    break
            time.sleep(0.05)
        assert pg.scrub_errors == 0, "read-repair never settled"
        store = cluster.osds[primary].store
        assert store.read(coll, GHObject("rri0")) == payload
    finally:
        cluster.ctx.conf.set_val("osd_scrub_auto_repair", False)
        for o in cluster.osds.values():
            o.store.debug_clear_data_err()


def test_late_ecrc_reply_is_counted_and_fed_to_repair(cluster, client):
    """A remote shard's checksum-failure (ECRC) reply that lands after
    its read gather resolved is late rot evidence: it is counted
    (read_verify_late) and still feeds the dedup'd scrub_errors /
    read-repair attribution path."""
    from ceph_tpu_torch.osd import messages as m_
    from ceph_tpu_torch.osd.backend import ECRC

    cluster.ctx.conf.set_val("osd_scrub_auto_repair", False)
    payload = b"late-ecrc" * 300
    client.put(EC_POOL, "ri_late", payload)
    pgid, acting, primary, pg = _pg_of(cluster, EC_POOL, "ri_late")
    osd = cluster.osds[primary]
    captured = {}
    orig = osd.track_reads

    def spy(pgid_, cb, n):
        captured["cb"] = cb
        return orig(pgid_, cb, n)

    osd.track_reads = spy
    try:
        pg._obc_invalidate("ri_late")
        assert client.get(EC_POOL, "ri_late") == payload
    finally:
        osd.track_reads = orig
    cb = captured.get("cb")
    assert cb is not None, "EC read never gathered remotely"
    perf = osd.pg_perf
    late0 = perf.value("read_verify_late")
    errs0 = pg.scrub_errors
    # a healthy straggler (result=0) stays dropped: no counter motion
    cb(m_.MECSubReadReply(pgid, 0, shard=1, oid="ri_late", result=0))
    assert perf.value("read_verify_late") == late0
    assert pg.scrub_errors == errs0
    # an ECRC straggler is late rot evidence: counted + attributed
    cb(m_.MECSubReadReply(pgid, 0, shard=1, oid="ri_late",
                          result=ECRC))
    assert perf.value("read_verify_late") == late0 + 1
    assert pg.scrub_errors == errs0 + 1
    assert "ri_late" in pg._read_repair_pending
    # a second late verdict re-counts the REPLY but not the error
    # (the per-object dedup _note_read_verify_fail already enforces)
    cb(m_.MECSubReadReply(pgid, 0, shard=2, oid="ri_late",
                          result=ECRC))
    assert perf.value("read_verify_late") == late0 + 2
    assert pg.scrub_errors == errs0 + 1
    # don't leak damage state into the rest of the module
    with pg.lock:
        pg._read_repair_pending.discard("ri_late")
        pg.scrub_errors = errs0
