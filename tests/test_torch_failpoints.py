"""The port's failpoint registry (``ceph_tpu_torch/core/failpoint.py``),
case for case against the registry unit cases of
``tests/test_failpoints.py`` (``:53-110``), plus its point table against
the reference's, and ``error(EIO)`` raising each package's own store
error.

The reference's committed 0xd403 schedules (``:245``, ``:359``: a
degraded EC commit, its ack gated on a durable witness, and the acked
state surviving a primary's death and a superseding write) run on the
port's cluster, ``torch_daemon_harness.DaemonCluster("ceph_tpu_torch")``
(six port daemons, the reference's map,
``device="cpu"``), through the port's client, with the port's
failpoints.  The FileStore cases (``:143``, ``:177``) run on the port's
FileStore and ``OSDService``.
"""

import threading
import time

import pytest

import ceph_tpu.core.failpoint as ref_fp
import ceph_tpu_torch.core.failpoint as fp
import torch_daemon_harness as H
from ceph_tpu_torch.osd import types as t_


@pytest.fixture(autouse=True)
def _clean_failpoints():
    fp.disarm_all()
    fp.seed(0)
    yield
    fp.disarm_all()
    fp.seed(0)


def test_registry_unknown_name_refused():
    with pytest.raises(KeyError):
        fp.arm("pg.totally.bogus", fp.sleep_ms(1))
    with pytest.raises(ValueError):
        fp.arm_from_spec("pg.commit.client_reply=explode")


def test_disarmed_is_noop_and_cheap():
    assert fp.failpoint("pg.commit.client_reply") is None
    assert not fp.enabled("pg.commit.client_reply")
    # the disarmed guard is one global load + None check; min of 5
    # batches against scheduler noise, the reference's 5 us bound
    n = 20000
    best = float("inf")
    for _ in range(5):
        t0 = time.perf_counter()
        for _ in range(n):
            fp.failpoint("pg.commit.client_reply")
        best = min(best, (time.perf_counter() - t0) / n)
    assert best < 5e-6, f"disarmed failpoint cost {best*1e9:.0f}ns"


def test_modifiers_once_count_prob_match():
    fp.arm("backend.commit.ack", fp.sleep_ms(0), count=2)
    for _ in range(5):
        fp.failpoint("backend.commit.ack")
    assert fp.fired("backend.commit.ack") == 2
    assert not fp.enabled("backend.commit.ack")  # self-disarmed

    fp.arm("pg.rollback.entry", fp.DROP_ACTION, match={"oid": "m2"})
    assert fp.failpoint("pg.rollback.entry", oid="m7") is None
    assert fp.failpoint("pg.rollback.entry", oid="m2") is fp.DROP
    fp.disarm("pg.rollback.entry")

    # seeded prob: same seed => identical firing pattern
    def pattern(seed):
        fp.disarm_all()
        fp.seed(seed)
        fp.arm("pglog.rewind", fp.DROP_ACTION, prob=0.5)
        return [fp.failpoint("pglog.rewind") is fp.DROP
                for _ in range(64)]

    a, b, c = pattern(0xD403), pattern(0xD403), pattern(0x1EC)
    assert a == b
    assert a != c  # different seed, different schedule


def test_error_and_dsl_roundtrip():
    fp.arm_from_spec("store.commit_batch.sync=error(RuntimeError):once")
    with pytest.raises(RuntimeError):
        fp.failpoint("store.commit_batch.sync")
    assert fp.failpoint("store.commit_batch.sync") is None  # once spent


def test_barrier_rendezvous_and_abort():
    fp.arm("queue.batch.dispatch", fp.barrier("hold-batch"))
    hit = []

    def worker():
        try:
            fp.failpoint("queue.batch.dispatch")
            hit.append("through")
        except fp.FailpointAborted:
            hit.append("aborted")

    th = threading.Thread(target=worker, daemon=True)
    th.start()
    assert fp.wait_hit("hold-batch", timeout=5.0)
    assert not hit  # parked, deterministically
    fp.release("hold-batch")
    th.join(5.0)
    assert hit == ["through"]

    fp.arm("queue.batch.dispatch", fp.barrier("hold-batch2"))
    th2 = threading.Thread(target=worker, daemon=True)
    th2.start()
    assert fp.wait_hit("hold-batch2", timeout=5.0)
    fp.abort("hold-batch2")
    th2.join(5.0)
    assert hit == ["through", "aborted"]


# -- against ceph_tpu -----------------------------------------------------------


def test_points_equal_the_reference():
    assert list(fp.POINTS) == list(ref_fp.POINTS)
    assert fp.POINTS == ref_fp.POINTS


@pytest.mark.parametrize("seed", [0, 0xD403, 12345])
def test_seeded_streams_equal_the_reference(seed):
    """The same seed fires the same hits in both packages, and
    corrupt_bytes flips the same bits."""
    pats = []
    for mod in (fp, ref_fp):
        mod.disarm_all()
        mod.seed(seed)
        mod.arm_from_spec("pglog.rewind=drop:prob(0.3),"
                          "scrub.chunk=drop:prob(0.7):count(9)")
        pats.append(([mod.failpoint("pglog.rewind") is mod.DROP
                      for _ in range(128)],
                     [mod.failpoint("scrub.chunk") is mod.DROP
                      for _ in range(64)],
                     mod.hits("scrub.chunk"), mod.fired("scrub.chunk"),
                     mod.corrupt_bytes(bytes(range(256)) * 7, "o1:s2")))
        mod.disarm_all()
        mod.seed(0)
    assert pats[0] == pats[1]


def test_eio_waits_for_the_store_slice():
    """error(EIO) arms in both packages, and firing it raises each
    package's own store StoreError (the port's since its store landed
    with slice 1c)."""
    from ceph_tpu.store.objectstore import StoreError
    from ceph_tpu_torch.store.objectstore import StoreError as PortStoreError

    ref_fp.disarm_all()
    try:
        ref_fp.arm_from_spec("store.filestore.read=error(EIO):once")
        with pytest.raises(StoreError):
            ref_fp.failpoint("store.filestore.read")
    finally:
        ref_fp.disarm_all()
    assert fp.arm_from_spec("store.filestore.read=error(EIO):once") == \
        ["store.filestore.read"]
    with pytest.raises(PortStoreError) as got:
        fp.failpoint("store.filestore.read")
    assert not isinstance(got.value, StoreError)
    assert fp.fired("store.filestore.read") == 1
    assert fp.failpoint("store.filestore.read") is None  # once: disarmed


# ---------------------------------------------------------------------------
# filestore_debug_inject_read_err wiring
# ---------------------------------------------------------------------------


def test_filestore_read_err_injection(tmp_path):
    from ceph_tpu_torch.store.filestore import FileStore
    from ceph_tpu_torch.store.objectstore import (Collection, GHObject,
                                            StoreError, Transaction)

    st = FileStore(str(tmp_path / "fs"))
    st.mkfs()
    st.mount()
    coll, g = Collection("1.0_head"), GHObject("victim")
    t = Transaction()
    t.create_collection(coll)
    t.write(coll, g, 0, b"payload")
    st.queue_transaction(t)
    try:
        # conf off: marking alone injects nothing
        st.debug_inject_read_err(coll, g)
        assert st.read(coll, g) == b"payload"
        # conf on (the previously-orphaned option, wired through the
        # daemon's _apply_fault_conf): marked object reads EIO
        st.debug_read_err_enabled = True
        with pytest.raises(StoreError):
            st.read(coll, g)
        st.debug_clear_read_err()
        assert st.read(coll, g) == b"payload"
        # the generic failpoint route needs no marking at all
        fp.arm_from_spec(
            "store.filestore.read=error(EIO):match(oid=victim)")
        with pytest.raises(StoreError):
            st.read(coll, g)
        fp.disarm("store.filestore.read")
    finally:
        st.umount()


def test_filestore_conf_plumbs_to_store():
    """OSDService.init applies filestore_debug_inject_read_err to its
    store and observes runtime toggles."""
    from ceph_tpu_torch.core.context import Context
    from ceph_tpu_torch.osd.daemon import OSDService

    ctx = Context("osd.fptest",
                  overrides={"filestore_debug_inject_read_err": True})
    svc = OSDService.__new__(OSDService)  # only the conf hook matters

    class _St:
        debug_read_err_enabled = False

    svc.ctx = ctx
    svc.store = _St()
    svc._log = lambda lvl, msg: None
    svc._apply_fault_conf()
    assert svc.store.debug_read_err_enabled is True
    ctx.conf.set_val("filestore_debug_inject_read_err", False)
    assert svc.store.debug_read_err_enabled is False


EC_POOL, N_OSDS = H.EC_POOL, H.N_OSDS
LibClient = H.LibClient


def MiniCluster():
    return H.DaemonCluster("ceph_tpu_torch", device="cpu")


# ---------------------------------------------------------------------------
# the committed 0xd403 schedule (tentpole regression)
# ---------------------------------------------------------------------------


def _ec_target(c):
    """An oid whose EC pg has three live distinct acting members, with
    the VICTIM chosen as the member that inherits the primaryship when
    the primary dies (so the doomed-write's non-holder later serves
    the superseding write — the 0xd403 geometry)."""
    for i in range(64):
        oid = f"fp{i}"
        pgid, acting, primary = c.primary_of(EC_POOL, oid)
        members = [int(o) for o in acting if 0 <= o < N_OSDS]
        if len(members) != 3 or len(set(members)) != 3:
            continue
        # probe (map-only, restored): who inherits when primary dies?
        c.osdmap.set_osd_down(primary)
        _pg2, _a2, next_primary = c.primary_of(EC_POOL, oid)
        c.osdmap.set_osd_up(primary)
        next_primary = int(next_primary)
        if next_primary == int(primary) or next_primary not in members:
            continue
        victim = next_primary
        witness = [o for o in members
                   if o not in (int(primary), victim)][0]
        return oid, pgid, int(primary), victim, witness
    raise AssertionError("no suitable EC pg geometry found")


def _setxattr_async(cl, oid, name, value, timeout, box):
    def run():
        try:
            rep = cl.op(EC_POOL, oid,
                        [t_.OSDOp(t_.OP_SETXATTR, name=name,
                                  data=value)],
                        timeout=timeout)
            box.append(rep.result == 0)
        except Exception:
            box.append(False)

    th = threading.Thread(target=run, daemon=True)
    th.start()
    return th


def test_0xd403_acked_xattr_survives_supersede_after_failover():
    """THE regression schedule (fails at pre-fix HEAD, passes with the
    fix).  The 0xd403 interleaving, barrier/drop-scheduled:

    1. setxattr x1 fans out; the sub-write to the VICTIM is dropped
       (kill-boundary loss) and the victim dies -> the op completes
       DEGRADED on k members and acks the client; every in-flight
       commit note dies too (the 2x-load window).
    2. The victim revives (stale: recovery pushes are held, as when
       the next kill beats the push), the primary dies, and the victim
       — the one member that never saw x1 — inherits the primaryship.
    3. The client writes the object FULL.  The new primary cannot
       reconstruct the current generation (1 of k current chunks
       reachable) so the WRITEFULL supersedes — and pre-fix it carried
       the freshest LOCAL shard's meta forward: the victim's stale,
       pre-x1 image.  The ACKED x1 is gone; the model sees
       `m2: xattr x1`, always right after the failover's
       `rolled back 1 divergent entries` housekeeping.

    Post-fix, both doors are closed: the degraded commit's ack is
    gated on a durable watermark witness (here the notes die, so the
    ack is honestly withheld), and a superseding WRITEFULL ranks
    REMOTE acting shards' meta testimony too, so the freshest stamp —
    the witness's x1-bearing image — is what carries forward."""
    c = MiniCluster()
    cl = LibClient(c)
    c.ctx.conf.set_val("osd_client_write_timeout", 1.0)
    c.ctx.conf.set_val("osd_recovery_push_timeout", 2.0)
    try:
        oid, pgid, primary, victim, witness = _ec_target(c)

        io = cl.rc.ioctx(EC_POOL)
        io.write_full(oid, b"base-payload" * 10)
        io.setxattr(oid, "x0", b"acked-before")  # acked, full width

        # recovery pushes held: the thrash race wins because the next
        # kill beats the push; here we pin that ordering
        fp.arm("msg.frame.deliver", fp.DROP_ACTION,
               match={"mtype": "MPGPush"})
        # the kill-boundary sub-write loss: victim never sees x1
        fp.arm("backend.subwrite.fanout", fp.DROP_ACTION,
               match={"peer": str(victim)})
        # every in-flight commit note dies with its window
        fp.arm("pg.commit_note.persist", fp.DROP_ACTION)

        box = []
        th = _setxattr_async(cl, oid, "x1", b"acked-lost?", 4.0, box)
        deadline = time.monotonic() + 5.0
        while (fp.fired("backend.subwrite.fanout") < 1
               and time.monotonic() < deadline):
            time.sleep(0.01)
        assert fp.fired("backend.subwrite.fanout") >= 1
        # the kill boundary: victim dies while the op waits on it ->
        # drop_missing completes the op DEGRADED on k members
        c.kill(victim)
        th.join(6.0)
        x1_acked = bool(box and box[0])

        # victim revives stale, then the primary dies: the non-holder
        # inherits the primaryship
        c.revive(victim)
        c.kill(primary)
        _pg2, _a2, new_primary = c.primary_of(EC_POOL, oid)
        assert int(new_primary) == victim
        fp.disarm("pg.commit_note.persist")  # the window is over

        # the superseding WRITEFULL through the stale new primary
        new_data = b"superseding-payload" * 8
        rep = io.operate(
            oid, [t_.OSDOp(t_.OP_WRITEFULL, data=new_data)],
            timeout=15.0)
        assert rep.result == 0

        # THE ORACLE, read while the old primary is still dead — the
        # superseding generation IS the object now.  Pre-fix x1_acked
        # is True and the supersede wiped x1 from the live shards.
        if x1_acked:
            got = io.operate(
                oid, [t_.OSDOp(t_.OP_GETXATTR, name="x1")],
                timeout=15.0)
            assert got.result == 0 and \
                got.ops[0].out_data == b"acked-lost?", (
                    "acked xattr lost to a superseding full-state "
                    "write: the 0xd403 acked-loss class")
        # state acked BEFORE the schedule must survive it regardless
        assert io.getxattr(oid, "x0") == b"acked-before"
        assert io.read(oid).rstrip(b"\0") == new_data

        fp.disarm_all()
        c.revive(primary)
        c.activate()
        # post-heal the rebuilt shard must match its peers: recovery
        # landing with MERGE semantics resurrected the stale
        # generation's attrs onto one shard (ghost x1 on the revived
        # primary while its peers lacked it), serving rewound state as
        # live depending on who answered the read
        metas = []
        for osd in (primary, victim, witness):
            pg = c.osds[osd].pgs.get(pgid)
            if pg is None:
                continue
            for s in range(3):
                attrs, _om = pg.backend.shard_meta(oid, s)
                if attrs:
                    metas.append({k: v for k, v in attrs.items()
                                  if k not in ("hinfo", "_av")})
        assert metas and all(mm == metas[0] for mm in metas), (
            f"shard user-attrs diverged after recovery: {metas}")
    finally:
        fp.disarm_all()
        cl.shutdown()
        c.shutdown()


def test_degraded_commit_acks_only_after_witness_persists():
    """The fix's liveness + mechanism: same degraded commit, notes NOT
    dropped — the client ack arrives (gated, bounded) and the acked
    state then survives the primary's death because the witness
    persisted the watermark before the ack fired."""
    c = MiniCluster()
    cl = LibClient(c)
    c.ctx.conf.set_val("osd_client_write_timeout", 2.0)
    c.ctx.conf.set_val("osd_recovery_push_timeout", 2.0)
    try:
        oid, pgid, primary, victim, witness = _ec_target(c)

        io = cl.rc.ioctx(EC_POOL)
        io.write_full(oid, b"payload-b" * 9)

        fp.arm("msg.frame.deliver", fp.DROP_ACTION,
               match={"mtype": "MPGPush"})
        fp.arm("backend.subwrite.fanout", fp.DROP_ACTION,
               match={"peer": str(victim)})

        box = []
        th = _setxattr_async(cl, oid, "x1", b"gated-ack", 10.0, box)
        deadline = time.monotonic() + 5.0
        while (fp.fired("backend.subwrite.fanout") < 1
               and time.monotonic() < deadline):
            time.sleep(0.01)
        c.kill(victim)
        th.join(8.0)
        assert box and box[0], (
            "degraded commit never acked: durable-ack gate wedged")

        # witness persisted the watermark before that ack — verify
        wpg = c.osds[witness].pgs[pgid]
        from ceph_tpu_torch.osd.types import EVersion
        assert wpg.info.committed_to > EVersion(), (
            "ack fired without a durable witness")

        c.revive(victim)
        c.kill(primary)
        c.activate()
        fp.disarm_all()
        c.revive(primary)
        c.activate()
        # the acked xattr survived the primary's death
        assert io.getxattr(oid, "x1") == b"gated-ack"
        assert io.read(oid).rstrip(b"\0") == b"payload-b" * 9
    finally:
        fp.disarm_all()
        cl.shutdown()
        c.shutdown()
