"""``tests/test_ec_rollback.py`` mirrored on the port's cluster: the EC
write path's rollback and the peering watchdog, through the port's
client.

Each case builds its own six-daemon port cluster
(``torch_daemon_harness.DaemonCluster("ceph_tpu_torch")``, the
reference's map, ``device="cpu"``) and drives it
through the port's ``RadosClient`` (``torch_daemon_harness.LibClient``):

- the peering watchdog re-kicks a wedged activation on a backed-off
  fuse, not a fixed tick, and reopens the gate once activation works;
- a degraded EC PG admits writes promptly;
- a primary that committed an RMW stripe no other shard saw rolls it
  back from its rollback records when it revives, with no ``EAGAIN``
  and no object marked missing.
"""

import time

import torch_daemon_harness as H
from ceph_tpu_torch.osd import messages as m
from ceph_tpu_torch.osd import types as t_
from ceph_tpu_torch.osd.pg import PG, STATE_PEERING

EC_POOL = H.EC_POOL
EAGAIN = -11


def MiniCluster():
    return H.DaemonCluster("ceph_tpu_torch", device="cpu")


LibClient = H.LibClient


def test_watchdog_backoff_not_fixed_tick():
    """Regression for the `8f8fff3` starvation loop: with a PG wedged
    in PEERING and every activation pass dying, the watchdog must
    re-kick on an exponentially backed-off fuse (1s, 2s, 4s, ...), not
    the old fixed 1s tick — and once activation can succeed again, the
    gate must open and admit client ops."""
    c = MiniCluster()
    cl = LibClient(c)
    try:
        io = cl.rc.ioctx(EC_POOL)
        oid = "wd0"
        assert io.operate(
            oid, [t_.OSDOp(t_.OP_WRITEFULL, data=b"x" * 4096)],
            timeout=15.0).result == 0
        pgid, acting, primary = c.primary_of(EC_POOL, oid)
        pg = c.osds[primary].pgs[pgid]

        kicks = []

        def dying_activate():
            kicks.append(time.monotonic())
            raise RuntimeError("activation loses the interval race")

        pg.activate = dying_activate  # instance shadow of PG.activate
        with pg.lock:
            pg.state = STATE_PEERING
            pg._peering_since = time.monotonic() - 10.0
            pg._wd_backoff = 0.0
            pg._wd_next = 0.0
        time.sleep(4.6)
        # fixed 1s tick would have re-kicked ~4 times; the exponential
        # fuse allows ~3 (at +0, +1, +2, [+4])
        assert 2 <= len(kicks) <= 4, (
            f"{len(kicks)} watchdog re-kicks in 4.6s at {kicks}: "
            "expected exponentially backed-off (~3), not a fixed tick")
        gaps = [b - a for a, b in zip(kicks, kicks[1:])]
        assert gaps and gaps[-1] > 1.5, (
            f"kick spacing never grew: {gaps}")

        # activation works again: the watchdog (or a direct kick) must
        # reopen the gate, and an admitted op completes
        del pg.activate
        pg.activate_async()
        c.osds[primary].wait_pgs_settled(15.0)
        assert pg.state != STATE_PEERING, "gate never reopened"
        rep = io.operate(oid, [t_.OSDOp(t_.OP_WRITEFULL,
                                        data=b"y" * 4096)], timeout=10.0)
        assert rep.result == 0, f"admitted op starved: rc={rep.result}"
    finally:
        cl.shutdown()
        c.shutdown()


def test_degraded_pg_admits_ops_promptly():
    """'Active accepts ops while recovery proceeds' (reference
    PG.h:1955): killing one EC member must not park client writes
    behind the peering gate while dead-peer RPC windows burn out —
    every write completes promptly against the degraded PG."""
    c = MiniCluster()
    cl = LibClient(c)
    down = None
    try:
        io = cl.rc.ioctx(EC_POOL)
        oids = [f"dg{i}" for i in range(8)]
        for i, oid in enumerate(oids):
            assert io.operate(
                oid, [t_.OSDOp(t_.OP_WRITEFULL,
                               data=f"{oid}-".encode() * 200)],
                timeout=15.0).result == 0
        down = 0
        c.kill(down)
        t0 = time.monotonic()
        for oid in oids:
            rep = io.operate(
                oid, [t_.OSDOp(t_.OP_WRITEFULL,
                               data=f"{oid}+".encode() * 200)],
                timeout=10.0)
            assert rep.result == 0, (
                f"write {oid} starved behind the peering gate: "
                f"rc={rep.result}")
        elapsed = time.monotonic() - t0
        assert elapsed < 16.0, (
            f"8 degraded writes took {elapsed:.1f}s — ops are "
            "serializing behind per-peer RPC windows")
        for oid in oids:
            rep = io.operate(oid, [t_.OSDOp(t_.OP_READ)], timeout=10.0)
            assert rep.result == 0
            assert rep.ops[0].out_data == f"{oid}+".encode() * 200
    finally:
        cl.shutdown()
        c.shutdown()


def test_kill_primary_mid_rmw_rolls_back():
    """Kill the primary after it committed an RMW stripe locally but
    before any other shard saw it.  On revival the leftover entry is
    divergent (committed by 1 < k members, above the roll-forward
    watermark): the revived shard must roll it BACK from its persisted
    rollback records — and convergence must produce ZERO client
    EAGAINs and no missing-object fallback for the oid (the old path:
    mark missing, EAGAIN until re-replication)."""
    c = MiniCluster()
    cl = LibClient(c)
    rollbacks = []
    orig_rb = PG._rollback_to

    def spy_rb(self, target):
        rollbacks.append((self.osd.whoami, self.pgid, str(target)))
        return orig_rb(self, target)

    try:
        io = cl.rc.ioctx(EC_POOL)
        oid = "rbk0"
        data = bytes(range(256)) * 256  # 64 KiB, deterministic
        assert io.operate(oid, [t_.OSDOp(t_.OP_WRITEFULL, data=data)],
                          timeout=15.0).result == 0
        pgid, acting, primary = c.primary_of(EC_POOL, oid)
        posd = c.osds[primary]
        pbackend = posd.pgs[pgid].backend

        # the mid-RMW crash: every outbound sub-write for this PG is
        # lost, so the stripe commits ONLY on the primary's own shard
        # (the backend captured osd.send_to_osd at construction, so the
        # hook must go on the backend itself)
        orig_send = pbackend.osd_send

        def drop_subwrites(osd_id, msg):
            if isinstance(msg, (m.MECSubWrite, m.MECSubWriteVec)):
                return
            orig_send(osd_id, msg)

        pbackend.osd_send = drop_subwrites
        patch, off = b"\xee" * 700, 1000
        # op timeout 2s < result wait: the objecter ticker synthesizes
        # an ETIMEDOUT reply and DEREGISTERS the op — no later resend
        # may re-apply the patch after convergence
        rep = io.aio_operate(oid, [t_.OSDOp(t_.OP_WRITE, off=off,
                                            data=patch)],
                             timeout=2.0).result(8.0)
        assert rep.result != 0, "write acked without shard quorum"
        pbackend.osd_send = orig_send

        PG._rollback_to = spy_rb
        eagains = []
        orig_dispatch = cl.rc.objecter.ms_dispatch

        def spy_dispatch(conn, msg):
            if isinstance(msg, m.MOSDOpReply) and msg.result == EAGAIN:
                eagains.append(msg.oid)
            return orig_dispatch(conn, msg)

        cl.rc.objecter.ms_dispatch = spy_dispatch

        c.kill(primary)    # survivors converge on the pre-RMW head
        c.revive(primary)  # divergent holder rejoins and must rewind

        assert rollbacks, (
            "divergent entry was never rolled back — convergence fell "
            "back to the re-replication path")
        assert any(pg_ == pgid for _, pg_, _t in rollbacks), rollbacks

        rep = io.operate(oid, [t_.OSDOp(t_.OP_READ)], timeout=15.0)
        assert rep.result == 0, f"first read after convergence: rc=" \
                                f"{rep.result}"
        assert rep.ops[0].out_data == data, (
            "rolled-back object does not match the pre-RMW image")
        assert not eagains, (
            f"{len(eagains)} EAGAIN replies during convergence "
            f"({eagains[:5]}): rollback should leave nothing to retry")
        # the revived holder must not have fallen back to mark-missing
        for osd in c.osds.values():
            pg = osd.pgs.get(pgid)
            if pg is not None:
                assert oid not in pg.missing, (
                    f"osd.{osd.whoami} marked {oid} missing — "
                    "re-replication fallback instead of rollback")
    finally:
        PG._rollback_to = orig_rb
        cl.shutdown()
        c.shutdown()
