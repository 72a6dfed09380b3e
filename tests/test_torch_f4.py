"""A divergent EC entry rolled back while its write's encode is still on
the stripe-batch queue, forced on both packages.

Under the OSD thrasher (``test_rados_model.py:409``) the port's rollbacks
that found no rollback record were of entries whose write had not fanned
out anywhere yet: ``rb_capture`` runs in the fan-out, after the encode,
and the peering that rewound the entry came first.  This case forces
that order on a six-daemon cluster of each package
(``torch_daemon_harness.DaemonCluster``): a barrier on the queue's
``queue.batch.dispatch`` failpoint holds a ``WRITEFULL``'s encode, one
member of the object's acting set is killed and revived, and the
primary's peering rewinds the held entry (``roll_back_entry`` False, no
record yet) before the barrier is released.  Both packages take the
same path up to there: the same rollback events, the write unanswered,
the object's old image served, nothing left in ``missing``, the same
in-memory logs.

They part in two places (ROADMAP queue 3: F4 on the port, R7 on the
reference).  The reference's ``roll_back_entry`` finds no record and
marks the object missing, to be re-replicated; the port's knows the
entry's write has stored nothing yet and answers True, so nothing is
marked (an object the rewound write would have created could never be
re-replicated, and stalled in ``missing``).  The reference then lets the
held fan-out land after the rewind: it writes the rewound entry's log
row and rollback record back into the primary's store, above the
in-memory log's head, where a later reload of that log resurrects the
entry.  The port's fan-out asks, under the lock the rewind holds,
whether its entry is still in the log, and drops the write when it is
not: its stores are the reference's without that row and record, and no
row stands above its head.
"""

import importlib
import threading
import time

import torch_daemon_harness as H

CLOCK = 1_700_000_000.0
OLD, NEW = b"a" * 5000, b"b" * 5000


def _forced_rollback(pkg: str, monkeypatch) -> dict:
    fp = importlib.import_module(pkg + ".core.failpoint")
    PGm = importlib.import_module(pkg + ".osd.pg")
    B = importlib.import_module(pkg + ".osd.backend")
    rolled = []
    orig = B.ECBackend.roll_back_entry

    def roll_back_entry(self, entry, meta_omap=None):
        ok = orig(self, entry, meta_omap)
        rolled.append((self.whoami, entry.oid, str(entry.version), ok))
        return ok

    monkeypatch.setattr(B.ECBackend, "roll_back_entry", roll_back_entry)
    c = H.DaemonCluster(pkg)
    M = c.M
    try:
        oid = "f4obj"
        c.put(H.EC_POOL, oid, OLD)
        c.quiesce()
        pgid, acting, primary = c.primary_of(H.EC_POOL, oid)
        pgid = tuple(int(x) for x in pgid)
        acting = [int(a) for a in acting]
        primary = int(primary)
        victim = next(o for o in acting if o != primary)
        n0 = len(PGm.ROLLBACK_EVENTS)
        fp.arm("queue.batch.dispatch", fp.barrier("f4"), once=True)
        res = {}

        def write() -> None:
            try:
                res["write"] = c.op(H.EC_POOL, oid, [M.t.OSDOp(
                    M.t.OP_WRITEFULL, data=NEW)], timeout=5.0).result
            except AssertionError:
                res["write"] = "no reply"

        wt = threading.Thread(target=write)
        wt.start()
        assert fp.wait_hit("f4", 10.0), "the write's encode never queued"

        def kill_revive() -> None:
            c.kill(victim)
            c.revive(victim)

        kt = threading.Thread(target=kill_revive)
        kt.start()
        deadline = time.monotonic() + 30.0
        while (not list(PGm.ROLLBACK_EVENTS)[n0:]
               and time.monotonic() < deadline):
            time.sleep(0.05)
        events = [(e["osd"], e["pg"], e["target"], list(e["entries"]))
                  for e in list(PGm.ROLLBACK_EVENTS)[n0:]]
        fp.release("f4")
        kt.join(60.0)
        wt.join(60.0)
        c.quiesce()
        pg = c.osds[primary].pgs[pgid]
        meta = pg.backend.store.omap_get(pg.backend.coll,
                                         M.os.GHObject("_pgmeta_"))
        return {
            "log_rows": sorted(k for k in meta if k[:1].isdigit()),
            "events": events, "rolled": rolled, "write": res.get("write"),
            "read": c.get(H.EC_POOL, oid),
            "missing": {k: str(v) for k, v in pg.missing.items()},
            "head": str(pg.log.head),
            "stores": c.dump_stores(), "logs": c.dump_logs(),
        }
    finally:
        fp.disarm_all()
        c.shutdown()


def test_rollback_of_an_entry_still_on_the_queue_matches_reference(
        monkeypatch):
    # log entries carry time.time(): one pinned clock for both packages
    monkeypatch.setattr(time, "time", lambda: CLOCK)
    ref = _forced_rollback("ceph_tpu", monkeypatch)
    port = _forced_rollback("ceph_tpu_torch", monkeypatch)
    # the forced order happened: the held entry was rewound with no
    # record, on the primary, before its fan-out
    assert ref["events"] and ref["events"][0][3] == [
        ("f4obj", ref["events"][0][3][0][1], 1)]
    assert ref["rolled"] and not any(ok for *_, ok in ref["rolled"])
    assert ref["write"] == "no reply"
    assert ref["read"] == OLD and ref["missing"] == {}
    for key in ("events", "write", "read", "missing", "head", "logs"):
        assert port[key] == ref[key], key
    # the port's rollback of the entry whose write stored nothing yet
    # has nothing to undo
    assert [r[:3] for r in port["rolled"]] == [r[:3] for r in ref["rolled"]]
    assert all(ok for *_, ok in port["rolled"])
    # R7, the reference: the held fan-out lands after the rewind, and
    # the rewound entry's log row is back in the primary's store, above
    # the in-memory head
    rewound = ref["events"][0][3][0][1]
    assert len(ref["log_rows"]) == 2 and ref["head"] != rewound
    stale = [k for k in ref["log_rows"] if k not in port["log_rows"]]
    assert len(stale) == 1
    # the port: the fan-out of the rewound entry stored nothing, so no
    # log row stands above the head and no rollback record is left
    assert port["log_rows"] == [k for k in ref["log_rows"]
                                if k not in stale]
    expect = {}
    for osd, colls in ref["stores"].items():
        expect[osd] = {c: [(key, data, attrs, {
            k: v for k, v in omap.items()
            if k not in stale and not k.startswith(f"rb_{stale[0]}.")})
            for key, data, attrs, omap in objs]
            for c, objs in colls.items()}
    assert expect != ref["stores"]
    assert port["stores"] == expect


def test_unfanned_entries_leave_with_their_write():
    """``ECBackend._unfanned`` holds an entry only from its write's
    submit to its fan-out: an entry whose write fanned out, or whose
    encode failed (a full-object write and a partial one, each with an
    error armed on the queue's dispatch), is not left behind, so the
    table does not grow under encode faults.  A full-object write of
    each object lands after the failure (a resent partial write does not:
    ROADMAP queue 3, F6)."""
    from ceph_tpu_torch.core import failpoint as fp

    c = H.DaemonCluster("ceph_tpu_torch")
    M = c.M
    try:
        c.put(H.EC_POOL, "u0", OLD)
        f0 = fp.fired("queue.batch.dispatch")
        fails = {}
        for oid, op in (("u1", M.t.OSDOp(M.t.OP_WRITEFULL, data=NEW)),
                        ("u0", M.t.OSDOp(M.t.OP_WRITE, off=100,
                                         data=NEW[:64]))):
            fp.arm("queue.batch.dispatch", fp.error(), once=True)
            try:
                fails[oid] = c.op(H.EC_POOL, oid, [op], timeout=5.0).result
            except AssertionError:
                fails[oid] = "no reply"
            assert c.put(H.EC_POOL, oid, NEW).result == 0
        assert fp.fired("queue.batch.dispatch") - f0 == 2
        assert 0 not in fails.values(), fails
        c.quiesce()
        assert c.get(H.EC_POOL, "u0") == c.get(H.EC_POOL, "u1") == NEW
        left = {(o.whoami, str(pgid)): dict(pg.backend._unfanned)
                for o in c.osds.values() for pgid, pg in o.pgs.items()
                if pg.backend._unfanned}
        assert left == {}
    finally:
        fp.disarm_all()
        c.shutdown()
