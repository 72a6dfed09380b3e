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
record yet) before the barrier is released.  Both packages must take
the same path: the same rollback events and ``roll_back_entry`` results,
the write unanswered, the object's old image served, nothing left in
``missing``, the same stores and logs, and the same stale row: the held
fan-out lands after the rewind and writes the rewound entry's log row
(and its rollback record) back into the primary's store, above the
in-memory log's head (ROADMAP queue 3, F4).
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
    # the held fan-out lands after the rewind: the rewound entry's log
    # row is back in the primary's store, above the in-memory head
    rewound = ref["events"][0][3][0][1]
    assert len(ref["log_rows"]) == 2 and ref["head"] != rewound
    for key in ("events", "rolled", "write", "read", "missing", "head",
                "log_rows", "stores", "logs"):
        assert port[key] == ref[key], key
