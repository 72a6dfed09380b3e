"""A cluster of OSD daemons in one process, for either package.

``DaemonCluster(pkg)`` is ``tests/test_osd_cluster.py``'s ``MiniCluster``
(``:60-110``) over ``pkg``'s ``OSDService``: six daemons, each over its
own MemStore, on one shared map (``:35-56``: a replicated pool of size 3,
isa k=2 m=1, isa k=2 m=2 and clay k=4 m=2 over all six daemons, eight PGs
each).  The port's daemons take ``device``.  The client is
a raw messenger, ``client.4100``: ``op`` sends one ``MOSDOp`` to the
object's acting primary and waits for its reply, and resends it (same
tid and reqid) to the primary of the map of the moment while the answer
is retryable (``EAGAIN``, ``ESTALE``), as the objecter does.

``LibClient(cluster)`` is ``test_osd_cluster.py``'s ``LibClient``
(``:123-155``) over the cluster's package: that package's
``RadosClient`` (the port's on the cluster's device), ``inject_osdmap``ed
and notified on every ``refresh`` through ``cluster.watchers``, as the
reference's ``MiniCluster`` notifies its clients.  With ``pinned`` its
objecter names its reqids ``client.<name>.0:<tid>`` instead of after the
messenger's random nonce, and its objecter resends on a map change and
on ``EAGAIN``/``ESTALE`` but not on its timer, so that two packages'
runs log the same reqids and count the same ops.

``kill`` and ``revive`` are ``MiniCluster``'s: shut the daemon down and
mark it down in the shared map, then a new ``OSDService`` on the old
store, marked up; each refreshes every daemon with the map and the
address book and waits for their PGs to settle.  A revival hands every
daemon the new address before the map that marks it up (its boot
message comes first), so no peer answers it at the dead address.
"""

from __future__ import annotations

import importlib
import threading
import time
from types import SimpleNamespace
from typing import Dict, List, Optional

N_OSDS = 6
REP_POOL = 1
EC_POOL = 2
EC22_POOL = 3
CLAY_POOL = 4
EC_PROFILE = "plugin=isa k=2 m=1 technique=reed_sol_van"
EC22_PROFILE = "plugin=isa k=2 m=2 technique=reed_sol_van"
CLAY_PROFILE = "plugin=clay k=4 m=2"
CLIENT = 4100
WAIT_S = 30.0
RETRYABLE = (-11, -116)  # EAGAIN, ESTALE


def mods(pkg: str) -> SimpleNamespace:
    names = {"context": "core.context", "cmap": "crush.map", "ec": "ec",
             "message": "msg.message", "messenger": "msg.messenger",
             "m": "osd.messages", "t": "osd.types", "daemon": "osd.daemon",
             "osdmap": "osd.osdmap", "memstore": "store.memstore",
             "os": "store.objectstore", "enc": "core.encoding"}
    return SimpleNamespace(pkg=pkg, **{k: importlib.import_module(
        f"{pkg}.{v}") for k, v in names.items()})


def build_map(M, dev: dict, n_osds: int = N_OSDS):
    """``test_osd_cluster.build_map``."""
    P = M.osdmap
    cm, root = M.cmap.build_flat_cluster(n_osds, hosts=n_osds)
    cm.add_simple_rule("replicated", root, 1, mode="firstn")
    cm.add_simple_rule("ec", root, 1, mode="indep")
    osdmap = P.OSDMap(cm, max_osd=n_osds, **dev)
    osdmap.add_pool(P.PGPool(REP_POOL, P.POOL_REPLICATED, size=3,
                             min_size=2, pg_num=8, pgp_num=8, crush_rule=0))
    osdmap.add_pool(P.PGPool(EC_POOL, P.POOL_ERASURE, size=3, min_size=2,
                             pg_num=8, pgp_num=8, crush_rule=1,
                             erasure_code_profile=EC_PROFILE))
    osdmap.add_pool(P.PGPool(EC22_POOL, P.POOL_ERASURE, size=4,
                             min_size=3, pg_num=8, pgp_num=8, crush_rule=1,
                             erasure_code_profile=EC22_PROFILE))
    osdmap.add_pool(P.PGPool(CLAY_POOL, P.POOL_ERASURE, size=6,
                             min_size=5, pg_num=8, pgp_num=8, crush_rule=1,
                             erasure_code_profile=CLAY_PROFILE))
    return osdmap


class DaemonCluster:
    """``n_osds`` daemons of ``pkg`` over MemStores and one shared map.

    ``store_factory(i)`` gives osd.i another store, as the reference's
    ``MiniCluster(store_factory=...)`` does (``test_osd_cluster.py:61``);
    ``revive(i, remount=True)`` then mounts a new one on osd.i's path."""

    def __init__(self, pkg: str, overrides: Optional[dict] = None,
                 device: str = "cpu", n_osds: int = N_OSDS,
                 map_fn=build_map, store_factory=None) -> None:
        self.M = M = mods(pkg)
        self.pkg = pkg
        self.dev = {"device": device} if pkg == "ceph_tpu_torch" else {}
        self.ctx = M.context.Context("osd.cluster", overrides)
        self.osdmap = map_fn(M, self.dev, n_osds)
        self.osds: Dict[int, object] = {}
        self.watchers: List = []  # clients notified on every map refresh
        self._tid = 0
        self._replies: Dict[int, object] = {}
        self._cond = threading.Condition()
        self.make_store = store_factory or (lambda i: M.memstore.MemStore())
        try:
            for i in range(n_osds):
                svc = self._service(i, self.make_store(i))
                svc.store.mkfs()
                svc.init()
                self.osds[i] = svc
            self._start_client()
            self.refresh()
            self.activate()
        except BaseException:
            self.shutdown()
            raise

    def _service(self, i: int, store):
        return self.M.daemon.OSDService(self.ctx, i, store, self.osdmap,
                                        self.M.ec.codec_from_profile,
                                        **self.dev)

    def _start_client(self) -> None:
        M, cluster = self.M, self

        class ClientD(M.messenger.Dispatcher):
            def ms_can_fast_dispatch(self, msg) -> bool:
                return True

            def ms_dispatch(self, conn, msg) -> bool:
                if not isinstance(msg, M.m.MOSDOpReply):
                    return False
                with cluster._cond:
                    cluster._replies[msg.tid] = msg
                    cluster._cond.notify_all()
                return True

        self.client = M.messenger.Messenger(
            M.context.Context(f"client.{CLIENT}"),
            M.message.EntityName("client", CLIENT))
        self.client.add_dispatcher(ClientD())
        self.client.start()

    # -- MiniCluster ---------------------------------------------------------
    def book(self) -> dict:
        return {i: o.addr for i, o in self.osds.items() if o.up}

    def refresh(self) -> None:
        book = self.book()
        for o in self.osds.values():
            if o.up:
                o.handle_osdmap(self.osdmap, book)
        for w in list(self.watchers):
            w(book)

    def activate(self) -> None:
        for o in self.osds.values():
            if o.up:
                o.activate_pgs()
        for o in self.osds.values():
            if o.up:
                o.wait_pgs_settled(15.0)

    def kill(self, osd_id: int) -> None:
        self.osds[osd_id].shutdown()
        self.osdmap.set_osd_down(osd_id)
        self.refresh()
        self.activate()

    def revive(self, osd_id: int, remount: bool = False) -> None:
        """Restart osd_id on its old store object, or with ``remount`` on
        a new one from the store factory (a durable store's state is
        then read back from its files)."""
        store = (self.make_store(osd_id) if remount
                 else self.osds[osd_id].store)
        svc = self._service(osd_id, store)
        svc.init()
        self.osds[osd_id] = svc
        # the new address first, then the map that marks it up: a peer
        # still holding the old address would answer the revived
        # daemon's pull into the dead messenger
        self.refresh()
        self.osdmap.set_osd_up(osd_id)
        self.refresh()
        self.activate()

    def shutdown(self) -> None:
        for o in self.osds.values():
            if o.up:
                o.shutdown()
        client = getattr(self, "client", None)
        if client is not None:
            client.shutdown()
        self.ctx.shutdown()

    def primary_of(self, pool: int, oid: str):
        pgid = self.osdmap.object_to_pg(pool, oid)
        up, up_p, acting, acting_p = self.osdmap.pg_to_up_acting(pgid)
        return pgid, acting, acting_p

    # -- the client ----------------------------------------------------------
    def op(self, pool: int, oid: str, ops: List, timeout: float = WAIT_S):
        """One ``MOSDOp`` to the acting primary; resent while the answer
        is retryable.  Returns the final ``MOSDOpReply``."""
        with self._cond:
            self._tid += 1
            tid = self._tid
        deadline = time.monotonic() + timeout
        while True:
            pgid, _acting, primary = self.primary_of(pool, oid)
            msg = self.M.m.MOSDOp(pgid, self.osdmap.epoch, oid, list(ops))
            msg.tid = tid
            msg.reqid = f"client.{CLIENT}.0:{tid}"
            self.client.send_message(msg, self.osds[primary].addr)
            with self._cond:
                self._cond.wait_for(lambda: tid in self._replies,
                                    max(0.0, deadline - time.monotonic()))
                rep = self._replies.pop(tid, None)
            assert rep is not None, f"no reply to {oid} (tid {tid})"
            if rep.result not in RETRYABLE:
                return rep
            assert time.monotonic() < deadline, \
                f"{oid} still answered {rep.result}"
            time.sleep(0.05)

    def put(self, pool: int, oid: str, data: bytes):
        return self.op(pool, oid, [self.M.t.OSDOp(self.M.t.OP_WRITEFULL,
                                                  data=data)])

    def get(self, pool: int, oid: str) -> bytes:
        rep = self.op(pool, oid, [self.M.t.OSDOp(self.M.t.OP_READ)])
        assert rep.result == 0, f"read of {oid} answered {rep.result}"
        return bytes(rep.ops[0].out_data)

    def quiesce(self, timeout: float = WAIT_S) -> None:
        """Flush every PG's absorbed commit watermark now (what each
        daemon's watchdog does within a second) and wait until every
        holder of every PG holds the primary's, so a snapshot does not
        race the watchdog's tick."""
        up = [o for o in self.osds.values() if o.up]
        for o in up:
            for pg in list(o.pgs.values()):
                pg.flush_commit_note()
        deadline = time.monotonic() + timeout

        def behind() -> list:
            out = []
            for o in up:
                for pgid, pg in list(o.pgs.items()):
                    if not pg.is_primary() or not pg.is_ec():
                        continue
                    want = pg.info.committed_to
                    for osd in pg.acting:
                        peer = self.osds.get(osd)
                        if peer is None or not peer.up or peer is o:
                            continue
                        ppg = peer.pgs.get(pgid)
                        if ppg is not None and ppg.info.committed_to < want:
                            out.append((pgid, osd))
            return out

        while behind():
            assert time.monotonic() < deadline, behind()
            time.sleep(0.01)
        time.sleep(0.1)  # the note's persist follows its in-memory merge

    # -- what the cross-check compares ---------------------------------------
    def dump_stores(self) -> dict:
        """Every up daemon's store: {osd: {collection: [(object key,
        bytes, xattrs, omap)]}}."""
        out = {}
        for i, o in sorted(self.osds.items()):
            if not o.up:
                continue
            st = o.store
            colls = {}
            for c in sorted(st.list_collections(), key=lambda c: c.name):
                colls[c.name] = [
                    ((g.name, g.shard, g.snap), bytes(st.read(c, g)),
                     dict(st.getattrs(c, g)), dict(st.omap_get(c, g)))
                    for g in sorted(st.collection_list(c),
                                    key=lambda g: (g.name, g.shard, g.snap))]
            out[i] = colls
        return out

    def dump_logs(self) -> dict:
        """Each up daemon's PG logs, each entry's encoded bytes."""
        out = {}
        for i, o in sorted(self.osds.items()):
            if not o.up:
                continue
            rows = {}
            for pgid, pg in sorted(o.pgs.items()):
                ents = []
                for en in pg.log.entries:
                    e = self.M.enc.Encoder()
                    en.encode(e)
                    ents.append(e.bytes())
                rows[pgid] = (ents, dict(pg.missing), pg.state)
            out[i] = rows
        return out

    def acting(self) -> dict:
        return {(p, s): self.osdmap.pg_to_up_acting((p, s))
                for p, pool in sorted(self.osdmap.pools.items())
                for s in range(pool.pg_num)}

    def pg_stats(self) -> dict:
        """Each up daemon's ``pg_stats()`` rows, the scrub stamps left
        out."""
        out = {}
        for i, o in sorted(self.osds.items()):
            if not o.up:
                continue
            out[i] = [
                (r.pgid, r.state, r.primary, r.num_objects, r.num_bytes,
                 r.log_size, r.degraded, r.misplaced, r.unfound,
                 (r.last_update.epoch, r.last_update.version),
                 r.cl_wr_ops, r.cl_wr_bytes, r.cl_rd_ops, r.cl_rd_bytes,
                 r.rec_ops, r.rec_bytes, r.scrub_errors)
                for r in o.pg_stats()]
        return out

    def dump_scrubs(self) -> dict:
        """Each up daemon's ``dump_scrubs()`` rows, the stamps left out."""
        return {i: [{k: v for k, v in row.items()
                     if k not in ("last_scrub", "last_deep_scrub")}
                    for row in o.dump_scrubs()["scrubs"]]
                for i, o in sorted(self.osds.items()) if o.up}


class LibClient:
    """``test_osd_cluster.py``'s ``LibClient`` over ``cluster``'s package:
    its ``RadosClient``, placed and resent by its objecter."""

    def __init__(self, cluster: DaemonCluster, name: Optional[int] = None,
                 pinned: bool = False) -> None:
        M = cluster.M
        rados = importlib.import_module(f"{cluster.pkg}.client.rados")
        kw = dict(cluster.dev)
        if name is not None:
            kw["name"] = M.message.EntityName("client", name)
        self.cluster = cluster
        self.rc = rados.RadosClient(cluster.ctx, **kw)
        if pinned:
            self.rc.objecter._name = f"client.{name}.0"
            # no timer resend: a read a loaded host slows past 1 s would
            # run twice in one package's cluster and once in the other's
            self.rc.objecter.resend_interval = WAIT_S
        self.rc.inject_osdmap(cluster.osdmap, cluster.book())
        cluster.watchers.append(self._notify)

    def _notify(self, book: dict) -> None:
        self.rc.objecter.handle_osdmap(self.cluster.osdmap, book)

    def op(self, pool: int, oid: str, ops: List, timeout: float = 15.0):
        return self.rc.ioctx(pool).operate(oid, ops, timeout=timeout)

    def put(self, pool: int, oid: str, data: bytes):
        t = self.cluster.M.t
        return self.op(pool, oid, [t.OSDOp(t.OP_WRITEFULL, data=data)])

    def get(self, pool: int, oid: str) -> bytes:
        t = self.cluster.M.t
        rep = self.op(pool, oid, [t.OSDOp(t.OP_READ)])
        assert rep.result == 0, f"read failed: {rep.result}"
        return rep.ops[0].out_data

    def delete(self, pool: int, oid: str):
        t = self.cluster.M.t
        return self.op(pool, oid, [t.OSDOp(t.OP_DELETE)])

    def shutdown(self) -> None:
        if self._notify in self.cluster.watchers:
            self.cluster.watchers.remove(self._notify)
        self.rc.shutdown()
