"""Scrub and repair of the port's PG (``ceph_tpu_torch/osd/{pg,scrub}.py``)
held against ``ceph_tpu``'s, bit for bit.

Each package's PGs run the op sequence, the peering and (EC) the
recovery window of ``test_torch_pg_xcheck._sequence`` in the loopback
harness of ``torch_pg_harness``; then the same rot is injected into
both, and both walk the same scrub and repair steps:

- EC pools: a data-err mark on a peer's shard of ``obj_a`` (its reads
  fail their extent seals and answer ``ECRC``), and a crc-valid
  rewrite of a peer's shard of ``obj_c`` (a flipped byte with a fresh
  ``hinfo``: only decode-and-reverify sees it).  Replicated pool: a
  data-err mark on osd.1's copy of ``obj_a`` and a changed user xattr
  on osd.2's ``obj_c`` (metadata rot, seen by a shallow scrub too).
- ``scrub_engine().run``: shallow, deep without repair, deep with
  auto-repair; ``local_scrub_map`` deep and shallow on every host;
  the rot injected again, ``repair_objects``, ``repair()`` and
  ``scrub()``.
- Replicated only: the primary's own copy made divergent
  (``repair()`` pulls it back through ``MPGPull``), and an object that
  only osd.2 holds (the majority says deleted: an ``MPGPush`` with
  ``deleted``).

What is compared, exactly: every step's errors dict, ``scrub_errors``,
the cursor and stamps rows of every PG meta omap, the engine's cursor
and every host's ``scrub_perf`` dump after each step; every message
each host received (type and bytes, per source, in order), every
store's objects, each PG's info and log rows, the hosts' logged lines
and their cluster-log lines.  ``time.time`` is pinned for both (the
stamps and log entries carry it).

The last case carries state across: the reference engine's deep scrub
is interrupted at the ``scrub.chunk`` failpoint, its stores are copied
object by object into the port's MemStores, and the port's engine
resumes from the reference's cursor, as the reference's own resume
does.
"""

import importlib
import threading
import time

import numpy as np
import pytest

import test_torch_pg_xcheck as X
import torch_pg_harness as H

CLOCK = X.CLOCK
META_KEYS = ("scrub_cursor", "scrub_stamps")


def _fp(net):
    return importlib.import_module(f"{net.mods.pkg}.core.failpoint")


def _meta_rows(net) -> list:
    G = net.mods.os.GHObject
    return [{k: v for k, v in h.store.omap_get(h.pg.coll,
                                               G("_pgmeta_")).items()
             if k in META_KEYS} for h in net.hosts]


def _mark(net, osd: int, oid: str, shard: int = -1) -> None:
    """Silent rot: reads of (oid, shard) on ``osd`` serve flipped bytes
    until a rewrite clears the mark."""
    h = net.hosts[osd]
    h.store.debug_data_err_enabled = True
    h.store.debug_inject_data_err(h.pg.coll,
                                  net.mods.os.GHObject(oid, shard=shard))


def _rewrite_shard(net, oid: str, shard: int) -> None:
    """A crc-valid corrupt shard: one byte flipped, hinfo re-stamped."""
    M = net.mods
    h = net.hosts[net.acting[shard]]
    g = M.os.GHObject(oid, shard=shard)
    st, coll = h.store, h.pg.coll
    data = bytearray(st.read(coll, g))
    data[7] ^= 0x5A
    size, _, _ = M.backend.hinfo_decode(st.getattr(coll, g, "hinfo"))
    t = M.os.Transaction()
    t.write(coll, g, 0, bytes(data))
    t.setattrs(coll, g, {"hinfo": M.backend._hinfo(bytes(data), size)})
    st.queue_transaction(t)


def _scrub_steps(net) -> dict:
    """The scrub and repair steps on a settled ``Net``; returns what
    each step answered and left behind."""
    M = net.mods
    G, T = M.os.GHObject, M.os.Transaction
    pg = net.primary.pg
    eng = pg.scrub_engine()
    clog: list = []
    for h in net.hosts:
        h.ctx.log.cluster_cb = (
            lambda who: lambda lvl, msg: clog.append((who, lvl, msg)))(
                h.whoami)
    out: dict = {}

    def step(name, fn):
        res = fn()
        net.settle()
        out[name] = (res, pg.scrub_errors, _meta_rows(net), eng.cursor,
                     [h.scrub_perf.dump() for h in net.hosts])
        return res

    ec = pg.is_ec()
    if ec:
        n = len(net.acting)
        _mark(net, net.acting[1], "obj_a", 1)
        _rewrite_shard(net, "obj_c", n - 1)
    else:
        _mark(net, 1, "obj_a")
        h2 = net.hosts[2]
        t = T()
        t.setattrs(h2.pg.coll, G("obj_c"), {"user.k": b"rotten"})
        h2.store.queue_transaction(t)
    step("shallow", lambda: eng.run(deep=False))
    step("deep", lambda: eng.run(deep=True, auto_repair=False))
    step("deep_auto", lambda: eng.run(deep=True, auto_repair=True))
    step("maps", lambda: [(h.pg.local_scrub_map(deep=True),
                           h.pg.local_scrub_map(deep=False))
                          for h in net.hosts])
    # the same rot again: the targeted repair, then repair() and scrub()
    if ec:
        _mark(net, net.acting[1], "obj_a", 1)
        _mark(net, net.acting[n - 2], "obj_c", n - 2)
    else:
        _mark(net, 1, "obj_a")
        _mark(net, 2, "obj_c")
    step("repair_objects", lambda: pg.repair_objects(["obj_a"]))
    step("repair", pg.repair)
    step("scrub", pg.scrub)
    if not ec:
        # the primary's own copy diverges: repair() pulls it back
        h0 = net.primary
        t = T()
        t.write(h0.pg.coll, G("obj_a"), 0, b"diverged")
        h0.store.queue_transaction(t)
        step("primary_divergent", pg.repair)
        # only osd.2 holds it: the majority says deleted
        h2 = net.hosts[2]
        t = T()
        t.touch(h2.pg.coll, G("ghost"))
        t.write(h2.pg.coll, G("ghost"), 0, b"resurrect me")
        h2.store.queue_transaction(t)
        step("majority_deleted", pg.repair)
    step("final_deep", lambda: eng.run(deep=True))
    for h in net.hosts:
        h.store.debug_data_err_enabled = False
        h.ctx.log.cluster_cb = None
    out["dump"] = eng.dump()
    out["cluster_log"] = clog
    return out


def _names(received) -> set:
    return {name for rx in received for msgs in rx.values()
            for name, _ in msgs}


@pytest.mark.parametrize("name", sorted(X.PROFILES))
def test_scrub_and_repair_of_both_packages_alike(name, monkeypatch):
    monkeypatch.setattr(time, "time", lambda: CLOCK)
    profile, n_osds = X.PROFILES[name]
    ref = X._sequence("ceph_tpu", profile, n_osds, seed=19,
                      then=_scrub_steps)
    port = X._sequence("ceph_tpu_torch", profile, n_osds, seed=19,
                       then=_scrub_steps)
    s = port["then"]
    for step in ref["then"]:
        assert s[step] == ref["then"][step], step
    for key in ref:
        assert port[key] == ref[key], key
    # the run did what it set out to: the deep pass found both objects,
    # the shallow pass only metadata rot, the repairs healed the rot
    assert sorted(s["deep"][0]) == ["obj_a", "obj_c"]
    if profile is None:
        assert sorted(s["shallow"][0]) == ["obj_c"]
        assert s["primary_divergent"][0] == {}
        assert s["majority_deleted"][0] == {}
        assert "MPGPull" in _names(port["received"])
    else:
        assert s["shallow"][0] == {}
        assert any("crc mismatch" in e for e in s["deep"][0]["obj_a"])
        assert any("parity mismatch" in e for e in s["deep"][0]["obj_c"])
        assert "MECSubRead" in _names(port["received"])
    assert s["deep"][1] == 2
    assert s["final_deep"][0] == {} and s["final_deep"][1] == 0
    assert {"MScrub", "MScrubMap", "MPGPush"} <= _names(port["received"])
    assert s["dump"]["cursor"] == "" and not s["dump"]["running"]
    assert any(lvl == "ERR" and "deep-scrub" in msg
               for _, lvl, msg in port["then"]["cluster_log"])


RESUME_PROFILE = "plugin=isa k=2 m=1 technique=reed_sol_van"


def _store_objects(host) -> list:
    st, coll = host.store, host.pg.coll
    return [(o, bytes(st.read(coll, o)), dict(st.getattrs(coll, o)),
             dict(st.omap_get(coll, o)))
            for o in sorted(st.collection_list(coll),
                            key=lambda g: (g.name, g.shard, g.snap))]


def _copy_stores(src, dst) -> None:
    """Every object of every ``src`` host's PG collection, with its
    bytes, attributes and omap, into the ``dst`` host's store (objects
    rebuilt in ``dst``'s package), then each PG reloads its log, info
    and stamps from the store."""
    M = dst.mods
    for hs, hd in zip(src.hosts, dst.hosts):
        coll = hd.pg.coll
        t = M.os.Transaction()
        for o in hd.store.collection_list(coll):
            t.try_remove(coll, o)
        for o, data, attrs, omap in _store_objects(hs):
            g = M.os.GHObject(o.name, shard=o.shard, snap=o.snap)
            t.touch(coll, g)
            if data:
                t.write(coll, g, 0, data)
            if attrs:
                t.setattrs(coll, g, attrs)
            if omap:
                t.omap_setkeys(coll, g, omap)
        hd.store.queue_transaction(t)
        hd.pg.load_from_store()


def test_port_engine_resumes_the_reference_engines_cursor(monkeypatch):
    """The reference's deep scrub parks at its second chunk (chunk max
    2, cursor persisted after the first) and is aborted; its stores go
    object by object into port MemStores, the PGs of both packages
    reload from their stores (a restart), and the port's engine resumes
    from the persisted cursor with auto-repair, exactly as the
    reference's engine resumes on its own stores: same errors, same
    messages, same stores, same counters for the resumed pass."""
    monkeypatch.setattr(time, "time", lambda: CLOCK)
    conf = {"osd_scrub_chunk_max": 2}
    rng = np.random.default_rng(19)
    ref = H.Net("ceph_tpu", RESUME_PROFILE, 3, conf=conf)
    port = H.Net("ceph_tpu_torch", RESUME_PROFILE, 3, conf=conf)
    try:
        t = ref.mods.t
        for i in range(6):
            data = rng.integers(0, 256, 3000 + 500 * i,
                                dtype=np.uint8).tobytes()
            assert ref.op(f"res_{i}", [t.OSDOp(t.OP_WRITEFULL, data=data)],
                          reqid=f"client.1:{i + 1}").result == 0
        ref.settle()
        eng = ref.primary.pg.scrub_engine()
        names = sorted(ref.primary.pg.backend.object_names())
        fp = _fp(ref)
        fp.arm("scrub.chunk", fp.barrier("scrub-park"),
               match={"first": names[2]})
        out = []

        def scrub_thread() -> None:
            try:
                out.append(eng.run(deep=True))
            except fp.FailpointAborted:
                pass  # the induced kill: the cursor stays persisted

        th = threading.Thread(target=scrub_thread, daemon=True)
        try:
            th.start()
            assert fp.wait_hit("scrub-park", timeout=30.0)
            deep, cursor = eng._load_cursor()
            assert deep and cursor == names[1], (cursor, names)
            fp.abort("scrub-park")
            th.join(timeout=30.0)
            assert not th.is_alive() and not out
        finally:
            fp.disarm_all()
        ref.settle()
        _copy_stores(ref, port)
        for h in ref.hosts:  # both sides restart from the same stores
            h.pg.load_from_store()
        assert port.primary.pg.scrub_engine()._load_cursor() == (True,
                                                                 names[1])
        runs = {}
        for net in (ref, port):
            _mark(net, 1, names[4], 1)
            for h in net.hosts:
                h._tid = 0  # a message's tid rides its bytes
            marks = [len(h.received) for h in net.hosts]
            perf0 = [h.scrub_perf.dump() for h in net.hosts]
            errs = net.primary.pg.scrub_engine().run(deep=True,
                                                     auto_repair=True)
            net.settle()
            for h in net.hosts:
                h.store.debug_data_err_enabled = False
            runs[net.mods.pkg] = {
                "errors": errs,
                "received": [X._by_source(h.received[k:])
                             for h, k in zip(net.hosts, marks)],
                "perf": [{c: v - p0[c] for c, v in h.scrub_perf.dump().items()}
                         for h, p0 in zip(net.hosts, perf0)],
                "stores": [X._dump_store(h) for h in net.hosts],
                "meta": _meta_rows(net),
                "scrub_errors": net.primary.pg.scrub_errors,
                "logged": [h.logged for h in net.hosts]}
        want, got = runs["ceph_tpu"], runs["ceph_tpu_torch"]
        for key in want:
            if key != "logged":
                assert got[key] == want[key], key
        # the port's hosts logged only the resumed pass
        assert got["logged"] == [lg[len(lg) - len(pl):]
                                 for lg, pl in zip(want["logged"],
                                                   got["logged"])]
        assert got["errors"] == {} and got["scrub_errors"] == 0
        assert got["perf"][0]["resumes"] == 1
        assert got["perf"][0]["objects"] == len(names) - 2
        assert got["perf"][0]["errors_repaired"] == 1
    finally:
        ref.stop()
        port.stop()
