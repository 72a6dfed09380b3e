"""The port's EC and replicated backends (``ceph_tpu_torch/osd/backend.py``)
on the CPU, case for case with the reference tests whose imports are
ported:

- all four cases of ``tests/test_backend_inflight.py`` (in-flight op
  re-resolution on a peer change, per-peer sub-write aggregation);
- the two backend-only cases of ``tests/test_ec_rmw.py`` (``:163`` the
  extent cache pipelining overlapping RMWs over three backends, ``:222``
  the hinfo CRC roundtrip);
- ``tests/test_dencoder.py:140``, a legacy ``MECSubWrite`` applied by
  ``ECBackend``;

plus the port's own device rule: a codec with no device means the card,
and without one the backend raises.

Every codec here is built with ``device="cpu"``, so the backend takes
the CPU's queue and the plain versions of the kernels run.  What waits:
the cluster cases of ``test_ec_rmw.py`` (``:39,85``) and
``test_dencoder.py:245,283`` (they serve reads through the PG) for
slices 1g and 1j, and the cluster cases of ``test_device_datapath.py``
(``:203-275``) for 1j.
"""

import binascii
import os
import threading
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from ceph_tpu_torch.ec import codec_from_profile
from ceph_tpu_torch.osd import messages as om
from ceph_tpu_torch.osd import types as t_
from ceph_tpu_torch.osd.backend import (ECBackend, InFlightOp, ObjectState,
                                        ReplicatedBackend, _hinfo,
                                        hinfo_decode)
from ceph_tpu_torch.osd.pglog import rollback_prefix
from ceph_tpu_torch.osd.types import EVersion, LogEntry
from ceph_tpu_torch.store.memstore import MemStore
from ceph_tpu_torch.store.objectstore import (Collection, GHObject,
                                              Transaction)

V1_CORPUS = os.path.join(os.path.dirname(__file__), "corpus_v1")
RMW_PROFILE = "plugin=isa k=2 m=1 technique=reed_sol_van stripe_unit=512"


def _codec(profile: str):
    return codec_from_profile(profile, device="cpu")


def _store_with(coll: Collection) -> MemStore:
    s = MemStore()
    s.mkfs()
    s.mount()
    t = Transaction()
    t.create_collection(coll)
    s.queue_transaction(t)
    return s


# -- tests/test_backend_inflight.py ----------------------------------------


def test_inflight_drop_missing_fires_once():
    fired = []
    op = InFlightOp({1, 2, 3}, lambda: fired.append(1))
    op.drop_missing(lambda who: who in (1, 2))   # 3 died
    assert not fired
    op.ack(1)
    assert not fired
    op.drop_missing(lambda who: who == 1)        # 2 died too
    assert fired == [1]
    op.drop_missing(lambda who: False)           # idempotent when empty
    assert fired == [1]


def test_replicated_write_completes_when_peer_dies():
    coll = Collection("1.0_head")
    store = _store_with(coll)
    sent = []
    be = ReplicatedBackend((1, 0), coll, store, 0,
                           lambda osd, msg: sent.append((osd, msg)),
                           lambda: 1)
    done = []
    be.submit("o", ObjectState(b"x"), [], {}, [0, 1, 2],
              lambda: done.append(1))
    assert not done          # local ack only; peers 1,2 outstanding
    assert len(sent) == 2
    be.on_peer_change({0, 2})   # osd.1 marked down
    assert not done
    be.on_peer_change({0})      # osd.2 down too
    assert done == [1]
    assert not be.in_flight


def test_ec_write_completes_when_shard_holder_dies():
    coll = Collection("2.0_head")
    store = _store_with(coll)
    sent = []
    codec = _codec("plugin=isa k=2 m=1 technique=reed_sol_van")
    be = ECBackend((2, 0), coll, store, 0,
                   lambda osd, msg: sent.append((osd, msg)), lambda: 1,
                   codec)
    done = []
    done_ev = threading.Event()
    submitted = threading.Event()
    be.submit("o", ObjectState(b"y" * 64), [], {}, [0, 1, 2],
              lambda: (done.append(1), done_ev.set()),
              on_submitted=submitted.set)
    assert submitted.wait(10), "async fan-out never queued"
    assert len(sent) == 2  # one MECSubWriteVec per PEER, not per shard
    assert not done
    be.on_peer_change({0, 1})   # shard 2's holder (osd.2) died
    assert not done
    tid = next(iter(be.in_flight))
    be.handle_reply(tid, 1)
    assert done_ev.wait(10)
    assert done == [1]


def test_ec_subwrites_aggregate_per_peer():
    """k=4,m=2 over 3 OSDs: ONE merged transaction per peer carrying both
    of its shards, and the receiving peer lands both shards (plus both
    rollback records) in a single store transaction."""
    coll = Collection("3.0_head")
    store = _store_with(coll)
    peer_store = _store_with(coll)
    sent = []
    codec = _codec("plugin=isa k=4 m=2 technique=reed_sol_van")
    be = ECBackend((3, 0), coll, store, 0,
                   lambda osd, msg: sent.append((osd, msg)), lambda: 1,
                   codec)
    peer_be = ECBackend((3, 0), coll, peer_store, 1,
                        lambda osd, msg: None, lambda: 1, codec)
    entry = LogEntry(op=2, oid="o", version=EVersion(1, 1),
                     prior_version=EVersion(0, 0))
    acting = [0, 1, 2, 0, 1, 2]  # osd i holds shards i and i+3
    done = threading.Event()
    submitted = threading.Event()
    be.submit("o", ObjectState(b"z" * 4096), [entry], {}, acting,
              done.set, on_submitted=submitted.set)
    assert submitted.wait(10)
    assert sorted(osd for osd, _ in sent) == [1, 2]
    for osd, msg in sent:
        assert isinstance(msg, om.MECSubWriteVec)
        assert sorted(s for s, _k, _o, _l in msg.rb) == [osd, osd + 3]
    tid = next(iter(be.in_flight))
    vec = next(msg for osd, msg in sent if osd == 1)
    applied = threading.Event()
    peer_be.apply_sub_write_vec(vec, on_commit=applied.set)
    assert applied.wait(10)
    for shard in (1, 4):
        assert peer_store.exists(coll, GHObject("o", shard=shard))
    meta = peer_store.omap_get(coll, GHObject("_pgmeta_"))
    rb_keys = [k for k in meta
               if k.startswith(rollback_prefix(entry.version))]
    assert sorted(rb_keys) == [rollback_prefix(entry.version) + "1",
                               rollback_prefix(entry.version) + "4"]
    be.handle_reply(tid, 1)
    be.handle_reply(tid, 2)
    assert done.wait(10)  # local (osd 0) ack rides the commit
    assert not be.in_flight


# -- tests/test_ec_rmw.py:110-240 ------------------------------------------


class _Harness:
    """Three ECBackends over memstores with manual ack control, so two
    RMWs can genuinely be in flight at once (``test_ec_rmw.py:110``)."""

    def __init__(self) -> None:
        self.codec = _codec(RMW_PROFILE)
        self.coll = Collection("p_head")
        self.stores = {i: _store_with(self.coll) for i in range(3)}
        self.pending = []  # (osd, msg) undelivered sub-writes
        self.backends = {
            i: ECBackend((1, 0), self.coll, self.stores[i], i, self._send,
                         lambda: 1, self.codec)
            for i in range(3)}
        self.acting = [0, 1, 2]

    def _send(self, osd, msg) -> None:
        self.pending.append((osd, msg))

    def flush(self) -> None:
        """Deliver + ack everything pending (in order)."""
        while self.pending:
            osd, msg = self.pending.pop(0)
            self.backends[osd].apply_sub_write_vec(msg)
            self.backends[0].handle_reply(msg.tid, osd)

    def submit_full(self, be, data: bytes, entry, done) -> None:
        sub = threading.Event()
        be.submit("o", ObjectState(bytes(data)), [entry], {},
                  self.acting, done, on_submitted=sub.set)
        assert sub.wait(10), "fan-out never queued"

    def submit_part(self, be, s0, stripes, size, entry, done) -> None:
        sub = threading.Event()
        be.submit_partial("o", s0, stripes, size, [entry], {},
                          self.acting, done, on_submitted=sub.set)
        assert sub.wait(10), "fan-out never queued"

    @staticmethod
    def entry(v: int) -> LogEntry:
        return LogEntry(op=t_.LOG_MODIFY, oid="o", version=EVersion(1, v),
                        prior_version=EVersion(1, v - 1))


def test_extent_cache_pipelines_overlapping_rmw():
    h = _Harness()
    be = h.backends[0]
    rng = np.random.default_rng(2)
    data = bytearray(rng.integers(0, 256, size=16384, dtype=np.uint8))

    done1 = threading.Event()
    h.submit_full(be, bytes(data), h.entry(1), done1.set)
    h.flush()
    assert done1.wait(5)

    width = be.stripe_width
    s0, s1 = 2, 4  # RMW #1: stripes 2..3, left IN FLIGHT
    stripes = {s: bytearray(data[s * width:(s + 1) * width])
               for s in range(s0, s1)}
    patch1 = b"\x11" * width
    stripes[2][:] = patch1
    data[2 * width: 3 * width] = patch1
    done2 = threading.Event()
    h.submit_part(be, s0, stripes, len(data), h.entry(2), done2.set)
    assert not done2.is_set(), "must still be waiting on shard acks"

    # RMW #2 overlaps stripe 3 while #1 is in flight: a cache hit
    hits0 = be.cache.hits
    cached, missing = be.read_cached_stripes("o", 3, 4)
    assert 3 in cached and not missing, "overlapping RMW missed the cache"
    assert be.cache.hits > hits0
    patch2 = b"\x22" * width
    cached[3][:] = patch2
    data[3 * width: 4 * width] = patch2
    done3 = threading.Event()
    h.submit_part(be, 3, cached, len(data), h.entry(3), done3.set)

    h.flush()
    assert done2.wait(5) and done3.wait(5)

    avail = {s: h.backends[s].read_local_chunk("o", s) for s in range(3)}
    st = be.reconstruct("o", {s: c for s, c in avail.items()
                              if c is not None})
    assert st is not None and st.data == bytes(data)
    cached2, missing2 = be.read_cached_stripes("o", 2, 4)
    assert not missing2
    done4 = threading.Event()
    h.submit_full(be, bytes(data), h.entry(4), done4.set)
    h.flush()
    assert done4.wait(5)
    assert be.cache.get("o", 2) is None
    be.cache.put("o", 9, b"x" * width)
    be.on_peer_change({0, 1, 2})
    assert be.cache.get("o", 9) is None


def test_hinfo_crc_invalidation_roundtrip():
    """Extent writes invalidate the whole-chunk crc; a later full write
    restores crc validity."""
    size, crc, valid = hinfo_decode(_hinfo(b"abc", 3))
    assert (size, valid) == (3, True) and crc != 0
    size, crc, valid = hinfo_decode(_hinfo(b"", 99, False))
    assert (size, valid) == (99, False)


# -- tests/test_dencoder.py:140 --------------------------------------------


def test_legacy_mec_sub_write_still_decodes_and_applies():
    """An old-style primary's per-shard MECSubWrite (the committed v2
    blob carries a real transaction) decodes on the port and applies
    through the legacy path: shard data lands, the rollback record is
    captured, the commit ack fires."""
    from ceph_tpu_torch.msg.message import Message

    with open(os.path.join(V1_CORPUS, "MECSubWrite_v2_apply.hex")) as f:
        msg = Message.from_bytes(binascii.unhexlify(f.read().strip()))
    assert isinstance(msg, om.MECSubWrite)
    assert msg.shard == 1 and msg.oid == "obj-a" and msg.rb_kind == 1
    assert msg.committed_to == EVersion(4, 15)

    coll = Collection("2.5_head")
    store = _store_with(coll)
    codec = _codec("plugin=isa k=4 m=2 technique=reed_sol_van")
    be = ECBackend((2, 5), coll, store, 1, lambda o, m_: None,
                   lambda: 33, codec)
    acked = threading.Event()
    be.apply_sub_write(msg, on_commit=acked.set)
    assert acked.wait(10), "legacy sub-write never committed"
    assert store.read(coll, GHObject("obj-a", shard=1)) == b"legacy-chunk"
    meta = store.omap_get(coll, GHObject("_pgmeta_"))
    pre = rollback_prefix(msg.entries[-1].version)
    assert any(k.startswith(pre) for k in meta), "legacy rb capture missing"


# -- the port's device rule ------------------------------------------------


def test_backend_takes_its_codecs_device_and_raises_without_a_card(
        monkeypatch):
    """``ECBackend`` takes ``default_queue(codec.device)``: a CPU codec
    gets the CPU's queue; a codec with no device means the card, so with
    no card the codec itself cannot be built and a backend over a codec
    without a device raises."""
    coll = Collection("4.0_head")
    be = ECBackend((4, 0), coll, _store_with(coll), 0, None, None,
                   _codec("plugin=isa k=2 m=1"))
    assert be.queue.device.type == "cpu"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        codec_from_profile("plugin=isa k=2 m=1")
    no_dev = SimpleNamespace(device=None, get_sub_chunk_count=lambda: 1)
    with pytest.raises(RuntimeError, match="CUDA"):
        ECBackend((4, 0), coll, _store_with(coll), 0, None, None, no_dev)


def test_clay_routes_wait_for_their_slice():
    """A clay backend builds (its slice has landed): a degraded read with
    a data shard lost rides the queue's cdec kind and a single-shard
    repair from layers-only helper bytes rides crep, each giving the
    reference codec's bytes; an extent decode is refused (no sub-chunk
    structure), as in the reference."""
    from ceph_tpu.ec.clay import ClayCodec as RefClay

    coll = Collection("5.0_head")
    codec = _codec("plugin=clay k=4 m=2")
    be = ECBackend((5, 0), coll, _store_with(coll), 0, None, None, codec)
    kinds = []
    for name in ("clay_decode_async", "clay_repair_async"):
        orig = getattr(be.queue, name)

        def spy(*a, _orig=orig, _name=name, **kw):
            kinds.append(_name)
            return _orig(*a, **kw)

        setattr(be.queue, name, spy)
    data = bytes(np.random.default_rng(5).integers(0, 256, 20000,
                                                   dtype=np.uint8))
    planes = be._prep_planes(data)
    assert planes.shape[1] % codec.get_sub_chunk_count() == 0
    ref = RefClay(k=4, m=2)
    chunks = list(planes) + list(np.asarray(ref.encode_array(planes)))
    meta = ({"hinfo": _hinfo(chunks[0].tobytes(), len(data))}, {})
    got = []
    done = threading.Event()
    be.reconstruct_async(
        "o", {i: chunks[i].tobytes() for i in (1, 2, 4, 5)}, meta,
        lambda st: (got.append(st), done.set()))
    assert done.wait(30) and got[0].data == data
    layers = codec.repair_layers(3)
    s = len(chunks[0]) // codec.get_sub_chunk_count()
    helper_layers = {h: chunks[h].reshape(-1, s)[layers].tobytes()
                     for h in (0, 1, 2, 4, 5)}
    rep = []
    done.clear()
    be.repair_chunk_async("o", 3, helper_layers,
                          lambda c: (rep.append(c), done.set()))
    assert done.wait(30) and rep[0] == chunks[3].tobytes()
    assert kinds == ["clay_decode_async", "clay_repair_async"]
    n = be.unit
    assert be.assemble_range({i: chunks[i][:n].tobytes()
                              for i in (1, 2, 4, 5)}, 0, 1) is None