"""``tests/test_clay_device.py:91-267`` mirrored on the port: the queue's
clay kinds (``crep``, ``cdec``) and the sub-chunk repair plan end to end.

Each queue case runs the port's ``StripeBatchQueue(device="cpu")`` and
the reference's ``StripeBatchQueue`` over the same chunks, and holds the
port's result to the reference queue's, to the reference codec's host
API and to the original chunk, for every lost-shard index of k=4 m=2,
k=8 m=4 and the shortened k=5 m=3, at ragged per-layer widths (the
covering pad must never reach real bytes) and in coalesced batches (the
jobs lie side by side along the sub-chunk byte axis).  A coalesced
``encp`` batch of different widths gives the reference's coding and
per-shard CRCs.

The plan cases run the port's recovery engine over the port's stub PG
(``test_torch_recovery._stub_pg``/``_seed_missing``) on a k=8 m=4 d=11
pool: one ``MECSubReadVec`` a helper with runs on every row, only the
repair layers on the wire, ``repair_read_frac`` at most 400 permille,
the repair on the queue; and a helper that never answers the sub-chunk
round falls back to whole chunks.

The last case runs the ``clay`` phase's code (``chip_smoke.run_clay``)
on the CPU at four 64 KiB objects.

The reference's two thrash cases (``:269,280``) need ``tools/
thrash_hunt.py`` and wait (ROADMAP 1k).
"""

import time

import numpy as np
import pytest
import torch

import chip_smoke
from test_torch_recovery import _seed_missing, _stub_pg

from ceph_tpu.ec.clay import ClayCodec as RefClay
from ceph_tpu.tpu.queue import StripeBatchQueue as RefQueue
from ceph_tpu_torch.ec.clay import ClayCodec
from ceph_tpu_torch.gpu.queue import StripeBatchQueue
from ceph_tpu_torch.msg.message import EntityName
from ceph_tpu_torch.osd import messages as m
from ceph_tpu_torch.osd.backend import _av_stamp, _hinfo
from ceph_tpu_torch.store.objectstore import GHObject


def _codecs(k, m_):
    return ClayCodec(k=k, m=m_, device="cpu"), RefClay(k=k, m=m_)


def _chunks(codec, s, seed=0):
    """Random data planes [k, Z*s] + parity via the codec: the full chunk
    list (row i = chunk i, flat uint8 [Z*s])."""
    rng = np.random.default_rng(seed)
    data = rng.integers(0, 256, size=(codec.k, codec.sub_count * s),
                        dtype=np.uint8)
    parity = np.asarray(codec.encode_array(data), dtype=np.uint8)
    return [np.ascontiguousarray(r) for r in np.vstack([data, parity])]


def _repair_planes(codec, chunks, lost, s):
    """Layers-only helper planes [d, L, s] for a single-shard repair —
    exactly what the sub-chunk read plan pulls over the wire."""
    layers = codec.repair_layers(lost)
    helpers = [i for i in range(codec.k + codec.m) if i != lost][:codec.d]
    planes = np.stack([
        chunks[h].reshape(codec.sub_count, s)[layers] for h in helpers])
    return helpers, planes


def _queues(window_s=0.001):
    return StripeBatchQueue(device="cpu", window_s=window_s), \
        RefQueue(window_s=window_s)


def _sweep_crep(k, m_, s, seed):
    """Every lost-shard index through both queues' crep kind: the port
    must match the reference queue, the reference host repair and the
    original chunk."""
    codec, ref = _codecs(k, m_)
    chunks = _chunks(ref, s, seed=seed)
    q, rq = _queues()
    try:
        for lost in range(k + m_):
            helpers, planes = _repair_planes(ref, chunks, lost, s)
            got = np.asarray(q.clay_repair(codec, lost, helpers, planes))
            np.testing.assert_array_equal(
                got, chunks[lost].ravel(),
                err_msg=f"k{k}m{m_} s={s}: repair of shard {lost}")
            np.testing.assert_array_equal(
                got, np.asarray(rq.clay_repair(ref, lost, helpers, planes)))
            host = ref.repair_chunk(
                [lost], {h: chunks[h] for h in helpers})[lost]
            np.testing.assert_array_equal(got, np.asarray(host).ravel())
    finally:
        q.stop()
        rq.stop()


def _sweep_cdec(k, m_, s, seed):
    """Erasure patterns through both queues' cdec kind: data planes must
    come back bit-exact and equal to the reference queue's."""
    codec, ref = _codecs(k, m_)
    chunks = _chunks(ref, s, seed=seed)
    want = np.stack(chunks[:k])
    q, rq = _queues()
    rng = np.random.default_rng(seed + 1)
    try:
        for _ in range(4):
            n_erase = int(rng.integers(1, m_ + 1))
            erased = set(rng.choice(k + m_, size=n_erase,
                                    replace=False).tolist())
            avail = {i: chunks[i] for i in range(k + m_) if i not in erased}
            got = np.asarray(q.clay_decode_async(codec, avail).result())
            np.testing.assert_array_equal(
                got, want, err_msg=f"k{k}m{m_} s={s}: erased={erased}")
            np.testing.assert_array_equal(
                got, np.asarray(rq.clay_decode_async(ref, avail).result()))
    finally:
        q.stop()
        rq.stop()


def test_crep_device_bit_exact_every_lost_shard_k4m2():
    # s=40: a ragged (non-pow2) per-layer width — the covering pad must
    # never leak into real bytes
    _sweep_crep(4, 2, s=40, seed=3)


def test_cdec_device_bit_exact_k4m2():
    _sweep_cdec(4, 2, s=40, seed=7)


def test_crep_ragged_tail_widths():
    """Odd per-layer widths (1, 5, 7 bytes) through the bucketed
    dispatch: the smallest shapes stress the pad-then-slice path."""
    codec, ref = _codecs(4, 2)
    q, rq = _queues()
    try:
        for s in (1, 5, 7):
            chunks = _chunks(ref, s, seed=s)
            lost = 3
            helpers, planes = _repair_planes(ref, chunks, lost, s)
            got = np.asarray(q.clay_repair(codec, lost, helpers, planes))
            np.testing.assert_array_equal(
                got, chunks[lost].ravel(), err_msg=f"s={s}")
            np.testing.assert_array_equal(
                got, np.asarray(rq.clay_repair(ref, lost, helpers, planes)))
    finally:
        q.stop()
        rq.stop()


@pytest.mark.parametrize("k,m_,s", [(8, 4, 33), (5, 3, 17)])
def test_crep_device_bit_exact_full_matrix(k, m_, s):
    """Bigger geometries (k8m4 = the paper's headline config, k5m3 =
    shortened construction with a virtual node) across every lost
    shard, ragged widths."""
    _sweep_crep(k, m_, s=s, seed=k * 31 + m_)
    _sweep_cdec(k, m_, s=s, seed=k * 37 + m_)


def test_crep_jobs_coalesce_into_one_batch():
    """Concurrent repairs of the SAME lost shard must coalesce along the
    S axis — and every job in the batch still comes back bit-exact and
    equal to the reference queue's own coalesced batch."""
    codec, ref = _codecs(4, 2)
    q = StripeBatchQueue(device="cpu", window_s=0.25)
    rq = RefQueue(window_s=0.25)
    try:
        jobs = []
        for seed in range(6):
            chunks = _chunks(ref, 24, seed=seed)
            helpers, planes = _repair_planes(ref, chunks, 2, 24)
            jobs.append((chunks,
                         q.clay_repair_async(codec, 2, helpers, planes),
                         rq.clay_repair_async(ref, 2, helpers, planes)))
        for chunks, fut, rfut in jobs:
            got = np.asarray(fut.result())
            np.testing.assert_array_equal(got, chunks[2].ravel())
            np.testing.assert_array_equal(got, np.asarray(rfut.result()))
        # the worker counts a batch after its futures are set
        deadline = time.monotonic() + 10.0
        while q.jobs < 6 and time.monotonic() < deadline:
            time.sleep(0.001)
        # 6 jobs enqueued within one coalescing window: at most the
        # first dispatches alone before the rest pile up
        assert q.batches <= 3, f"{q.batches} batches for 6 same-sig jobs"
        assert max(q.dec_batch_jobs) >= 2, q.dec_batch_jobs
    finally:
        q.stop()
        rq.stop()


def test_encp_coalesced_batch_matches_reference():
    """Writes of different widths in one encp batch: each job's coding
    and its k+m per-shard CRCs over its own chunk layout equal the
    reference queue's."""
    codec, ref = _codecs(5, 3)
    q = StripeBatchQueue(device="cpu", window_s=0.25)
    rq = RefQueue(window_s=0.25)
    try:
        rng = np.random.default_rng(9)
        jobs = []
        for s in (3, 8, 13):
            data = rng.integers(0, 256, (5, ref.sub_count * s),
                                dtype=np.uint8)
            jobs.append((q.encode_crc_async(codec, data),
                         rq.encode_crc_async(ref, data)))
        for fut, rfut in jobs:
            (c, crc), (rc, rcrc) = fut.result(), rfut.result()
            np.testing.assert_array_equal(c, np.asarray(rc))
            np.testing.assert_array_equal(np.asarray(crc, np.uint32),
                                          np.asarray(rcrc, np.uint32))
        deadline = time.monotonic() + 10.0
        while q.jobs < 3 and time.monotonic() < deadline:
            time.sleep(0.001)
        assert max(q.batch_jobs) >= 2, q.batch_jobs
    finally:
        q.stop()
        rq.stop()


# ---------------------------------------------------------------------------
# degraded clay pool, end to end: sub-chunk plan -> layers-only wire ->
# crep -> _store_repaired, with the counter evidence
# ---------------------------------------------------------------------------

CLAY_PROFILE = "plugin=clay k=8 m=4 d=11"


def _clay_vec_responder(osd, chunks, Z, src_epoch=7, mute=()):
    """Answer MECSubReadVec honoring the runs tail: a row with runs gets
    ONLY those sub-chunk extents back (served=1), an empty-runs row gets
    the whole chunk (served=0) — a peer in `mute` never answers rows
    that carry runs (plan-failure injection)."""

    def respond(osd_id, msg):
        if not isinstance(msg, m.MECSubReadVec):
            return
        run_plans = (msg.runs if len(msg.runs) == len(msg.reads)
                     else [[] for _ in msg.reads])
        if osd_id in mute and any(run_plans):
            return
        rows, served = [], []
        for (shard, oid, _o, _l), rr in zip(msg.reads, run_plans):
            cs, v, data = chunks[oid]
            chunk = bytes(cs[shard])
            attrs = {"hinfo": _hinfo(cs[shard], len(data)),
                     "_av": _av_stamp(v)}
            if rr:
                sub = len(chunk) // Z
                blob = b"".join(chunk[so * sub:(so + cnt) * sub]
                                for so, cnt in rr)
                rows.append((shard, oid, blob, 0, attrs, {}))
                served.append(1)
            else:
                rows.append((shard, oid, chunk, 0, attrs, {}))
                served.append(0)
        rep = m.MECSubReadVecReply((3, 0), src_epoch, rows, served=served)
        rep.tid = msg.tid
        rep.src = EntityName("osd", osd_id)
        osd.reply(msg.tid, rep)

    return respond


def test_clay_degraded_recovery_uses_subchunk_plan_e2e():
    """k=8,m=4,d=11 clay pool, primary missing its single local shard
    for a window of objects: recovery sends per-helper RUN tails, the
    wire carries only repair layers, every object lands with correct
    chunk bytes + recovery _av stamp, and repair_read_frac measures
    ~d/(k*q) = 344 permille (at most 400)."""
    pg, osd = _stub_pg("ceph_tpu_torch", CLAY_PROFILE,
                       acting=list(range(12)), whoami=0,
                       peers=tuple(range(1, 12)))
    Z = pg.backend.codec.get_sub_chunk_count()
    oids = [f"clay{i}" for i in range(3)]
    chunks = _seed_missing(pg, oids)
    osd.responder = _clay_vec_responder(osd, chunks, Z)
    pg.recovery_engine().recover(
        {oid: pg.log.latest_for(oid) for oid in oids})
    with pg.lock:
        assert not pg.missing, f"window left objects: {pg.missing}"
    vecs = [v for _o, v in osd.sent if isinstance(v, m.MECSubReadVec)]
    assert vecs and all(all(rr for rr in v.runs) for v in vecs), \
        [v.runs for v in vecs]
    frac = osd.pg_perf.value("repair_read_frac")
    assert 0 < frac <= 400, f"repair_read_frac={frac} permille"
    assert osd.pg_perf.value("subread_bytes") > 0
    # the repair rode the device queue, not a host bypass
    assert osd.pg_perf.value("decode_batch_jobs") >= 1
    for oid in oids:
        cs, v, _data = chunks[oid]
        g = GHObject(oid, shard=0)
        assert osd.store.read(pg.coll, g) == bytes(cs[0]), \
            f"{oid}: wrong repaired bytes"
        assert osd.store.getattr(pg.coll, g, "_av") == _av_stamp(v)


def test_clay_plan_helper_failure_falls_back_whole_chunk():
    """A helper that never answers the sub-chunk round: attempt 1 times
    out retryable, attempt 2 re-gathers WHOLE chunks (no runs) and the
    object still lands — the plan can only save bytes, never lose an
    object."""
    pg, osd = _stub_pg("ceph_tpu_torch", CLAY_PROFILE,
                       acting=list(range(12)), whoami=0,
                       peers=tuple(range(1, 12)),
                       conf={"osd_recovery_read_timeout": 0.5})
    Z = pg.backend.codec.get_sub_chunk_count()
    chunks = _seed_missing(pg, ["cfb0"])
    osd.responder = _clay_vec_responder(osd, chunks, Z, mute={11})
    t0 = time.monotonic()
    pg.recovery_engine().recover({"cfb0": pg.log.latest_for("cfb0")})
    assert time.monotonic() - t0 < 8.0
    with pg.lock:
        assert not pg.missing, "fallback never landed the object"
    cs, v, _data = chunks["cfb0"]
    g = GHObject("cfb0", shard=0)
    assert osd.store.read(pg.coll, g) == bytes(cs[0])
    assert osd.store.getattr(pg.coll, g, "_av") == _av_stamp(v)
    vecs = [v_ for _o, v_ in osd.sent if isinstance(v_, m.MECSubReadVec)]
    assert any(any(rr for rr in v_.runs) for v_ in vecs)
    assert any(not any(rr for rr in v_.runs) for v_ in vecs)
    # the whole-chunk retry pushes the running ratio past the plan's
    # 344 permille
    assert osd.pg_perf.value("repair_read_frac") > 344


def test_clay_phase_code_on_the_cpu():
    """``chip_smoke.run_clay`` at four 64 KiB objects on the CPU: the
    writes ride encp and every stored shard equals the plain encode, the
    primary's shard 0 comes back through crep at the MSR read fraction,
    the degraded reads and the deep scrub's decodes ride cdec (the run
    raises on any failed check; these pin what it reports)."""
    res = chip_smoke.run_clay(torch, torch.device("cpu"), nobj=4,
                              obj_bytes=64 << 10, stripe_bytes=16 << 10,
                              threads=2)
    st = res["steps"]
    assert set(st) == {"write", "repair", "read", "scrub"}
    assert "encp" in st["write"]["batches"]
    assert "crep" in st["repair"]["batches"]
    assert "cdec" in st["read"]["batches"] and "cdec" in st["scrub"][
        "batches"]
    rep = res["repair"]
    assert 0 < rep["frac_permille"] <= chip_smoke.CLAY_FRAC_MAX
    assert rep["subread_bytes"] == 4 * 11 * rep["L"] * rep["s"]
    assert res["down_shards"] == [1, 11]
    assert res["checked"] == 4 * 12 and res["ragged_products"] == 0


def test_device_warmup_runs_the_clay_kinds():
    """A daemon whose first EC pool is clay warms the queue's clay
    kinds at boot: ``DeviceWarmup._warm_decode`` runs ``repair_planes``
    (one lost shard, d helpers) and ``decode_planes`` (the first m lost)
    at the covering width, and the encode at a whole number of
    sub-chunks (``ceph_tpu/tpu/shapebucket.py:390-404``)."""
    from ceph_tpu_torch.gpu.shapebucket import DeviceWarmup

    codec = ClayCodec(k=4, m=2, device="cpu")
    calls = []
    for name in ("repair_planes", "decode_planes", "encode_planes"):
        real = getattr(codec, name)

        def spy(*a, _real=real, _name=name, **kw):
            calls.append((_name, tuple(a[-1].shape)))
            return _real(*a, **kw)

        setattr(codec, name, spy)
    st = DeviceWarmup(codec, cols=(4096,)).run(-1)
    assert st["done"] and not st["skipped"], st
    Z = codec.get_sub_chunk_count()
    L = len(codec.repair_layers(0))
    assert ("repair_planes", (codec.d, L, 4096 // Z)) in calls
    assert ("decode_planes", (codec.k, 4096)) in calls
    assert ("encode_planes", (codec.k, 4096)) in calls
