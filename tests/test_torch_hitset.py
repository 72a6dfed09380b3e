"""The port's hit sets (``ceph_tpu_torch/osd/hitset.py``), case for case
with ``tests/test_hitset.py``, each set's encoding held byte-equal to
``ceph_tpu.osd.hitset``'s, and the PG case over the port's ``PG`` and
``PGPool``: its archived sets in the PG meta omap are the bytes the
reference PG writes for the same hits."""

import importlib

import numpy as np
import pytest

from ceph_tpu.core.encoding import Decoder as RefDecoder
from ceph_tpu.core.encoding import Encoder as RefEncoder
from ceph_tpu.osd import hitset as ref_hitset
from ceph_tpu_torch.core.encoding import Decoder, Encoder
from ceph_tpu_torch.osd.hitset import (
    BloomHitSet,
    ExplicitHitSet,
    HitSetHistory,
    TierAgent,
    decode_hitset,
)

REF = {BloomHitSet: ref_hitset.BloomHitSet,
       ExplicitHitSet: ref_hitset.ExplicitHitSet}


def _bytes_of(hs, enc=Encoder) -> bytes:
    e = enc()
    hs.encode(e)
    return e.bytes()


def test_bloom_membership_and_fpp():
    hs = BloomHitSet(target_size=2000, fpp=0.01)
    ref = ref_hitset.BloomHitSet(target_size=2000, fpp=0.01)
    members = [f"obj{i}" for i in range(2000)]
    for n in members:
        hs.insert(n)
        ref.insert(n)
    assert all(hs.contains(n) for n in members)
    # false positives on non-members stay near the target fpp
    probes = [f"other{i}" for i in range(4000)]
    fp = int(hs.contains_batch(probes).sum())
    assert fp / len(probes) < 0.05
    assert hs.is_full()
    assert np.array_equal(hs.contains_batch(probes),
                          ref.contains_batch(probes))
    assert _bytes_of(hs) == _bytes_of(ref, RefEncoder)


def test_bloom_batch_matches_scalar():
    hs = BloomHitSet(target_size=100)
    for i in range(0, 100, 2):
        hs.insert(f"o{i}")
    names = [f"o{i}" for i in range(100)]
    batch = hs.contains_batch(names)
    scalar = np.array([hs.contains(n) for n in names])
    assert np.array_equal(batch, scalar)
    assert hs.contains_batch([]).shape == (0,)


@pytest.mark.parametrize("cls", [BloomHitSet, ExplicitHitSet])
def test_hitset_encode_roundtrip(cls):
    hs = cls(target_size=50)
    ref = REF[cls](target_size=50)
    for i in range(30):
        hs.insert(f"x{i}")
        ref.insert(f"x{i}")
    blob = _bytes_of(hs)
    assert blob == _bytes_of(ref, RefEncoder)
    hs2 = decode_hitset(Decoder(blob))
    assert type(hs2) is cls
    assert all(hs2.contains(f"x{i}") for i in range(30))
    assert hs2.inserts == hs.inserts
    # each package reads the other's bytes to the same set
    ref2 = ref_hitset.decode_hitset(RefDecoder(blob))
    assert _bytes_of(ref2, RefEncoder) == _bytes_of(hs2) == blob


def test_history_temperature_and_promote():
    hist = HitSetHistory(count=3)
    ref = ref_hitset.HitSetHistory(count=3)
    for epoch in range(4):  # 4 periods; ring keeps last 3
        hs = ExplicitHitSet()
        rhs = ref_hitset.ExplicitHitSet()
        for i in range(10):
            if i % (epoch + 1) == 0:
                hs.insert(f"o{i}")
                rhs.insert(f"o{i}")
        hist.add(epoch, epoch + 1, hs)
        ref.add(epoch, epoch + 1, rhs)
    assert len(hist.archive) == 3
    assert hist.hit_count("o0") == 3  # hot in every kept set
    names = [f"o{i}" for i in range(10)]
    temps = hist.temperature_batch(names)
    assert temps[0] == 3
    assert np.array_equal(temps, ref.temperature_batch(names))
    agent = TierAgent(hist, min_recency_for_promote=2)
    assert agent.should_promote("o0")
    assert not agent.should_promote("o7")


def test_agent_plan_flush_evict_coldest_first():
    hist = HitSetHistory(count=2)
    hot = ExplicitHitSet()
    hot.insert("hot-dirty")
    hot.insert("hot-clean")
    hist.add(0, 1, hot)
    hist.add(1, 2, hot)
    objects = {  # name -> dirty?
        "hot-dirty": True, "cold-dirty": True,
        "hot-clean": False, "cold-clean": False,
    }
    agent = TierAgent(hist, target_dirty_ratio=0.25,
                      target_full_ratio=0.5)
    flush, evict = agent.plan(objects, used_ratio=0.9, dirty_ratio=0.5,
                              max_ops=1)
    assert flush == ["cold-dirty"]   # coldest dirty flushes first
    assert evict == ["cold-clean"]   # coldest clean evicts first
    # below thresholds: agent idles
    flush, evict = agent.plan(objects, used_ratio=0.1, dirty_ratio=0.1)
    assert flush == [] and evict == []


def _hit_pg(pkg: str, clock):
    """One package's PG over a bare host, 12 hits at target 5, with
    ``time.time`` read from ``clock`` (the archive keys carry it)."""
    ctx_mod = importlib.import_module(f"{pkg}.core.context")
    osdmap = importlib.import_module(f"{pkg}.osd.osdmap")
    pg_mod = importlib.import_module(f"{pkg}.osd.pg")
    memstore = importlib.import_module(f"{pkg}.store.memstore")

    class StubOSD:
        whoami = 0

        def __init__(self):
            self.store = memstore.MemStore()
            self.store.mount()
            self.ctx = ctx_mod.Context("osd.0", {})
            self.log = self.ctx.log

        def epoch(self):
            return 1

        def send_to_osd(self, osd, msg):
            pass

    osd = StubOSD()
    pool = osdmap.PGPool(pool_id=1, hit_set_count=2, hit_set_target_size=5,
                         hit_set_fpp=0.05)
    pg = pg_mod.PG((1, 0), pool, osd)
    pg.create_onstore()
    pg.acting = [0]
    pg.primary = 0
    for i in range(12):  # 12 hits, target 5 -> >=2 rotations
        clock[0] += 0.25
        pg.record_hit(f"obj{i % 6}")
    return pg_mod, pool, osd, pg


def test_pg_records_and_persists_hitsets(monkeypatch):
    """PG-level wiring: hits land in the current set, rotation archives
    into the meta omap, a fresh PG reloads the history; the port's meta
    omap equals the reference PG's under the same clock."""
    import time as _time

    clock = [1_700_000_000.0]
    monkeypatch.setattr(_time, "time", lambda: clock[0])
    omaps = {}
    for pkg in ("ceph_tpu", "ceph_tpu_torch"):
        clock[0] = 1_700_000_000.0
        pg_mod, pool, osd, pg = _hit_pg(pkg, clock)
        assert len(pg.hit_set_history.archive) >= 2
        assert pg.hit_set_history.hit_count("obj0") >= 1
        pg2 = pg_mod.PG((1, 0), pool, osd)
        pg2.load_hit_set_history()
        assert len(pg2.hit_set_history.archive) >= 2
        assert pg2.hit_set_history.hit_count("obj0") >= 1
        gh = importlib.import_module(f"{pkg}.store.objectstore").GHObject
        omaps[pkg] = osd.store.omap_get(pg.coll, gh("_pgmeta_"))
    ref, port = omaps["ceph_tpu"], omaps["ceph_tpu_torch"]
    assert sorted(k for k in port if k.startswith("hitset_")) == \
        sorted(k for k in ref if k.startswith("hitset_"))
    assert port == ref


def test_pool_codec_carries_hit_set_params():
    from ceph_tpu.osd.map_codec import _enc_pool as ref_enc_pool
    from ceph_tpu.osd.osdmap import PGPool as RefPGPool
    from ceph_tpu_torch.osd.map_codec import _dec_pool, _enc_pool
    from ceph_tpu_torch.osd.osdmap import PGPool

    p = PGPool(pool_id=7, hit_set_count=4, hit_set_period=1.5,
               hit_set_target_size=777, hit_set_fpp=0.02)
    e = Encoder()
    _enc_pool(e, p)
    p2 = _dec_pool(Decoder(e.bytes()))
    assert p2.hit_set_count == 4
    assert abs(p2.hit_set_period - 1.5) < 1e-3
    assert p2.hit_set_target_size == 777
    assert abs(p2.hit_set_fpp - 0.02) < 1e-6
    re_ = RefEncoder()
    ref_enc_pool(re_, RefPGPool(pool_id=7, hit_set_count=4,
                                hit_set_period=1.5, hit_set_target_size=777,
                                hit_set_fpp=0.02))
    assert re_.bytes() == e.bytes()
